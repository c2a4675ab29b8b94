"""SystemState: the canonical (N, 3) atom store, as a dataclass of tensors.

Unlike the JAX package's state it carries no PRNG key: random numbers come
from the engine's own ``torch.Generator`` (engine.py, tiled/engine.py). It
carries a host copy of the step counter instead, so step-dependent choices
never wait for the device.
"""
from __future__ import annotations

import dataclasses

import torch

from constant_ph_tpu_torch import resolve_device
from constant_ph_tpu_torch.batching import PerReplica


@dataclasses.dataclass
class SystemState(PerReplica):
    """Dynamic state of the simulation (one replica's shapes)."""

    _probe = ("x", 2)

    x: torch.Tensor          # (N, 3) positions, Å
    v: torch.Tensor          # (N, 3) velocities, Å/fs
    box: torch.Tensor        # (3,) orthorhombic box lengths, Å
    lam: torch.Tensor        # (S,) per-site λ
    v_lam: torch.Tensor      # (S,) λ velocities
    step: torch.Tensor       # () int32 timestep
    pH: torch.Tensor         # () imposed pH
    nhc_xi: torch.Tensor     # (M,) atom-thermostat chain velocities
    nhc_lam_xi: torch.Tensor  # (M,) λ-thermostat chain velocities
    # () cumulative non-Hamiltonian energy injected by thermostats;
    # h_conserved subtracts it (engine.Observables)
    ext_work: torch.Tensor
    # host copy of `step`, advanced with it (the λ kick schedule of
    # lambda_nevery reads it)
    step_host: int = 0


def make_state(x, v=None, box=None, lam=None, v_lam=None, pH: float = 7.0,
               nhc_len: int = 3, dtype=torch.float32,
               device="cuda") -> SystemState:
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    x = t(x)
    lam = t(lam if lam is not None else [])
    return SystemState(
        x=x,
        v=torch.zeros_like(x) if v is None else t(v),
        box=t(box),
        lam=lam,
        v_lam=torch.zeros_like(lam) if v_lam is None else t(v_lam),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        pH=t(pH),
        nhc_xi=torch.zeros((nhc_len,), dtype=dtype, device=dev),
        nhc_lam_xi=torch.zeros((nhc_len,), dtype=dtype, device=dev),
        ext_work=torch.zeros((), dtype=dtype, device=dev),
    )


def min_image(dx, box):
    """Minimum-image displacement for an orthorhombic box."""
    return dx - box * torch.round(dx / box)


def wrap(x, box):
    """Wrap positions into [0, box)."""
    return x - box * torch.floor(x / box)
