"""Run configuration and per-step observables (port of the EngineConfig
and Observables of constant_ph_tpu/engine.py). The reference all-pairs
Engine is not ported yet (the reference-engine slice); the tiled engine
is tiled/engine.TiledEngine."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static run configuration."""

    dt: float = 1.0                  # fs
    T: float = 300.0                 # K
    thermostat: str = "langevin"     # "langevin" | "nhc" | "nve"
    gamma: float = 0.001             # 1/fs
    tau: float = 100.0               # fs (NHC)
    lambda_nevery: int = 1
    lambda_thermostat: str = "langevin"   # "langevin" | "nhc" | "none"
    lambda_gamma: float = 0.005
    lambda_tau: float = 200.0
    # λ-RESPA: lambda_inner // 2 velocity-Verlet substeps of λ against
    # the analytic stiff force per half drift; 1 = single-rate drift
    lambda_inner: int = 8
    rebuild_every: int = 20
    # k-space impulse MTS (Verlet-I / r-RESPA outer level): the reciprocal
    # term is evaluated every kspace_every steps and applied ×kspace_every
    # in the two half-kicks around the evaluation; λ forces in between use
    # the last reciprocal φ (tiled/engine.py)
    kspace_every: int = 1
    # per-atom force-norm cap in kcal/mol/Å (0 = off)
    force_cap: float = 0.0
    # reflective λ backstop walls (folding reflection, tiled/engine.py)
    lam_min: float = -0.5
    lam_max: float = 1.5
    lambda_frozen: bool = False
    # derive the PME influence function, spacing and volume from the live
    # state box at each k-space evaluation (ops/pme.pme_influence) instead
    # of the box baked into the PME params (NPT)
    kspace_live_box: bool = False
    # seed of the engine's torch.Generator (thermostat noise); the JAX
    # package keeps a PRNG key in its state instead
    seed: int = 0

    def __post_init__(self):
        # the JAX engine silently rounds an odd lambda_inner down
        # (m = lambda_inner // 2); the port refuses it
        if self.lambda_inner > 1 and self.lambda_inner % 2:
            raise ValueError(
                f"lambda_inner must be 1 or even, got {self.lambda_inner}: "
                "each half drift runs lambda_inner // 2 substeps")


@dataclasses.dataclass
class Observables:
    """Per-step observables: energies, temperatures, λ state and the
    conserved quantity h_conserved = E_tot − ext_work."""

    e_pot: torch.Tensor
    e_lj: torch.Tensor
    e_coul: torch.Tensor
    e_bonded: torch.Tensor
    e_kspace: torch.Tensor
    e_site: torch.Tensor
    ke: torch.Tensor
    temp: torch.Tensor
    ke_lam: torch.Tensor
    temp_lam: torch.Tensor
    h_conserved: torch.Tensor
    h_valid: torch.Tensor
    ext_work: torch.Tensor
    lam: torch.Tensor        # (S,)
    v_lam: torch.Tensor      # (S,)
    dUdlam: torch.Tensor     # (S,)

    @staticmethod
    def stack(rows: list) -> "Observables":
        """Stack per-step rows into one Observables with a leading step
        axis (device tensors; nothing is copied to the host)."""
        return Observables(**{
            f.name: torch.stack([getattr(r, f.name) for r in rows])
            for f in dataclasses.fields(Observables)})
