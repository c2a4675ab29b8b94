"""Lennard-Jones FCC crystal/fluid: the NVE foundation system of the
reference engine (port of constant_ph_tpu/systems/lj.py). It has no
water, so the tiled engine cannot run it.

Positions are the JAX builder's; velocities come from the port's own
``torch.Generator`` (seeded with ``seed``), so they differ from the JAX
builder's.
"""
from __future__ import annotations

import numpy as np
import torch

from constant_ph_tpu_torch import resolve_device
from constant_ph_tpu_torch.forcefield import (
    BondedParams,
    ForceField,
    make_pair_params,
)
from constant_ph_tpu_torch.integrators import maxwell_boltzmann
from constant_ph_tpu_torch.neighbors import make_neighbor_params
from constant_ph_tpu_torch.state import make_state


def _empty_bonded(dtype, dev) -> BondedParams:
    def f():
        return torch.zeros((0,), dtype=dtype, device=dev)

    def i(k):
        return torch.zeros((0, k), dtype=torch.int64, device=dev)

    return BondedParams(
        bond_idx=i(2), bond_k=f(), bond_r0=f(), bond_mask=f(),
        angle_idx=i(3), angle_k=f(), angle_t0=f(), angle_mask=f(),
        dihedral_idx=i(4), dihedral_k=f(), dihedral_n=f(), dihedral_d=f(),
        dihedral_mask=f(), improper_idx=i(4), improper_k=f(),
        improper_x0=f(), improper_mask=f())


def lj_fluid(n_cells: int = 4, *, lattice_const: float = 5.40,
             epsilon: float = 0.238, sigma: float = 3.405,
             mass: float = 39.948, cutoff: float = 8.0, skin: float = 2.0,
             T: float = 120.0, seed: int = 0, dtype=torch.float32,
             device="cuda"):
    """FCC argon-like crystal of 4·n_cells³ atoms (ε kcal/mol, σ Å,
    lattice constant Å, slightly expanded from argon's 5.26) with
    Maxwell–Boltzmann velocities at T: returns (ff, state, nbr_params)."""
    dev = resolve_device(device)
    a = lattice_const
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    cells = np.array([[i, j, k] for i in range(n_cells)
                      for j in range(n_cells) for k in range(n_cells)])
    x = (cells[:, None, :] + base[None, :, :]).reshape(-1, 3) * a
    n = x.shape[0]
    box = np.array([n_cells * a] * 3)

    ff = ForceField(
        mass=torch.full((n,), mass, dtype=dtype, device=dev),
        q0=torch.zeros((n,), dtype=dtype, device=dev),
        type=torch.zeros((n,), dtype=torch.int64, device=dev),
        pair=make_pair_params([epsilon], [sigma], cutoff, dtype=dtype,
                              device=dev),
        bonded=_empty_bonded(dtype, dev),
        excl_idx=np.full((n, 1), -1, dtype=np.int32),
        excl_code=np.zeros((n, 1), dtype=np.int32),
    )
    nbr_params = make_neighbor_params(box, cutoff, n_atoms=n, skin=skin)
    state = make_state(x, box=box, dtype=dtype, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state.v = maxwell_boltzmann(gen, ff.mass, T)
    return ff, state, nbr_params
