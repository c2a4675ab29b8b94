"""SPC/E water boxes and a solvated model titratable acid (port of
constant_ph_tpu/systems/water.py).

Positions come from ``np.random.default_rng(seed)`` on the host in float64,
exactly as in the JAX builder, so both packages place every atom at the
same float32 coordinates. Velocities come from the port's own
``torch.Generator`` (seed + 1), so they differ from the JAX builder's.
"""
from __future__ import annotations

import numpy as np
import torch

from constant_ph_tpu_torch import resolve_device
from constant_ph_tpu_torch.forcefield import (
    BondedParams,
    ForceField,
    build_exclusions,
    make_pair_params,
)
from constant_ph_tpu_torch.integrators import maxwell_boltzmann
from constant_ph_tpu_torch.lambda_dyn import make_single_site
from constant_ph_tpu_torch.neighbors import make_neighbor_params
from constant_ph_tpu_torch.ops.constraints import RigidTriatomic
from constant_ph_tpu_torch.state import make_state
from constant_ph_tpu_torch.systems.base import System

# SPC/E parameters
Q_O, Q_H = -0.8476, 0.4238
EPS_O, SIG_O = 0.15535, 3.166      # kcal/mol, Å
R_OH = 1.0
THETA_HOH = np.deg2rad(109.47)
R_HH = 2.0 * R_OH * np.sin(THETA_HOH / 2.0)
M_O, M_H, M_C = 15.9994, 1.008, 12.011

# flexible-water spring constants (SPC/Fw-style, E = k (r-r0)^2)
KB_OH, KA_HOH = 529.581, 37.95


def _water_geometry():
    """One water in its local frame: O at origin, H's in the xy plane."""
    h1 = np.array([R_OH, 0.0, 0.0])
    c, s = np.cos(THETA_HOH), np.sin(THETA_HOH)
    h2 = np.array([R_OH * c, R_OH * s, 0.0])
    return np.stack([np.zeros(3), h1, h2])


def _random_rotations(n, rng):
    """Uniform random rotation matrices (host-side numpy)."""
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], axis=1)


def _acid_geometry():
    """Model carboxylic acid (GLU-like headgroup): C, O1, O2, H(titratable)."""
    return np.array([
        [0.00, 0.00, 0.00],    # C
        [1.25, 0.00, 0.00],    # O1 (carbonyl)
        [-0.62, 1.10, 0.00],   # O2 (hydroxyl O)
        [-0.12, 1.95, 0.00],   # H (titratable)
    ])


# protonated / deprotonated charge sets for the model acid (net 0 → −1)
ACID_Q_PROT = np.array([0.53, -0.44, -0.53, 0.44])
ACID_Q_DEPROT = np.array([0.34, -0.67, -0.67, 0.00])
ACID_EPS = np.array([0.086, 0.21, 0.21, 0.0])    # C, O, O, H LJ ε
ACID_SIG = np.array([3.40, 2.96, 3.00, 1.0])     # σ (H has none)
ACID_MASS = np.array([M_C, 15.9994, 15.9994, M_H])


def solvated_acid(
    n_side: int = 6,
    *,
    spacing: float = 3.2,
    pK: float = 4.25,
    pH: float = 7.0,
    T: float = 300.0,
    dG_ref: float = 0.0,
    rigid_water: bool = True,
    lambda_coupled: bool = True,
    cutoff: float = 9.0,
    skin: float = 2.0,
    alpha: float = 0.0,
    coul_style: str = "cut",
    hmr: float = 1.0,
    n_buffer_waters: int = 1,
    seed: int = 0,
    dtype=torch.float32,
    device="cuda",
) -> System:
    """A model titratable acid in a box of SPC/E water.

    Layout: acid atoms [0..3], then waters; water 0 (atoms 4..6) is the
    charge-compensation buffer. One lattice site is left empty for the
    acid. ``lambda_coupled`` scales the site's Δq (0 = uncoupled).
    ``skin`` sizes the reference engine's neighbour list (nbr_params); the
    tiles take their own skin in split_system."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_wat = n_side**3 - 1
    box_len = n_side * spacing
    box = np.array([box_len] * 3)

    # waters on a jittered lattice with random orientations
    sites = np.array([[i, j, k] for i in range(n_side)
                      for j in range(n_side) for k in range(n_side)],
                     dtype=np.float64)
    sites = (sites + 0.5) * spacing
    acid_site = sites[0]
    wat_sites = sites[1:]
    geo = _water_geometry() - _water_geometry().mean(axis=0)
    rots = _random_rotations(n_wat, rng)
    wat_x = wat_sites[:, None, :] + np.einsum("mij,aj->mai", rots, geo)
    # jitter per MOLECULE (rigid-body translation keeps the constraints)
    wat_x += rng.normal(scale=0.05, size=(n_wat, 1, 3))

    acid_x = _acid_geometry() - _acid_geometry().mean(axis=0) + acid_site

    x = np.concatenate([acid_x, wat_x.reshape(-1, 3)], axis=0)
    n = x.shape[0]
    n_acid = 4

    # types: 0=C, 1=O_carb, 2=O_hydroxyl, 3=H_acid, 4=O_wat, 5=H_wat
    types = np.concatenate([
        np.array([0, 1, 2, 3]),
        np.tile(np.array([4, 5, 5]), n_wat),
    ]).astype(np.int64)
    eps = np.concatenate([ACID_EPS, [EPS_O, 0.0]])
    sig = np.concatenate([ACID_SIG, [SIG_O, 1.0]])
    acid_mass = ACID_MASS.copy()
    if hmr > 1.0:
        # hydrogen-mass repartitioning on the solute O-H (total mass kept)
        dm = (hmr - 1.0) * acid_mass[3]
        acid_mass[3] += dm
        acid_mass[2] -= dm
    mass = np.concatenate([acid_mass, np.tile([M_O, M_H, M_H], n_wat)])
    q0 = np.concatenate([ACID_Q_PROT, np.tile([Q_O, Q_H, Q_H], n_wat)])

    acid_bonds = np.array([[0, 1], [0, 2], [2, 3]])
    wat_o = n_acid + 3 * np.arange(n_wat)
    wat_bonds = np.stack(
        [np.stack([wat_o, wat_o + 1], -1), np.stack([wat_o, wat_o + 2], -1)],
        axis=1,
    ).reshape(-1, 2)
    all_bonds = np.concatenate([acid_bonds, wat_bonds])
    excl_idx, excl_code = build_exclusions(n, np.concatenate(
        [all_bonds, np.stack([wat_o + 1, wat_o + 2], -1)]), max_excl=8)

    # bonded terms (always for the acid; waters only if flexible)
    if rigid_water:
        b_idx, b_k, b_r0 = acid_bonds, [570.0, 450.0, 553.0], [1.25, 1.25, 0.97]
        a_idx = np.array([[1, 0, 2], [0, 2, 3]])
        a_k, a_t0 = [80.0, 55.0], [np.deg2rad(126.0), np.deg2rad(113.0)]
    else:
        b_idx = np.concatenate([acid_bonds, wat_bonds])
        b_k = [570.0, 450.0, 553.0] + [KB_OH] * (2 * n_wat)
        b_r0 = [1.25, 1.25, 0.97] + [R_OH] * (2 * n_wat)
        wat_angles = np.stack([wat_o + 1, wat_o, wat_o + 2], -1)
        a_idx = np.concatenate([np.array([[1, 0, 2], [0, 2, 3]]), wat_angles])
        a_k = [80.0, 55.0] + [KA_HOH] * n_wat
        a_t0 = [np.deg2rad(126.0), np.deg2rad(113.0)] + [THETA_HOH] * n_wat

    def f(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                               device=dev)

    def i(a, k):
        return torch.as_tensor(np.asarray(a, dtype=np.int64).reshape(-1, k),
                               device=dev)

    nb, na = len(b_idx), len(a_idx)
    bonded = BondedParams(
        bond_idx=i(b_idx, 2), bond_k=f(b_k), bond_r0=f(b_r0),
        bond_mask=f(np.ones(nb)),
        angle_idx=i(a_idx, 3), angle_k=f(a_k), angle_t0=f(a_t0),
        angle_mask=f(np.ones(na)),
        dihedral_idx=i(np.zeros((0, 4)), 4), dihedral_k=f([]),
        dihedral_n=f([]), dihedral_d=f([]), dihedral_mask=f([]),
        improper_idx=i(np.zeros((0, 4)), 4), improper_k=f([]),
        improper_x0=f([]), improper_mask=f([]),
    )

    ff = ForceField(
        mass=f(mass), q0=f(q0), type=torch.as_tensor(types, device=dev),
        pair=make_pair_params(
            eps, sig, cutoff, alpha=alpha, coul_style=coul_style,
            special_lj=(1.0, 0.0, 0.0, 0.5),
            special_coul=(1.0, 0.0, 0.0, 0.8333),
            dtype=dtype, device=dev,
        ),
        bonded=bonded, excl_idx=excl_idx, excl_code=excl_code,
    )

    # λ site: acid atoms + buffer water(s); one buffer carries the full
    # compensating +1e, N > 1 spread it +1/(3N) per atom over N waters
    dq_scale = float(lambda_coupled)
    if n_buffer_waters > n_wat:
        raise ValueError(
            f"need {n_buffer_waters} buffer waters, only {n_wat} available")
    if n_buffer_waters == 1:
        bufs = np.array([0])
    else:
        bufs = np.sort(
            np.random.default_rng(seed + 1).permutation(n_wat)
            [:n_buffer_waters])
    buf_o = n_acid + 3 * bufs
    spec = make_single_site(
        atom_idx=[0, 1, 2, 3],
        q_prot=ACID_Q_PROT,
        q_deprot=(ACID_Q_PROT + (ACID_Q_DEPROT - ACID_Q_PROT) * dq_scale),
        pK=pK,
        buffer_idx=np.stack([buf_o, buf_o + 1, buf_o + 2], -1).reshape(-1),
        dG_ref=dG_ref, dtype=dtype, device=dev,
    )

    constraints = None
    if rigid_water:
        trip = np.stack([wat_o, wat_o + 1, wat_o + 2], axis=-1)
        constraints = RigidTriatomic(trip, mass, R_OH, R_HH, dtype=dtype,
                                     device=dev)

    state = make_state(x, box=box, lam=[0.5], pH=pH, dtype=dtype, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    state.v = maxwell_boltzmann(gen, ff.mass, T)

    groupH_mask = torch.zeros((n,), dtype=torch.bool, device=dev)
    groupH_mask[3] = True
    return System(ff=ff, state=state,
                  nbr_params=make_neighbor_params(box, cutoff, n_atoms=n,
                                                  skin=skin),
                  bonded=bonded,
                  constraints=constraints, spec=spec,
                  groupH_mask=groupH_mask)


def water_box(n_side: int = 6, *, rigid: bool = True, T: float = 300.0,
              cutoff: float = 9.0, seed: int = 0, **kw) -> System:
    """Pure SPC/E water box (the acid's charges are left uncoupled)."""
    return solvated_acid(n_side=n_side, rigid_water=rigid, T=T,
                         cutoff=cutoff, seed=seed, lambda_coupled=False, **kw)
