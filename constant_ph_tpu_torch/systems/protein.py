"""Synthetic solvated polypeptide with many titratable sites (port of
constant_ph_tpu/systems/protein.py).

A coarse backbone chain (bonds, angles, dihedrals) carrying carboxylate
headgroups (C, O1, O2, titratable H; the model chemistry of
systems.water.solvated_acid), solvated in SPC/E water, with
``n_buffer_waters`` charge-compensation buffer waters per site drawn from a
seeded permutation. Positions, types, charges, bonded terms, exclusions,
the site table and the buffer waters come from
``np.random.default_rng(seed)`` and ``seed + 1`` on the host in float64,
exactly as in the JAX package, so both packages build the same system;
velocities come from the port's own ``torch.Generator`` (seed + 1).
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
from constant_ph_tpu_torch.lambda_dyn import make_single_site, stack_sites
from constant_ph_tpu_torch.neighbors import make_neighbor_params
from constant_ph_tpu_torch.ops.constraints import RigidTriatomic
from constant_ph_tpu_torch.state import make_state
from constant_ph_tpu_torch.systems.base import System
from constant_ph_tpu_torch.systems.water import (
    ACID_EPS,
    ACID_MASS,
    ACID_Q_DEPROT,
    ACID_Q_PROT,
    ACID_SIG,
    EPS_O,
    M_H,
    M_O,
    Q_H,
    Q_O,
    R_HH,
    R_OH,
    SIG_O,
    _acid_geometry,
    _random_rotations,
    _water_geometry,
)


def solvated_polypeptide(
    n_residues: int = 32,
    sites_every: int = 2,
    box_len: float = 62.0,
    *,
    water_spacing: float = 3.15,
    pKs=(4.25, 3.65, 6.5),
    pH: float = 7.0,
    T: float = 300.0,
    dq_scale: float = 1.0,
    n_buffer_waters: int = 1,
    cutoff: float = 9.0,
    skin: float = 2.0,
    alpha: float = 0.0,
    coul_style: str = "dsf",
    seed: int = 0,
    dtype=torch.float32,
    device="cuda",
) -> System:
    """The multi-site solvated system: n_residues // sites_every λ sites
    with pK cycling through ``pKs``. ``skin`` sizes the reference
    engine's neighbour list (nbr_params); the tiles take their own skin in
    split_system."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    # backbone: a loose helix through the box centre
    t = np.arange(n_residues) * 0.6
    radius = 6.5
    bb = np.stack([radius * np.cos(t), radius * np.sin(t), 1.9 * t],
                  axis=-1)
    bb += box_len / 2 - bb.mean(axis=0)

    atoms_x, atoms_t, atoms_q, atoms_m = [], [], [], []
    bonds, angles, dihedrals = [], [], []
    # types: 0 CA, 1 C(acid), 2 O1, 3 O2, 4 H(acid), 5 O(wat), 6 H(wat)
    CA, AC, AO1, AO2, AH, WO, WH = range(7)

    def add_atom(x, ty, q, m):
        atoms_x.append(x)
        atoms_t.append(ty)
        atoms_q.append(q)
        atoms_m.append(m)
        return len(atoms_x) - 1

    ca_ids = []
    site_atoms = []   # (C, O1, O2, H) per titratable residue
    for r in range(n_residues):
        ca = add_atom(bb[r], CA, 0.0, 12.011)
        ca_ids.append(ca)
        if r > 0:
            bonds.append((ca_ids[r - 1], ca, 250.0, 3.80))
        if r > 1:
            angles.append((ca_ids[r - 2], ca_ids[r - 1], ca, 40.0,
                           np.deg2rad(110.0)))
        if r > 2:
            dihedrals.append((ca_ids[r - 3], ca_ids[r - 2],
                              ca_ids[r - 1], ca, 0.6, 3.0, 0.0))
        if r % sites_every == 0:
            # a carboxylate headgroup, displaced radially outward
            outward = bb[r] - [box_len / 2, box_len / 2, bb[r][2]]
            outward[2] = 0.0
            outward /= max(np.linalg.norm(outward), 1e-6)
            geo = _acid_geometry() - _acid_geometry()[0]
            base = bb[r] + outward * 2.6
            ids = [add_atom(base + geo[a], (AC, AO1, AO2, AH)[a],
                            ACID_Q_PROT[a], ACID_MASS[a]) for a in range(4)]
            bonds.append((ca, ids[0], 200.0, 2.6))
            bonds.append((ids[0], ids[1], 570.0, 1.25))
            bonds.append((ids[0], ids[2], 450.0, 1.25))
            bonds.append((ids[2], ids[3], 553.0, 0.97))
            angles.append((ids[1], ids[0], ids[2], 80.0, np.deg2rad(126.0)))
            angles.append((ids[0], ids[2], ids[3], 55.0, np.deg2rad(113.0)))
            angles.append((ca, ids[0], ids[1], 45.0, np.deg2rad(120.0)))
            site_atoms.append(ids)

    n_prot = len(atoms_x)
    prot_x = np.array(atoms_x)

    # solvate: water lattice, lattice sites overlapping the protein dropped
    n_side = int(np.floor(box_len / water_spacing))
    spacing = box_len / n_side
    sites = (np.array(
        [[i, j, k] for i in range(n_side) for j in range(n_side)
         for k in range(n_side)], dtype=np.float64) + 0.5) * spacing
    d2 = ((sites[:, None, :] - prot_x[None, :, :]) ** 2).sum(-1).min(axis=1)
    sites = sites[d2 > 3.0**2]
    n_wat = sites.shape[0]
    geo = _water_geometry() - _water_geometry().mean(axis=0)
    rots = _random_rotations(n_wat, rng)
    wat_x = sites[:, None, :] + np.einsum("mij,aj->mai", rots, geo)
    wat_x += rng.normal(scale=0.04, size=(n_wat, 1, 3))

    x = np.concatenate([prot_x, wat_x.reshape(-1, 3)])
    n = x.shape[0]
    wat_o = n_prot + 3 * np.arange(n_wat)

    types = np.concatenate([np.array(atoms_t),
                            np.tile([WO, WH, WH], n_wat)]).astype(np.int64)
    q0 = np.concatenate([np.array(atoms_q), np.tile([Q_O, Q_H, Q_H], n_wat)])
    mass = np.concatenate([np.array(atoms_m),
                           np.tile([M_O, M_H, M_H], n_wat)])
    eps = np.array([0.10, ACID_EPS[0], ACID_EPS[1], ACID_EPS[2], 0.0,
                    EPS_O, 0.0])
    sig = np.array([3.50, ACID_SIG[0], ACID_SIG[1], ACID_SIG[2], 1.0,
                    SIG_O, 1.0])

    def f(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                               device=dev)

    def i(a, k):
        return torch.as_tensor(np.asarray(a, dtype=np.int64).reshape(-1, k),
                               device=dev)

    b_idx = np.array([b[:2] for b in bonds], dtype=np.int64)
    wat_bonds = np.concatenate([
        np.stack([wat_o, wat_o + 1], -1),
        np.stack([wat_o, wat_o + 2], -1),
        np.stack([wat_o + 1, wat_o + 2], -1),
    ])
    excl_idx, excl_code = build_exclusions(
        n, np.concatenate([b_idx, wat_bonds]), max_excl=24)

    bonded = BondedParams(
        bond_idx=i(b_idx, 2), bond_k=f([b[2] for b in bonds]),
        bond_r0=f([b[3] for b in bonds]), bond_mask=f(np.ones(len(bonds))),
        angle_idx=i([a[:3] for a in angles], 3),
        angle_k=f([a[3] for a in angles]),
        angle_t0=f([a[4] for a in angles]),
        angle_mask=f(np.ones(len(angles))),
        dihedral_idx=i([d[:4] for d in dihedrals], 4),
        dihedral_k=f([d[4] for d in dihedrals]),
        dihedral_n=f([d[5] for d in dihedrals]),
        dihedral_d=f([d[6] for d in dihedrals]),
        dihedral_mask=f(np.ones(len(dihedrals))),
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

    # multi-site λ table: the compensating +1e of each site is spread over
    # n_buffer_waters scattered waters (+1/(3·n_buf) per atom; the buffer
    # side of the Marcus barrier scales as 1/n_buf); sites' buffer sets
    # are disjoint slices of one seeded permutation
    n_sites_tot = len(site_atoms)
    if n_sites_tot * n_buffer_waters > n_wat:
        raise ValueError(
            f"need {n_sites_tot * n_buffer_waters} buffer waters, "
            f"only {n_wat} available")
    perm = np.random.default_rng(seed + 1).permutation(n_wat)
    specs = []
    for s, ids in enumerate(site_atoms):
        bufs = wat_o[perm[s::n_sites_tot][:n_buffer_waters]]
        specs.append(make_single_site(
            atom_idx=ids,
            q_prot=ACID_Q_PROT,
            q_deprot=ACID_Q_PROT + (ACID_Q_DEPROT - ACID_Q_PROT) * dq_scale,
            pK=pKs[s % len(pKs)],
            buffer_idx=np.stack([bufs, bufs + 1, bufs + 2], -1).reshape(-1),
            dtype=dtype, device=dev,
        ))
    spec = stack_sites(specs)

    trip = np.stack([wat_o, wat_o + 1, wat_o + 2], axis=-1)
    constraints = RigidTriatomic(trip, mass, R_OH, R_HH, dtype=dtype,
                                 device=dev)

    state = make_state(x, box=[box_len] * 3,
                       lam=np.full(len(site_atoms), 0.2), pH=pH,
                       dtype=dtype, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    state.v = maxwell_boltzmann(gen, ff.mass, T)

    groupH_mask = torch.zeros((n,), dtype=torch.bool, device=dev)
    groupH_mask[[ids[3] for ids in site_atoms]] = True
    return System(ff=ff, state=state,
                  nbr_params=make_neighbor_params([box_len] * 3, cutoff,
                                                  n_atoms=n, skin=skin),
                  bonded=bonded,
                  constraints=constraints, spec=spec,
                  groupH_mask=groupH_mask)
