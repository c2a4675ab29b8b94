"""Pieces shared by the frozen builders: force-field tables, exclusions,
λ-site tables and the state, all as numpy dicts in the layout that
``constant_ph_tpu_torch.convert.system`` reads.

These are copies, frozen with the benchmark, of what the port's builders
do (systems/water.py, systems/protein.py, forcefield.py): a later change to
the port's builders does not move the systems this benchmark runs. Every
array is made on the host from ``numpy.random.default_rng`` seeded by the
run's ``--seed``, so one seed gives one system; the plain reference
(cph_bench/reference) reads the same dicts.
"""
from __future__ import annotations

import math

import numpy as np

# SPC/E water
Q_O, Q_H = -0.8476, 0.4238
EPS_O, SIG_O = 0.15535, 3.166
R_OH = 1.0
THETA_HOH = np.deg2rad(109.47)
R_HH = 2.0 * R_OH * np.sin(THETA_HOH / 2.0)
M_O, M_H, M_C = 15.9994, 1.008, 12.011

# the model carboxylic acid (C, O1, O2, titratable H): protonated and
# deprotonated charge sets, LJ and masses
ACID_Q_PROT = np.array([0.53, -0.44, -0.53, 0.44])
ACID_Q_DEPROT = np.array([0.34, -0.67, -0.67, 0.00])
ACID_EPS = np.array([0.086, 0.21, 0.21, 0.0])
ACID_SIG = np.array([3.40, 2.96, 3.00, 1.0])
ACID_MASS = np.array([M_C, 15.9994, 15.9994, M_H])

# special-bond scale factors by neighbour code (0 normal, 1-2, 1-3, 1-4)
SPECIAL_LJ = (1.0, 0.0, 0.0, 0.5)
SPECIAL_COUL = (1.0, 0.0, 0.0, 0.8333)

BOLTZ = 0.0019872067
MVV2E = 1.0e7 / 4184.0


def water_geometry():
    """One water in its local frame: O at the origin, H's in the xy
    plane."""
    h1 = np.array([R_OH, 0.0, 0.0])
    c, s = np.cos(THETA_HOH), np.sin(THETA_HOH)
    return np.stack([np.zeros(3), h1, np.array([R_OH * c, R_OH * s, 0.0])])


def acid_geometry():
    return np.array([[0.00, 0.00, 0.00], [1.25, 0.00, 0.00],
                     [-0.62, 1.10, 0.00], [-0.12, 1.95, 0.00]])


def random_rotations(n, rng):
    """Uniform random rotation matrices from unit quaternions."""
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1),
    ], axis=1)


def pair_params(eps, sig, cutoff, alpha, coul_style):
    """Lorentz–Berthelot LJ tables, shifted to zero at the cutoff."""
    eps = np.asarray(eps, np.float64)
    sig = np.asarray(sig, np.float64)
    eps_ij = np.sqrt(eps[:, None] * eps[None, :])
    sig_ij = 0.5 * (sig[:, None] + sig[None, :])
    c12 = 4.0 * eps_ij * sig_ij**12
    c6 = 4.0 * eps_ij * sig_ij**6
    return dict(c12=c12, c6=c6, e_shift=c12 / cutoff**12 - c6 / cutoff**6,
                cutoff=float(cutoff), coul_cutoff=float(cutoff),
                alpha=float(alpha), coul_style=coul_style,
                special_lj=np.array(SPECIAL_LJ),
                special_coul=np.array(SPECIAL_COUL))


def exclusions(n_atoms, bonds, max_excl):
    """1-2 / 1-3 / 1-4 partners of every atom from the bond graph, sorted
    by id within each code: (excl_idx, excl_code), −1 / 0 padded."""
    bonds = np.asarray(bonds, np.int64).reshape(-1, 2)
    adj = [[] for _ in range(n_atoms)]
    for i, j in bonds:
        adj[i].append(int(j))
        adj[j].append(int(i))
    idx = np.full((n_atoms, max_excl), -1, np.int32)
    code = np.zeros((n_atoms, max_excl), np.int32)
    for i in range(n_atoms):
        if not adj[i]:
            continue
        one2 = set(adj[i])
        one3 = set()
        for j in one2:
            one3.update(adj[j])
        one3 -= one2 | {i}
        one4 = set()
        for k in one3:
            one4.update(adj[k])
        one4 -= one2 | one3 | {i}
        rows = ([(j, 1) for j in sorted(one2)] + [(j, 2) for j in sorted(one3)]
                + [(j, 3) for j in sorted(one4)])
        if len(rows) > max_excl:
            raise ValueError(f"atom {i} has {len(rows)} special partners, "
                             f"more than {max_excl}")
        for s, (j, c) in enumerate(rows):
            idx[i, s], code[i, s] = j, c
    return idx, code


def neighbor_params(box, cutoff, n_atoms, skin, safety=1.35):
    """The reference engine's list sizing (unused by the tiled engine,
    which takes its own skin; carried because a System holds it)."""
    box = np.asarray(box, np.float64)
    rc = cutoff + skin
    density = n_atoms / float(np.prod(box))
    grid = tuple(int(max(1, np.floor(b / rc))) for b in box)
    cell = box / np.array(grid)
    reach = tuple(int(np.ceil(rc / c)) if g > 1 else 0
                  for c, g in zip(cell, grid))
    stencil = tuple((a, b, c) for a in range(-reach[0], reach[0] + 1)
                    for b in range(-reach[1], reach[1] + 1)
                    for c in range(-reach[2], reach[2] + 1))
    cap_cell = int(np.ceil(density * float(np.prod(cell)) * (safety + 0.35)))
    cap_cell = max(8, -(-(cap_cell + 4) // 8) * 8)
    cap = int(np.ceil(density * 4.0 / 3.0 * np.pi * rc**3 * safety)) + 8
    mult = 128 if cap > 128 else 8
    return dict(cutoff=rc, skin=float(skin),
                capacity=min(-(-cap // mult) * mult, n_atoms), grid=grid,
                cell_capacity=cap_cell, stencil=stencil,
                use_cells=n_atoms > 512)


def site(atom_idx, pK, buffer_idx, dq_scale=1.0, m_lambda=20.0, dG_ref=0.0):
    """One titratable site: the acid's Δq, and −ΣΔq shared equally by the
    buffer atoms so that the site stays neutral."""
    dq = (ACID_Q_DEPROT - ACID_Q_PROT) * dq_scale
    buffer_idx = np.asarray(buffer_idx, np.int64)
    comp = -dq.sum() / len(buffer_idx)
    return dict(atom_idx=np.concatenate([np.asarray(atom_idx, np.int64),
                                         buffer_idx]),
                dq=np.concatenate([dq, np.full(len(buffer_idx), comp)]),
                pK=float(pK), m_lambda=float(m_lambda), dG_ref=float(dG_ref))


def spec(sites):
    """The (S, P) site table; pads get atom 0 and mask 0."""
    P = max(len(s["atom_idx"]) for s in sites)
    S = len(sites)
    out = dict(pK=np.array([s["pK"] for s in sites]),
               dG_ref=np.array([s["dG_ref"] for s in sites]),
               m_lambda=np.array([s["m_lambda"] for s in sites]),
               atom_idx=np.zeros((S, P), np.int64), dq=np.zeros((S, P)),
               atom_mask=np.zeros((S, P)))
    for k, s in enumerate(sites):
        n = len(s["atom_idx"])
        out["atom_idx"][k, :n] = s["atom_idx"]
        out["dq"][k, :n] = s["dq"]
        out["atom_mask"][k, :n] = 1.0
    return out


def velocities(rng, mass, T):
    """Maxwell–Boltzmann velocities (Å/fs) with zero total momentum."""
    sigma = np.sqrt(BOLTZ * T / (mass * MVV2E))[:, None]
    v = sigma * rng.normal(size=(len(mass), 3))
    return v - (mass[:, None] * v).sum(0) / mass.sum()


def bonded(bonds=(), angles=(), dihedrals=()):
    """Harmonic bonds (i, j, k, r0) and angles (i, j, k, k, θ0), CHARMM
    dihedrals (i, j, k, l, k, n, δ); no impropers."""
    def rows(terms, n_idx, n_par):
        a = np.asarray(terms, np.float64).reshape(-1, n_idx + n_par)
        return a[:, :n_idx].astype(np.int64), a[:, n_idx:]

    b_i, b_p = rows(bonds, 2, 2)
    a_i, a_p = rows(angles, 3, 2)
    d_i, d_p = rows(dihedrals, 4, 3)
    return dict(bond_idx=b_i, bond_k=b_p[:, 0], bond_r0=b_p[:, 1],
                bond_mask=np.ones(len(b_i)),
                angle_idx=a_i, angle_k=a_p[:, 0], angle_t0=a_p[:, 1],
                angle_mask=np.ones(len(a_i)),
                dihedral_idx=d_i, dihedral_k=d_p[:, 0], dihedral_n=d_p[:, 1],
                dihedral_d=d_p[:, 2], dihedral_mask=np.ones(len(d_i)),
                improper_idx=np.zeros((0, 4), np.int64),
                improper_k=np.zeros(0), improper_x0=np.zeros(0),
                improper_mask=np.zeros(0))


def system_dict(*, x, v, box, lam, pH, mass, q0, types, pair, bonded_d,
                excl, triplets, site_table, groupH, skin):
    """The dict that convert.system reads."""
    n = len(x)
    state = dict(x=x, v=v, box=np.asarray(box, np.float64),
                 lam=np.asarray(lam, np.float64),
                 v_lam=np.zeros(len(lam)), step=np.zeros((), np.int32),
                 pH=np.float64(pH), nhc_xi=np.zeros(3),
                 nhc_lam_xi=np.zeros(3), ext_work=np.float64(0.0))
    mh = np.asarray(mass, np.float64)
    return dict(
        ff=dict(mass=mh, q0=np.asarray(q0, np.float64),
                type=np.asarray(types, np.int64), pair=pair,
                bonded=bonded_d, excl_idx=excl[0], excl_code=excl[1]),
        state=state,
        nbr_params=neighbor_params(box, pair["cutoff"], n, skin),
        bonded=bonded_d,
        constraints=dict(triplets=np.asarray(triplets, np.int64), masses=mh,
                         d01=R_OH, d12=float(R_HH)),
        spec=site_table, groupH_mask=groupH)


def n_buffer_permutation(seed, n_wat):
    """The seeded permutation that picks buffer waters."""
    return np.random.default_rng(seed + 1).permutation(n_wat)


def ewald_intra(alpha, q_o=Q_O, q_h=Q_H, d_oh=R_OH, d_hh=R_HH):
    """Σ q_i q_j erf(α r)/r over the three pairs of one rigid water (e²/Å)."""
    return (2.0 * q_o * q_h * math.erf(alpha * d_oh) / d_oh
            + q_h * q_h * math.erf(alpha * d_hh) / d_hh)
