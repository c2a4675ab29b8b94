"""A synthetic solvated polypeptide with many titratable carboxylate
sites: a frozen numpy copy of the port's
``systems.protein.solvated_polypeptide``.

A loose helix of CA atoms (bonds, angles, dihedrals) with an acid
headgroup every ``sites_every`` residues, in rigid SPC/E water on a
lattice (sites that overlap the peptide dropped); each site's charge is
compensated by ``n_buffer_waters`` waters of a seeded permutation.
Orientations and jitter come from ``default_rng(seed)``, the buffer
permutation and velocities from ``default_rng(seed + 1)``."""
from __future__ import annotations

import numpy as np

from cph_bench.inputs import common as c


def solvated_polypeptide(seed, *, n_residues=32, sites_every=2, box_len=62.0,
                         water_spacing=3.15, pKs=(4.25, 3.65, 6.5), pH=7.0,
                         T=300.0, dq_scale=1.0, n_buffer_waters=1,
                         cutoff=9.0, skin=2.0, alpha=0.0, coul_style="dsf",
                         lam=0.2):
    rng = np.random.default_rng(seed)
    t = np.arange(n_residues) * 0.6
    bb = np.stack([6.5 * np.cos(t), 6.5 * np.sin(t), 1.9 * t], axis=-1)
    bb += box_len / 2 - bb.mean(axis=0)

    xs, ts, qs, ms = [], [], [], []
    bonds, angles, dihedrals = [], [], []
    CA, AC, AO1, AO2, AH, WO, WH = range(7)

    def add(x, ty, q, m):
        xs.append(x)
        ts.append(ty)
        qs.append(q)
        ms.append(m)
        return len(xs) - 1

    ca_ids, site_atoms = [], []
    geo = c.acid_geometry() - c.acid_geometry()[0]
    for r in range(n_residues):
        ca = add(bb[r], CA, 0.0, 12.011)
        ca_ids.append(ca)
        if r > 0:
            bonds.append((ca_ids[r - 1], ca, 250.0, 3.80))
        if r > 1:
            angles.append((ca_ids[r - 2], ca_ids[r - 1], ca, 40.0,
                           np.deg2rad(110.0)))
        if r > 2:
            dihedrals.append((ca_ids[r - 3], ca_ids[r - 2], ca_ids[r - 1],
                              ca, 0.6, 3.0, 0.0))
        if r % sites_every == 0:
            out = bb[r] - [box_len / 2, box_len / 2, bb[r][2]]
            out[2] = 0.0
            out /= max(np.linalg.norm(out), 1e-6)
            base = bb[r] + out * 2.6
            ids = [add(base + geo[a], (AC, AO1, AO2, AH)[a],
                       c.ACID_Q_PROT[a], c.ACID_MASS[a]) for a in range(4)]
            bonds += [(ca, ids[0], 200.0, 2.6), (ids[0], ids[1], 570.0, 1.25),
                      (ids[0], ids[2], 450.0, 1.25),
                      (ids[2], ids[3], 553.0, 0.97)]
            angles += [(ids[1], ids[0], ids[2], 80.0, np.deg2rad(126.0)),
                       (ids[0], ids[2], ids[3], 55.0, np.deg2rad(113.0)),
                       (ca, ids[0], ids[1], 45.0, np.deg2rad(120.0))]
            site_atoms.append(ids)

    n_prot = len(xs)
    prot_x = np.array(xs)
    n_side = int(np.floor(box_len / water_spacing))
    spacing = box_len / n_side
    lattice = (np.array([[i, j, k] for i in range(n_side)
                         for j in range(n_side) for k in range(n_side)],
                        np.float64) + 0.5) * spacing
    d2 = ((lattice[:, None, :] - prot_x[None]) ** 2).sum(-1).min(axis=1)
    lattice = lattice[d2 > 9.0]
    n_wat = len(lattice)
    wgeo = c.water_geometry() - c.water_geometry().mean(axis=0)
    rots = c.random_rotations(n_wat, rng)
    wat_x = lattice[:, None, :] + np.einsum("mij,aj->mai", rots, wgeo)
    wat_x += rng.normal(scale=0.04, size=(n_wat, 1, 3))

    x = np.concatenate([prot_x, wat_x.reshape(-1, 3)])
    n = len(x)
    wat_o = n_prot + 3 * np.arange(n_wat)
    types = np.concatenate([ts, np.tile([WO, WH, WH], n_wat)])
    q0 = np.concatenate([qs, np.tile([c.Q_O, c.Q_H, c.Q_H], n_wat)])
    mass = np.concatenate([ms, np.tile([c.M_O, c.M_H, c.M_H], n_wat)])
    eps = [0.10, c.ACID_EPS[0], c.ACID_EPS[1], c.ACID_EPS[2], 0.0, c.EPS_O,
           0.0]
    sig = [3.50, c.ACID_SIG[0], c.ACID_SIG[1], c.ACID_SIG[2], 1.0, c.SIG_O,
           1.0]

    graph = np.concatenate([
        np.array([b[:2] for b in bonds], np.int64),
        np.stack([wat_o, wat_o + 1], -1), np.stack([wat_o, wat_o + 2], -1),
        np.stack([wat_o + 1, wat_o + 2], -1)])
    excl = c.exclusions(n, graph, max_excl=24)

    n_sites = len(site_atoms)
    if n_sites * n_buffer_waters > n_wat:
        raise ValueError(f"need {n_sites * n_buffer_waters} buffer waters, "
                         f"only {n_wat}")
    perm = c.n_buffer_permutation(seed, n_wat)
    sites = []
    for s, ids in enumerate(site_atoms):
        bo = wat_o[perm[s::n_sites][:n_buffer_waters]]
        sites.append(c.site(ids, pKs[s % len(pKs)],
                            np.stack([bo, bo + 1, bo + 2], -1).reshape(-1),
                            dq_scale=dq_scale))
    groupH = np.zeros(n, bool)
    groupH[[ids[3] for ids in site_atoms]] = True
    v = c.velocities(np.random.default_rng(seed + 1), mass, T)
    return c.system_dict(
        x=x, v=v, box=np.full(3, box_len), lam=np.full(n_sites, lam), pH=pH,
        mass=mass, q0=q0, types=types,
        pair=c.pair_params(eps, sig, cutoff, alpha, coul_style),
        bonded_d=c.bonded(bonds, angles, dihedrals), excl=excl,
        triplets=np.stack([wat_o, wat_o + 1, wat_o + 2], -1),
        site_table=c.spec(sites), groupH=groupH, skin=skin)
