"""A model titratable acid in a box of rigid SPC/E water: a frozen numpy
copy of the port's ``systems.water.solvated_acid`` (rigid water only).

Layout: acid atoms 0..3, then the waters; water 0 sits where the acid
would and is left out of the lattice. Positions and orientations come from
``default_rng(seed)``, velocities from ``default_rng(seed + 1)``."""
from __future__ import annotations

import numpy as np

from cph_bench.inputs import common as c


def solvated_acid(seed, *, n_side=6, spacing=3.2, pK=4.25, pH=7.0, T=300.0,
                  dG_ref=0.0, cutoff=9.0, skin=2.0, alpha=0.0,
                  coul_style="cut", hmr=1.0, n_buffer_waters=1, lam=0.5):
    rng = np.random.default_rng(seed)
    n_wat = n_side**3 - 1
    box = np.full(3, n_side * spacing)
    sites = (np.array([[i, j, k] for i in range(n_side)
                       for j in range(n_side) for k in range(n_side)],
                      np.float64) + 0.5) * spacing
    geo = c.water_geometry() - c.water_geometry().mean(axis=0)
    rots = c.random_rotations(n_wat, rng)
    wat_x = sites[1:, None, :] + np.einsum("mij,aj->mai", rots, geo)
    wat_x += rng.normal(scale=0.05, size=(n_wat, 1, 3))
    acid_x = c.acid_geometry() - c.acid_geometry().mean(axis=0) + sites[0]
    x = np.concatenate([acid_x, wat_x.reshape(-1, 3)])
    n = len(x)

    types = np.concatenate([[0, 1, 2, 3], np.tile([4, 5, 5], n_wat)])
    eps = np.concatenate([c.ACID_EPS, [c.EPS_O, 0.0]])
    sig = np.concatenate([c.ACID_SIG, [c.SIG_O, 1.0]])
    acid_mass = c.ACID_MASS.copy()
    if hmr > 1.0:   # hydrogen-mass repartitioning on the acid's O-H
        dm = (hmr - 1.0) * acid_mass[3]
        acid_mass[3] += dm
        acid_mass[2] -= dm
    mass = np.concatenate([acid_mass, np.tile([c.M_O, c.M_H, c.M_H], n_wat)])
    q0 = np.concatenate([c.ACID_Q_PROT, np.tile([c.Q_O, c.Q_H, c.Q_H],
                                                n_wat)])

    wat_o = 4 + 3 * np.arange(n_wat)
    acid_bonds = [[0, 1], [0, 2], [2, 3]]
    graph = np.concatenate([
        acid_bonds, np.stack([wat_o, wat_o + 1], -1),
        np.stack([wat_o, wat_o + 2], -1),
        np.stack([wat_o + 1, wat_o + 2], -1)])
    excl = c.exclusions(n, graph, max_excl=8)
    bonded = c.bonded(
        bonds=[(0, 1, 570.0, 1.25), (0, 2, 450.0, 1.25), (2, 3, 553.0, 0.97)],
        angles=[(1, 0, 2, 80.0, np.deg2rad(126.0)),
                (0, 2, 3, 55.0, np.deg2rad(113.0))])

    if n_buffer_waters > n_wat:
        raise ValueError(f"need {n_buffer_waters} buffer waters, "
                         f"only {n_wat}")
    bufs = (np.array([0]) if n_buffer_waters == 1 else
            np.sort(c.n_buffer_permutation(seed, n_wat)[:n_buffer_waters]))
    buf_o = 4 + 3 * bufs
    table = c.spec([c.site([0, 1, 2, 3], pK, np.stack(
        [buf_o, buf_o + 1, buf_o + 2], -1).reshape(-1), dG_ref=dG_ref)])
    groupH = np.zeros(n, bool)
    groupH[3] = True
    v = c.velocities(np.random.default_rng(seed + 1), mass, T)
    return c.system_dict(
        x=x, v=v, box=box, lam=[lam], pH=pH, mass=mass, q0=q0, types=types,
        pair=c.pair_params(eps, sig, cutoff, alpha, coul_style),
        bonded_d=bonded, excl=excl,
        triplets=np.stack([wat_o, wat_o + 1, wat_o + 2], -1),
        site_table=table, groupH=groupH, skin=skin)
