"""A hard tile set for the water-water kernels K1 (csrc/ww_pair.cu) and
K2 (csrc/ww_tally.cu), made with numpy from a seed, on a small non-cubic
grid.

Both kernels skip molecule pairs whose O-O distance rules out any atom
pair inside the cutoff. These tiles hold what such a cull could get
wrong:

- molecules whose O-H bonds are stretched to 2-3 Å (a cull that assumed
  rigid 1 Å molecules would drop their pairs);
- molecules straddling each of the six box faces;
- atom pairs placed at r = rc ± 0.005 Å across cell boundaries, interior
  and periodic: O-O, H-H of rigid molecules, and H-H of stretched
  molecules pointing at each other (O-O then rc + 4.995 Å);
- one cell filled to W and one cell with every slot parked.

Molecules are stored as the layout stores them: whole, wrapped into the
box by their centroid, in the cell of their centroid; empty slots parked
as tiled.layout.to_tiled parks them. Atoms of different molecules keep
≥ 1.5 Å apart (O-O ≥ 2.6 Å), so no contact dominates the forces.
"""
from __future__ import annotations

import numpy as np

from constant_ph_tpu_torch.systems.water import (
    EPS_O, M_H, M_O, Q_H, Q_O, R_HH, R_OH, SIG_O, THETA_HOH)
from constant_ph_tpu_torch.tiled.layout import PARK_BASE, PARK_SPACING

CELL = (10.4, 10.7, 11.0)      # Å per cell (rc 8 + skin + molecule)
# (style, α) the tiles are checked in: both styles at the bench's
# screening, and unscreened 'cut', where a pair just inside rc still
# carries the full 1/rc
COULOMB = (("dsf", 0.2), ("cut", 0.30), ("cut", 0.0))
MIN_GAP = 1.5                  # Å between atoms of different molecules
MIN_GAP_OO = 2.6               # Å between their O atoms (LJ)


def spce_water(cutoff):
    """SPC/E constants in the form tiled.layout.WaterModel takes."""
    c6 = 4.0 * EPS_O * SIG_O**6
    c12 = 4.0 * EPS_O * SIG_O**12
    return dict(qO=Q_O, qH=Q_H, c6_OO=c6, c12_OO=c12,
                eshift_OO=c12 / cutoff**12 - c6 / cutoff**6, d_OH=R_OH,
                d_HH=float(R_HH), mO=M_O, mH=M_H)


def _unit(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def _water(o, h1_dir, l1=R_OH, l2=R_OH, rng=None):
    """(3, 3) atoms: H1 along h1_dir, H2 at the SPC/E angle in a random
    plane (a fixed one without rng)."""
    u = _unit(h1_dir)
    p = rng.normal(size=3) if rng is not None else np.array([0.3, 0.7, 0.2])
    p = _unit(p - np.dot(p, u) * u)
    u2 = np.cos(THETA_HOH) * u + np.sin(THETA_HOH) * p
    o = np.asarray(o, np.float64)
    return np.stack([o, o + l1 * u, o + l2 * u2])


def hard_water_tiles(seed=0, grid=(3, 4, 5), W=24, cutoff=8.0):
    """Returns dict(wx (3, G, 3W) float32, wvalid (G, W) float32 (1 for
    a molecule, 0 for a parked slot), box (3,) float32, params (the
    TileParams fields), water (WaterModel fields), probes: the placed
    pairs as dicts a=(cell, slot), b=(cell, slot), r=target distance)."""
    rng = np.random.default_rng(seed)
    grid = np.asarray(grid)
    cell = np.asarray(CELL)[:3]
    box = grid * cell
    rc = cutoff
    mols, pairs = [], []

    def probe(o_p, o_q, dirs, lens, atoms, r):
        """Two molecules whose atoms atoms[0] (of P) and atoms[1] (of Q)
        are r apart."""
        pairs.append((len(mols), atoms[0], len(mols) + 1, atoms[1], r))
        mols.append(_water(o_p, dirs[0], *lens[0]))
        mols.append(_water(o_q, dirs[1], *lens[1]))

    x = np.array([1.0, 0, 0])
    y = np.array([0, 1.0, 0])
    z = np.array([0, 0, 1.0])
    d = _unit([1, 1, 1])
    rigid = ((R_OH, R_OH), (R_OH, R_OH))
    # O-O at rc - 0.005 across the interior x face of cells (0,1,1)|(1,1,1)
    k = np.array([cell[0], 1.5 * cell[1], 1.5 * cell[2]])
    a = (rc - 0.005) / 2
    probe(k - a * x, k + a * x, (-x, x), rigid, (0, 0), rc - 0.005)
    # O-O at rc + 0.005 across the periodic y face
    k = np.array([1.5 * cell[0], box[1], 2.5 * cell[2]])
    a = (rc + 0.005) / 2
    probe(k - a * y, k + a * y, (-y, y), rigid, (0, 0), rc + 0.005)
    # rigid H-H head-on at rc - 0.005 across the interior z face
    k = np.array([2.5 * cell[0], 2.5 * cell[1], 2 * cell[2]])
    a = (rc - 0.005) / 2 + R_OH
    probe(k - a * z, k + a * z, (z, -z), rigid, (1, 1), rc - 0.005)
    # stretched (2.5 Å) H-H head-on at rc - 0.005 across an interior cell
    # corner: O-O is rc + 4.995
    k = cell * np.array([1, 2, 3])
    a = (rc - 0.005) / 2 + 2.5
    probe(k - a * d, k + a * d, (d, -d), ((2.5, 2.2), (2.5, 2.8)), (1, 1),
          rc - 0.005)
    # stretched (2.8 Å) H-H head-on at rc + 0.005 across the periodic x face
    k = np.array([box[0], 2.5 * cell[1], 0.5 * cell[2]])
    a = (rc + 0.005) / 2 + 2.8
    probe(k - a * x, k + a * x, (x, -x), ((2.8, 2.0), (2.8, 3.0)), (1, 1),
          rc + 0.005)
    atoms = np.concatenate(mols)
    G = int(np.prod(grid))
    count = np.zeros(G, np.int64)

    def cell_of(m):
        c = m.mean(0)
        ci = np.floor((c - box * np.floor(c / box)) / cell).astype(int)
        return int((ci[0] * grid[1] + ci[1]) * grid[2] + ci[2])

    def add(m, cid=None):
        """Append m if it keeps MIN_GAP from every atom (and, with cid,
        has its centroid in cell cid)."""
        nonlocal atoms
        dd = m[:, None, :] - atoms[None, :, :]
        dd -= box * np.round(dd / box)
        r = np.sqrt((dd * dd).sum(-1))
        if (r.min() < MIN_GAP or r[0, 0::3].min() < MIN_GAP_OO
                or (cid is not None and cell_of(m) != cid)):
            return False
        mols.append(m)
        atoms = np.concatenate([atoms, m])
        count[cell_of(m)] += 1
        return True

    for m in mols:
        count[cell_of(m)] += 1
    # one molecule across each box face: O 0.5 Å inside, H1 1 Å outward
    for dim in range(3):
        for side in (0, 1):
            out = np.zeros(3)
            out[dim] = -1.0 if side == 0 else 1.0
            while True:
                o = rng.uniform(0.2, 0.8, 3) * box
                o[dim] = 0.5 if side == 0 else box[dim] - 0.5
                if add(_water(o, out, rng=rng)):
                    break

    # a lattice of 27 spots per cell: one cell full, one parked, the rest
    # 60% filled, a fifth of those stretched
    ids = [(c[0] * grid[1] + c[1]) * grid[2] + c[2]
           for c in np.ndindex(*grid)]
    free = [c for c in ids if count[c] == 0]
    full, empty = free[0], free[-1]
    spots = (np.stack(np.meshgrid(*(np.arange(3),) * 3, indexing="ij"),
                      -1).reshape(-1, 3) + 0.5) / 3.0
    for cid in [full] + [c for c in ids if c not in (full, empty)]:
        lo = np.array(np.unravel_index(cid, grid)) * cell
        for s in rng.permutation(len(spots)):
            if count[cid] == W:
                break
            if cid != full and rng.random() > 0.6:
                continue
            o = lo + spots[s] * cell + rng.uniform(-0.3, 0.3, 3)
            lens = (R_OH, R_OH)
            if cid != full and rng.random() < 0.2:
                lens = tuple(rng.uniform(2.0, 3.0, 2))
            if not add(_water(o, rng.normal(size=3), *lens, rng=rng), cid):
                add(_water(o, rng.normal(size=3), rng=rng), cid)
    if count[full] != W or count[empty] != 0:
        raise ValueError("hard tiles: the full or the parked cell is wrong")

    # bin by centroid, wrap each molecule by its centroid image, park the
    # empty slots as to_tiled does
    wx = np.repeat(PARK_BASE + PARK_SPACING * np.arange(G * W,
                                                        dtype=np.float64),
                   3).reshape(1, G, 3 * W).repeat(3, axis=0)
    fill = np.zeros(G, np.int64)
    where = []
    for m in mols:
        cid = cell_of(m)
        if fill[cid] >= W:
            raise ValueError("hard tiles: a cell exceeds W")
        img = box * np.floor(m.mean(0) / box)
        wx[:, cid, 3 * fill[cid]:3 * fill[cid] + 3] = (m - img).T
        where.append((cid, int(fill[cid])))
        fill[cid] += 1
    offsets = tuple((ox, oy, oz) for ox in (-1, 0, 1) for oy in (-1, 0, 1)
                    for oz in (-1, 0, 1) if (ox, oy, oz) > (-ox, -oy, -oz))
    wvalid = (np.arange(W)[None, :] < fill[:, None]).astype(np.float32)
    return dict(
        wx=wx.astype(np.float32), wvalid=wvalid, box=box.astype(np.float32),
        params=dict(grid=tuple(int(g) for g in grid), W=W,
                    half_stencil=offsets, cutoff=float(cutoff), skin=0.0),
        water=spce_water(cutoff),
        probes=[dict(a=(where[i][0], 3 * where[i][1] + ai),
                     b=(where[j][0], 3 * where[j][1] + bj), r=r)
                for i, ai, j, bj, r in pairs])


def pad_tiles(h, W):
    """The tile set ``h`` (as hard_water_tiles returns it) at a larger
    capacity W: every molecule keeps its cell and slot, and slots from the
    old W on are empty. Every empty slot is parked where to_tiled parks it
    at this W."""
    g = h["params"]["grid"]
    G, W0 = int(np.prod(g)), h["params"]["W"]
    if W < W0:
        raise ValueError(f"pad_tiles: W {W} below the tiles' {W0}")
    wvalid = np.zeros((G, W), np.float32)
    wvalid[:, :W0] = h["wvalid"]
    park = PARK_BASE + PARK_SPACING * np.arange(G * W, dtype=np.float64)
    wx = np.repeat(park, 3).reshape(1, G, 3 * W).repeat(3, axis=0)
    live = np.repeat(wvalid > 0, 3, axis=1)                  # (G, 3W)
    wx[:, live] = h["wx"][:, np.repeat(h["wvalid"] > 0, 3, axis=1)]
    return dict(h, wx=wx.astype(np.float32), wvalid=wvalid,
                params=dict(h["params"], W=W))
