"""The work behind the full-tally water-water kernel K2 (csrc/ww_tally.cu),
on the CPU:

- ``tiled.forces.water_pairs_in_cutoff_tally``, the pair count that sets
  K2's bound in chip_smoke.py, against a brute-force minimum-image count;
- K2's molecule cull, as its source states it (rules (a)-(c) and the
  block's candidate list), keeps every molecule pair with an atom pair
  inside rc on the hard tiles (tiled/hard_tiles.py), in float32 with the
  kernel's minimum image;
- K2's plain version on those tiles, packed with their own validity,
  against the JAX package's tiled.forces.water_water.

The kernel itself runs only on the GPU; chip_smoke.py holds it against
water_water_tally_plain there, on these tiles too.
"""
import re

import numpy as np
import torch

from constant_ph_tpu_torch.systems.water import water_box
from constant_ph_tpu_torch.tiled import cuda_ww
from constant_ph_tpu_torch.tiled import forces as tf
from constant_ph_tpu_torch.tiled.hard_tiles import (
    COULOMB, hard_water_tiles, pad_tiles)
from constant_ph_tpu_torch.tiled.layout import (
    TileParams, WaterModel, split_system, to_tiled)

torch.set_num_threads(1)


def _source_constant(name):
    """A float constant of csrc/ww_tally.cu, so the test follows the
    source."""
    with open(cuda_ww.SOURCES["ww_tally"]) as fh:
        m = re.search(rf"constexpr (?:float|int) {name} = ([0-9.e+-]+)f?;",
                      fh.read())
    return float(m.group(1))


CULL_MARGIN = _source_constant("CULL_MARGIN")
WARPS = int(_source_constant("WARPS"))


def _packed_hard(W=None):
    h = hard_water_tiles()
    if W is not None:
        h = pad_tiles(h, W)
    p = TileParams(**h["params"])
    wm = WaterModel(**h["water"])
    wxg = torch.as_tensor(h["wx"]).reshape((3,) + p.grid + (3 * p.W,))
    wvg = torch.as_tensor(h["wvalid"]).reshape(p.grid + (p.W,))
    box = torch.as_tensor(h["box"])
    return h, p, wm, wxg, wvg, box, tf.pack_water_tiles(wxg, wvg, wm, p)


def test_tally_pairs_in_cutoff_match_brute_force():
    """On a liquid-density water box (grid 3³), the count equals the
    pairs of different molecules a float64 minimum-image search finds
    within rc, up to the pairs within 1e-4 Å of rc, where float32
    rounding decides."""
    rc = 8.0
    sys_ = water_box(n_side=11, cutoff=rc, seed=4, device="cpu")
    ts = split_system(sys_, skin=0.8, tile_safety=1.72, device="cpu")
    st = to_tiled(ts, sys_.state)
    p = ts.params
    assert min(p.grid) == 3
    wt = tf.pack_water_tiles(st.wx.reshape((3,) + p.grid + (3 * p.W,)),
                             st.wvalid.reshape(p.grid + (p.W,)), ts.water,
                             p)
    n = int(tf.water_pairs_in_cutoff_tally(wt, st.box, p, rc))

    x = sys_.state.x.double().numpy()[ts.water_atom_ids.reshape(-1)]
    mol = np.repeat(np.arange(len(ts.water_atom_ids)), 3)
    box = sys_.state.box.double().numpy()
    inside = near = 0
    for i in range(len(x) - 1):
        d = x[i + 1:] - x[i]
        d -= box * np.round(d / box)
        r = np.sqrt((d * d).sum(-1))
        other = mol[i + 1:] != mol[i]
        inside += int(((r < rc) & other).sum())
        near += int(((abs(r - rc) < 1e-4) & other).sum())
    assert inside > 100_000
    assert abs(n - inside) <= near, (n, inside, near)


def _mimg(d, L):
    """The kernel's minimum image of one component: d − L·rint(d / L),
    with 1/L rounded to float32 first."""
    return d - L * torch.round(d * (1.0 / L))


def test_tally_cull_keeps_every_pair_in_cutoff():
    """K2's cull on the hard tiles, over all 27 stencil offsets, in
    float32. A molecule pair the kernel skips — (a) minimum-image O–O ≥
    rc + ρᵢ + ρⱼ + margin (and the kernel's stricter form with the
    stencil's largest ρ), (b) either molecule parked, (c) the molecule
    itself on the self offset — has no atom pair with weight > 0 and
    r² < rc², computed as the plain version computes them. Every pair the
    per-warp test keeps is on its block's candidate list (O_j near the
    box around the block's live O_i, on the torus)."""
    h, p, wm, wxg, wvg, L, wt = _packed_hard()
    rc = p.cutoff
    W, grid = p.W, p.grid

    def radius(t):                                   # (..., W) raw ρ
        x = t[..., :3, :]
        return torch.sqrt(torch.maximum(
            ((x[..., 1::3] - x[..., 0::3]) ** 2).sum(-2),
            ((x[..., 2::3] - x[..., 0::3]) ** 2).sum(-2)))

    def parked(t):
        v = t[..., 5, :]
        return (v[..., 0::3] == 0) & (v[..., 1::3] == 0) & (v[..., 2::3] == 0)

    offsets = [tuple(int(v) - 1 for v in o) for o in np.ndindex(3, 3, 3)]
    tiles = [torch.roll(wt, tuple(-v for v in off), dims=(0, 1, 2))
             for off in offsets]
    assert offsets[13] == (0, 0, 0)
    # the kernel's ρ_max: the largest ρ of the live molecules of each
    # cell's stencil
    rho_max = torch.stack([torch.where(parked(t), 0.0, radius(t)).amax(-1)
                           for t in tiles]).amax(0)          # (gx, gy, gz)
    rho_i = radius(wt)
    park_i = parked(wt)
    o_i = wt[..., :3, 0::3]                                  # (..., 3, W)

    # the block's candidate box: live O_i of each group of WARPS molecules
    nblk = -(-W // WARPS)
    blk = torch.arange(W) // WARPS
    lo = torch.full(grid + (3, nblk), np.inf)
    hi = torch.full(grid + (3, nblk), -np.inf)
    ri = torch.zeros(grid + (nblk,))
    for b in range(nblk):
        sel = (blk == b)[None, None, None, :] & ~park_i      # (..., W)
        lo[..., b] = torch.where(sel[..., None, :], o_i, np.inf).amin(-1)
        hi[..., b] = torch.where(sel[..., None, :], o_i, -np.inf).amax(-1)
        ri[..., b] = torch.where(sel, rho_i, 0.0).amax(-1)
    centre, half = 0.5 * (lo + hi), 0.5 * (hi - lo)

    mol = torch.arange(3 * W) // 3
    kept = needed = skipped_live = 0
    for k, tile in enumerate(tiles):
        park_j = parked(tile)
        do = o_i[..., :, :, None] - tile[..., :3, 0::3][..., :, None, :]
        do = torch.stack([_mimg(do[..., d, :, :], L[d]) for d in range(3)],
                         -3)
        r2o = (do * do).sum(-3)                              # (..., W, W)
        lim_a = rc + rho_i[..., :, None] + radius(tile)[..., None, :] \
            + CULL_MARGIN
        lim_k = (rc + rho_i + rho_max[..., None] + CULL_MARGIN)[..., None]
        skip_b = park_i[..., :, None] | park_j[..., None, :]
        skip_c = torch.eye(W, dtype=torch.bool) if k == 13 else \
            torch.zeros(W, W, dtype=torch.bool)
        skip = (r2o >= lim_a * lim_a) | skip_b | skip_c
        skip_kernel = (r2o >= lim_k * lim_k) | skip_b | skip_c
        # the kernel's ρ_max form skips a subset of rule (a)'s pairs
        assert not (skip_kernel & ~skip).any()

        dx = [wt[..., d, :, None] - tile[..., d, :][..., None, :]
              for d in range(3)]
        r2 = sum(_mimg(x, L[d]) ** 2 for d, x in enumerate(dx))
        w = wt[..., 5, :, None] * tile[..., 5, :][..., None, :]
        if k == 13:
            w = w * (mol[:, None] != mol[None, :])
        r2 = torch.where(w > 0, torch.clamp(r2, min=1e-4),
                         torch.full_like(r2, rc * rc + 1.0))
        hit = (r2 < rc * rc).reshape(r2.shape[:-2] + (W, 3, W, 3)).any(
            dim=-1).any(dim=-2)                              # (..., W, W)
        assert not (hit & skip).any(), offsets[k]

        # the candidate list holds every pair the per-warp test keeps
        oj = tile[..., :3, 0::3]                             # (..., 3, W)
        e = _mimg(oj[..., :, None, :] - centre[..., :, :, None],
                  L[:, None, None])                          # (.,3,nblk,W)
        e = torch.clamp(e.abs() - half[..., :, :, None], min=0.0)
        lim_b = rc + ri + rho_max[..., None] + 2 * CULL_MARGIN
        near = ((e * e).sum(-3) < (lim_b * lim_b)[..., None]) \
            & ~park_j[..., None, :]                          # (.,nblk,W)
        near_i = near[..., blk, :]                           # (..., W, W)
        assert not (~skip_kernel & ~near_i).any(), offsets[k]

        kept += int((~skip_kernel).sum())
        needed += int(hit.sum())
        skipped_live += int((skip_kernel & ~skip_b & ~skip_c).sum())
    # the cull leaves a few times the molecule pairs that interact, not
    # the whole stencil, and rule (a) does real work among live pairs
    assert needed <= kept < 27 * p.G * W * W // 10
    assert skipped_live > 2 * kept


# the hard tiles at their W 24 in each Coulomb setting, and padded with
# parked slots to W 208 (the width configs/hewl_like.json builds, where
# the CUDA kernels stage their stencil in passes)
HARD_TALLY = [(s, a, None) for s, a in COULOMB] + [("cut", 0.30, 208)]
