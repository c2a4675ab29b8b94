"""The work behind the water-water kernel K1 (csrc/ww_pair.cu), on the CPU:

- ``tiled.forces.water_pairs_in_cutoff``, the pair count that sets K1's
  bound in chip_smoke.py, against a brute-force minimum-image count;
- the hard tile set (tiled/hard_tiles.py) holds what it claims;
- K1's molecule cull, as its source states it, keeps every molecule pair
  with an atom pair inside rc on those tiles, in float32.

The kernel itself runs only on the GPU; chip_smoke.py holds it against
water_water_fast_plain there, on these tiles too.
"""
import numpy as np
import torch

from constant_ph_tpu_torch.systems.water import water_box
from constant_ph_tpu_torch.tiled import forces as tf
from constant_ph_tpu_torch.tiled.hard_tiles import hard_water_tiles
from constant_ph_tpu_torch.tiled.layout import (
    TileParams, split_system, to_tiled)

torch.set_num_threads(1)

CULL_MARGIN = 0.01      # Å, as in csrc/ww_pair.cu


def _hard():
    h = hard_water_tiles()
    p = TileParams(**h["params"])
    wxg = torch.as_tensor(h["wx"]).reshape((3,) + p.grid + (3 * p.W,))
    return h, p, wxg, torch.as_tensor(h["box"])


def test_pairs_in_cutoff_match_brute_force():
    """On a liquid-density water box (grid 3³), the count equals the
    pairs a float64 minimum-image search finds within rc, up to the pairs
    within 1e-4 Å of rc, where float32 rounding decides."""
    rc = 8.0
    sys_ = water_box(n_side=11, cutoff=rc, seed=4, device="cpu")
    ts = split_system(sys_, skin=0.8, tile_safety=1.72, device="cpu")
    st = to_tiled(ts, sys_.state)
    p = ts.params
    assert min(p.grid) == 3
    n = int(tf.water_pairs_in_cutoff(
        st.wx.reshape((3,) + p.grid + (3 * p.W,)), p, st.box, rc))

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


def test_hard_tiles_hold_what_they_claim():
    h, p, wxg, box = _hard()
    wx = h["wx"].astype(np.float64)                          # (3, G, A)
    L = h["box"].astype(np.float64)
    parked = wx[0, :, 0::3] > 5e3                            # (G, W)
    o, h1, h2 = wx[:, :, 0::3], wx[:, :, 1::3], wx[:, :, 2::3]
    oh = np.maximum(np.linalg.norm(h1 - o, axis=0),
                    np.linalg.norm(h2 - o, axis=0))
    assert ((oh > 2.0) & (oh < 3.0) & ~parked).sum() >= 50   # stretched
    atoms = np.repeat(~parked, 3, axis=1)
    for d in range(3):                                       # every face
        assert wx[d][atoms].min() < 0.0 and wx[d][atoms].max() > L[d]
    occ = (~parked).sum(axis=1)
    assert occ.max() == p.W and occ.min() == 0               # full, parked

    rc = p.cutoff
    drop_by_rigid_cull = False
    for pr in h["probes"]:
        (ca, sa), (cb, sb) = pr["a"], pr["b"]
        assert ca != cb                                      # across cells
        dx = wx[:, ca, sa] - wx[:, cb, sb]
        dx -= L * np.round(dx / L)
        assert abs(np.linalg.norm(dx) - pr["r"]) < 1e-4
        assert np.isclose(abs(pr["r"] - rc), 0.005)
        do = wx[:, ca, sa - sa % 3] - wx[:, cb, sb - sb % 3]
        do -= L * np.round(do / L)
        # a cull that took every molecule as 1 Å across would skip it
        drop_by_rigid_cull |= (pr["r"] < rc
                               and np.linalg.norm(do) > rc + 2.0 + 0.01)
    assert {pr["r"] < rc for pr in h["probes"]} == {True, False}
    assert drop_by_rigid_cull


def test_molecule_cull_keeps_every_pair_in_cutoff():
    """The cull of csrc/ww_pair.cu on the hard tiles, over all 27 stencil
    offsets: a molecule pair it skips (|O_i − O_j| ≥ rc + ρ_i + ρ_j +
    margin) has no atom pair with r² < rc², computed as the plain version
    computes r² (float32, shifted neighbour tile)."""
    h, p, wxg, box = _hard()
    rc = p.cutoff
    W = p.W

    def radius(x):
        return torch.sqrt(torch.maximum(
            ((x[..., 1::3] - x[..., 0::3]) ** 2).sum(0),
            ((x[..., 2::3] - x[..., 0::3]) ** 2).sum(0)))     # (..., W)

    kept = needed = 0
    rho_i = radius(wxg)
    for off in np.ndindex(3, 3, 3):
        off = tuple(int(v) - 1 for v in off)
        xj = (torch.roll(wxg, tuple(-v for v in off), dims=(1, 2, 3))
              + tf._roll_shift(box, p.grid, off, wxg.dtype))
        do = wxg[..., 0::3, None] - xj[..., None, 0::3]       # (3,...,W,W)
        lim = (rc + CULL_MARGIN + rho_i[..., :, None]
               + radius(xj)[..., None, :])
        keep = (do * do).sum(0) < lim * lim
        dx = wxg[..., :, None] - xj[..., None, :]             # (3,...,A,A)
        r2 = torch.clamp(dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2],
                         min=1e-4)
        hit = (r2 < rc * rc).reshape(r2.shape[:-2] + (W, 3, W, 3)).any(
            dim=-1).any(dim=-2)                               # (..., W, W)
        if off == (0, 0, 0):
            hit &= ~torch.eye(W, dtype=torch.bool)
        assert not (hit & ~keep).any(), off
        kept += int(keep.sum())
        needed += int(hit.sum())
    # the cull leaves a few times the molecule pairs that interact, not
    # the whole stencil
    assert needed <= kept < 27 * p.G * W * W // 10
