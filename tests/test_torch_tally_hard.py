"""Parity of K2's plain version with the JAX package's water_water on the
packed hard tiles, in the three Coulomb settings and padded to W 208, at
the bars of tests/test_torch_tally_pairs.py (split from that file so
that no port test file collects more than five tests).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from constant_ph_tpu.tiled import forces as jf
from constant_ph_tpu.tiled import layout as jl
from constant_ph_tpu_torch.tiled import forces as tf

from test_torch_tally_pairs import (  # noqa: F401  (fixtures and helpers)
    HARD_TALLY,
    _packed_hard,
)

# the suite runs six xdist workers on the same cores: one torch thread
# each keeps the port tests from oversubscribing them
torch.set_num_threads(1)


@pytest.mark.parametrize("style,alpha,pad", HARD_TALLY, ids=[
    f"{s}-{a}" + (f"-W{w}" if w else "") for s, a, w in HARD_TALLY])
def test_tally_plain_matches_jax_water_water_on_hard_tiles(style, alpha,
                                                           pad):
    """K2's oracle on the tiles that could break its cull, against the
    JAX package's per-pair min-image block with exact erfc, at the bars
    tests/test_torch_tally.py holds these two functions to: energies rtol
    2e-4 (atol 1e-4 e_lj, 1e-3 e_coul), forces and eatom scaled by
    max(1, |ref|max) within 2e-5, φ rtol/atol 1e-3. Padded to W 208, the
    parked slots' outputs are zeros and the live slots' are held to the
    same JAX block on the W 24 tiles."""
    h, p, wm, wxg, wvg, box, wt = _packed_hard()
    if pad:
        _, pp, _, _, wvp, _, wtp = _packed_hard(pad)
        out = tf.water_water_tally_plain(wtp, box, wm, pp, style=style,
                                         alpha=alpha, rc=p.cutoff)
        live = torch.zeros(pp.grid + (3 * pad,), dtype=torch.bool)
        live[..., :3 * p.W] = True
        assert not out.movedim(-2, 0)[:, ~live].any()
        out = out.movedim(-2, 0)[:, live].reshape(
            (8,) + p.grid + (3 * p.W,)).movedim(0, -2)
    else:
        out = tf.water_water_tally_plain(wt, box, wm, p, style=style,
                                         alpha=alpha, rc=p.cutoff)
    assert not out[..., 6:, :].any()
    # the per-slot outputs of parked slots are zeros
    parked = torch.repeat_interleave(wvg == 0, 3, dim=-1)
    assert not out.movedim(-2, 0)[:, parked].any()
    pr = dict(h["params"])
    g = (3,) + pr["grid"] + (3 * pr["W"],)
    ref = jf.water_water(
        jnp.asarray(h["wx"]).reshape(g),
        jnp.asarray(h["wvalid"]).reshape(pr["grid"] + (pr["W"],)),
        jl.WaterModel(**h["water"]), jl.TileParams(**pr),
        jnp.asarray(h["box"]), style=style, alpha=alpha, rc=pr["cutoff"])
    np.testing.assert_allclose(float(torch.sum(out[..., 3, :])),
                               float(ref[0]), rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(float(torch.sum(out[..., 4, :])),
                               float(ref[1]), rtol=2e-4, atol=1e-3)
    got = (torch.movedim(out[..., :3, :], -2, 0),
           out[..., 3, :] + out[..., 4, :])
    for g_, r_, name in zip(got, ref[2:4], ("f", "eatom")):
        r_ = np.stack([np.asarray(x) for x in r_]) if isinstance(
            r_, (list, tuple)) else np.asarray(r_)
        scale = max(1.0, np.abs(r_).max())
        np.testing.assert_allclose(g_.numpy() / scale, r_ / scale,
                                   atol=2e-5, err_msg=name)
    np.testing.assert_allclose(out[..., 5, :].numpy(), np.asarray(ref[4]),
                               rtol=1e-3, atol=1e-3)          # φ
