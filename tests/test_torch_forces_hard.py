"""Parity of water_water_fast_plain (the plain version of the CUDA kernel
K1's function) with the JAX package's XLA water_water_fast on the hard
tile set of tiled/hard_tiles.py, in the three Coulomb settings and padded
to W 208, at the bars of tests/test_torch_forces.py (split from that file
so that no port test file collects more than five tests).
"""
import jax.numpy as jnp
import pytest
import torch
from constant_ph_tpu.tiled import forces as jf
from constant_ph_tpu.tiled import layout as jl
from constant_ph_tpu_torch.tiled import forces as tf
from constant_ph_tpu_torch.tiled.hard_tiles import hard_water_tiles, pad_tiles
from constant_ph_tpu_torch.tiled.layout import TileParams, WaterModel

from test_torch_forces import (  # noqa: F401  (fixtures and helpers)
    HARD_WW,
    _assert_ww_close,
)

# the suite runs six xdist workers on the same cores: one torch thread
# each keeps the port tests from oversubscribing them
torch.set_num_threads(1)


@pytest.mark.parametrize("style,alpha,pad", HARD_WW, ids=[
    f"{s}-{a}" + (f"-W{w}" if w else "") for s, a, w in HARD_WW])
def test_water_water_plain_matches_xla_on_hard_tiles(style, alpha, pad):
    """The oracle of K1's molecule cull, on the tiles that could break it
    (tiled/hard_tiles.py): stretched molecules, every box face straddled,
    pairs at rc ± 0.005 Å, a full cell and a parked one. Padded to W 208,
    the parked slots' forces are zeros and the live slots' forces and the
    energies are those of the W 24 tiles."""
    h = hard_water_tiles()
    pr = dict(h["params"])
    jp = jl.TileParams(**pr)
    kw = dict(style=style, alpha=alpha, rc=pr["cutoff"])
    g = (3,) + pr["grid"] + (3 * pr["W"],)
    t = pad_tiles(h, pad) if pad else h
    tp = TileParams(**t["params"])
    got = tf.water_water_fast_plain(
        torch.as_tensor(t["wx"]).reshape((3,) + tp.grid + (3 * tp.W,)),
        WaterModel(**h["water"]), tp, torch.as_tensor(h["box"]), **kw)
    if pad:
        live = torch.zeros(tp.grid + (3 * tp.W,), dtype=torch.bool)
        live[..., :3 * pr["W"]] = True
        assert not got[2][:, ~live].any()
        got = got[:2] + (got[2][:, live].reshape(g),)
    _assert_ww_close(got, jf.water_water_fast(
        jnp.asarray(h["wx"]).reshape(g), jl.WaterModel(**h["water"]), jp,
        jnp.asarray(h["box"]), **kw))
