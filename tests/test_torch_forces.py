"""Parity of the PyTorch port's tile force blocks and tile SHAKE with the
JAX package, on the dilute grid-4³ box of tests/test_pallas_ww.py (with
tile_safety 0.2, so W = 20).

water_water_fast_plain (the plain version of the CUDA kernel's function)
is held against both JAX forms of the contract: the XLA
``water_water_fast`` and the Pallas ``water_water_pallas_fast`` in
interpret mode, at the tolerances tests/test_pallas_ww.py holds those two
to each other: energies rtol 1e-5 (atol 1e-5 e_lj, 1e-4 e_coul — the
Coulomb total is a float32 sum of large ± terms), forces scaled by
max(1, |f|max) within 3e-6. The CUDA kernel itself runs only on the GPU;
chip_smoke.py holds it against water_water_fast_plain there.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from constant_ph_tpu.tiled import forces as jf
from constant_ph_tpu.tiled import layout as jl
from constant_ph_tpu.tiled.pallas_ww import water_water_pallas_fast
from constant_ph_tpu.tiled.shake import TiledWaterShake as JShake
from constant_ph_tpu_torch.tiled import cuda_ww
from constant_ph_tpu_torch.tiled import forces as tf
from constant_ph_tpu_torch.tiled.hard_tiles import (
    COULOMB, hard_water_tiles, pad_tiles)
from constant_ph_tpu_torch.tiled.layout import TileParams, WaterModel
from constant_ph_tpu_torch.tiled.shake import TiledWaterShake

from test_torch_layout import jax_tiled, port_of

# the suite runs six xdist workers on the same cores: one torch thread
# each keeps the port tests from oversubscribing them
torch.set_num_threads(1)

STYLES = [("dsf", 0.2), ("cut", 0.35)]


@pytest.fixture(scope="module", params=STYLES, ids=lambda s: s[0])
def case(request):
    style, alpha = request.param
    _, jts, jst = jax_tiled(style, alpha)
    tts, tst = port_of(jts, jst)
    return style, alpha, jts, jst, tts, tst


def _grid5(x, p):
    gx, gy, gz = p.grid
    return x.reshape(3, gx, gy, gz, 3 * p.W)


def _assert_ww_close(got, ref):
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-5,
                               atol=1e-5)     # e_lj
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-5,
                               atol=1e-4)     # e_coul
    f_r = np.stack([np.asarray(ref[2][d]) for d in range(3)])
    scale = max(1.0, np.abs(f_r).max())
    np.testing.assert_allclose(got[2].numpy() / scale, f_r / scale,
                               atol=3e-6)


def test_water_water_plain_matches_xla_and_pallas(case):
    style, alpha, jts, jst, tts, tst = case
    p = jts.params
    kw = dict(style=style, alpha=alpha, rc=p.cutoff)
    got = tf.water_water_fast_plain(_grid5(tst.wx, p), tts.water,
                                    tts.params, tst.box, **kw)
    wxg = _grid5(jst.wx, p)
    _assert_ww_close(got, jf.water_water_fast(wxg, jts.water, p, jst.box,
                                              **kw))
    _assert_ww_close(got, water_water_pallas_fast(
        wxg, jts.water, p, jst.box, interpret=True, **kw))
    # on a CPU tensor the dispatching contract is the plain version
    disp = tf.water_water_fast(_grid5(tst.wx, p), tts.water, tts.params,
                               tst.box, **kw)
    for a, b in zip(disp, got):
        assert torch.equal(a, b)


# the hard tiles at their W 24 in each Coulomb setting, and padded with
# parked slots to W 208 (the width configs/hewl_like.json builds, where
# the CUDA kernels stage their stencil in passes)
HARD_WW = [(s, a, None) for s, a in COULOMB] + [("cut", 0.30, 208)]


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


def test_cuda_wrapper_refuses_cpu_tensors(case):
    style, alpha, _, _, tts, tst = case
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ww.water_water_cuda(_grid5(tst.wx, tts.params), tts.water,
                                 tts.params, tst.box, style=style,
                                 alpha=alpha, rc=tts.cutoff)


def test_water_solute_and_solute_solute_match(case):
    style, alpha, jts, jst, tts, tst = case
    p = jts.params
    kw = dict(style=style, alpha=alpha, rc=p.cutoff)
    # a mid-titration charge set, so λ-dependent charges are exercised
    q = np.asarray(jts.solute.q0) + 0.1 * np.sin(np.arange(
        jts.solute.q0.shape[0]))
    ref = jf.water_solute_fast(_grid5(jst.wx, p), jst.sx, jnp.asarray(q),
                               jts.solute, jts.water, p, jst.box, **kw)
    got = tf.water_solute_fast(_grid5(tst.wx, p), tst.sx,
                               torch.as_tensor(q, dtype=torch.float32),
                               tts.solute, tts.water, tts.params, tst.box,
                               **kw)
    for a, b, name in zip(ref, got, ("e_lj", "e_coul", "f_w", "f_s",
                                     "phi_s")):
        a = np.stack(a) if isinstance(a, (list, tuple)) else np.asarray(a)
        scale = max(1.0, np.abs(a).max())
        np.testing.assert_allclose(b.numpy() / scale, a / scale, atol=3e-6,
                                   err_msg=name)
    ref = jf.solute_solute(jst.sx, jnp.asarray(q), jts.solute, jst.box, **kw)
    got = tf.solute_solute(tst.sx, torch.as_tensor(q, dtype=torch.float32),
                           tts.solute, tst.box, **kw)
    for a, b, name in zip(ref, got, ("e_lj", "e_coul", "f", "eatom",
                                     "phi")):
        a = np.asarray(a)
        scale = max(1.0, np.abs(a).max())
        np.testing.assert_allclose(b.numpy() / scale, a / scale, atol=3e-6,
                                   err_msg=name)


def test_tiled_shake_matches(case):
    _, _, jts, jst, tts, tst = case
    rng = np.random.default_rng(11)
    wx = np.asarray(jst.wx)
    valid = np.repeat(np.asarray(jst.wvalid), 3, axis=-1)[None] > 0.5
    moved = np.where(valid, wx + rng.normal(scale=0.03, size=wx.shape), wx)
    v = np.where(valid, rng.normal(scale=0.01, size=wx.shape), 0.0)
    js, ts = JShake(jts.water, jts.params), TiledWaterShake(tts.water)
    jx, jv = js.positions(jst.wx, jnp.asarray(moved, jnp.float32),
                          jnp.asarray(v, jnp.float32), jst.box, 2.0,
                          jst.wvalid)
    tx, tv = ts.positions(tst.wx, torch.as_tensor(moved, dtype=torch.float32),
                          torch.as_tensor(v, dtype=torch.float32), tst.box,
                          2.0, tst.wvalid)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6,
                               atol=2e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(
        ts.velocities(tx, tv, tst.box, tst.wvalid).numpy(),
        np.asarray(js.velocities(jx, jv, jst.box, jst.wvalid)), atol=1e-5)
