"""Parity of the port's water-solute and solute-solute tile blocks and tile
SHAKE with the JAX package, on the box and at the bars of
tests/test_torch_forces.py (split from that file so that no port test
file collects more than five tests).
"""
import numpy as np
import jax.numpy as jnp
import torch
from constant_ph_tpu.tiled import forces as jf
from constant_ph_tpu.tiled.shake import TiledWaterShake as JShake
from constant_ph_tpu_torch.tiled import forces as tf
from constant_ph_tpu_torch.tiled.shake import TiledWaterShake

from test_torch_forces import (  # noqa: F401  (fixtures and helpers)
    _grid5,
    case,
)

# the suite runs six xdist workers on the same cores: one torch thread
# each keeps the port tests from oversubscribing them
torch.set_num_threads(1)


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
