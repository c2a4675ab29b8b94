"""Parity of the PyTorch port's tally path with the JAX package: the tally
pair blocks (tiled/forces.water_water, water_solute,
water_intra_ewald_correction), the plain version of the full-tally
water-water kernel K2 (water_water_tally_plain, the function of
csrc/ww_tally.cu), and the engine's tally dispatch, on the dilute grid-4³
box of tests/test_pallas_ww.py (tile_safety 0.2, W = 20) in both Coulomb
styles, plus a grid-(1,1,1) box.

Tolerances, from the float32 differences measured on the CPU:
- water_water / water_solute against JAX tforces.water_water /
  water_solute (same formulas, same erfc): forces, tallies and φ scaled
  by max(1, |ref|max) within 3e-6 (measured ≤ 1e-6); energies rtol 1e-5
  plus atol 1e-5 (e_lj) / 1e-4 (e_coul, a float32 sum of large ± terms),
  the bars of tests/test_torch_forces.py.
- K2's plain version against JAX water_water_pallas in interpret mode
  (the same Abramowitz–Stegun erfc, same stencil): the same bars
  (measured ≤ 1.6e-6 scaled, e_coul 3.5e-6 relative).
- K2's plain version against JAX tforces.water_water (exact erfc vs the
  A–S fit, |ε| < 1.5e-7 of erfc): the bars tests/test_pallas_ww.py holds
  those two JAX paths to — energies rtol 2e-4 (atol 1e-4 e_lj, 1e-3
  e_coul), forces scaled 2e-5, φ rtol/atol 1e-3.
- engine compute_forces / compute_Hs, need_tally on the plain tally path
  and use_pallas_ww=True (K2's plain version) against the JAX engine with
  use_pallas_ww=True, whose Pallas kernel runs in interpret mode here:
  the bars of tests/test_torch_engine.py (scaled 3e-6, energies rtol 1e-5
  / atol 1e-4; measured ≤ 1.4e-6 scaled).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from constant_ph_tpu.tiled import forces as jf
from constant_ph_tpu.tiled.pallas_ww import (
    pack_water_tiles as jax_pack,
    water_water_pallas,
)
from constant_ph_tpu_torch.tiled import forces as tf

from test_torch_layout import jax_tiled, port_of

# the suite runs six xdist workers on the same cores: one torch thread
# each keeps the port tests from oversubscribing them
torch.set_num_threads(1)

STYLES = [("dsf", 0.2), ("cut", 0.35)]
NVE = dict(dt=1.0, thermostat="nve", lambda_thermostat="none",
           rebuild_every=4)


@pytest.fixture(scope="module", params=STYLES, ids=lambda s: s[0])
def case(request):
    style, alpha = request.param
    _, jts, jst = jax_tiled(style, alpha)
    tts, tst = port_of(jts, jst)
    return style, alpha, jts, jst, tts, tst


def _grids(st, p, wx):
    gx, gy, gz = p.grid
    return (wx.reshape(3, gx, gy, gz, 3 * p.W),
            st.wvalid.reshape(gx, gy, gz, p.W))


def _np(a):
    if isinstance(a, (list, tuple)):
        a = np.stack([np.asarray(x) for x in a])
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, ref, names, f_atol=3e-6, e_rtol=1e-5, e_atol=(1e-5, 1e-4)):
    """Energies first (e_lj, e_coul), then arrays scaled by max|ref|."""
    for k in range(2):
        np.testing.assert_allclose(float(got[k]), float(ref[k]),
                                   rtol=e_rtol, atol=e_atol[k],
                                   err_msg=names[k])
    for g, r, name in zip(got[2:], ref[2:], names[2:]):
        r = _np(r)
        scale = max(1.0, np.abs(r).max())
        np.testing.assert_allclose(_np(g) / scale, r / scale, atol=f_atol,
                                   err_msg=name)


WW = ("e_lj", "e_coul", "f", "eatom", "phi")


def test_water_water_and_water_solute_match(case):
    style, alpha, jts, jst, tts, tst = case
    p = jts.params
    kw = dict(style=style, alpha=alpha, rc=p.cutoff)
    jwx, jwv = _grids(jst, p, jst.wx)
    twx, twv = _grids(tst, tts.params, tst.wx)
    _close(tf.water_water(twx, twv, tts.water, tts.params, tst.box, **kw),
           jf.water_water(jwx, jwv, jts.water, p, jst.box, **kw), WW)
    # a mid-titration charge set, so λ-dependent charges are exercised
    q = np.asarray(jts.solute.q0) + 0.1 * np.sin(np.arange(
        jts.solute.q0.shape[0]))
    got = tf.water_solute(twx, twv, tst.sx,
                          torch.as_tensor(q, dtype=torch.float32),
                          tts.solute, tts.water, tts.params, tst.box, **kw)
    ref = jf.water_solute(jwx, jwv, jst.sx, jnp.asarray(q, jnp.float32),
                          jts.solute, jts.water, p, jst.box, **kw)
    _close(got, ref, ("e_lj", "e_coul", "f_w", "f_s", "eatom_w", "eatom_s",
                      "phi_w", "phi_s"))


def test_k2_plain_matches_pallas_and_tally_path(case):
    style, alpha, jts, jst, tts, tst = case
    p = jts.params
    kw = dict(style=style, alpha=alpha, rc=p.cutoff)
    jwx, jwv = _grids(jst, p, jst.wx)
    twx, twv = _grids(tst, tts.params, tst.wx)
    # the packed tiles are the JAX package's, slot for slot
    wt = tf.pack_water_tiles(twx, twv, tts.water, tts.params)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(
        jax_pack(jwx, jwv, jts.water, p)))
    got = tf.water_water_tally(twx, twv, tts.water, tts.params, tst.box,
                               **kw)
    _close(got, water_water_pallas(jwx, jwv, jts.water, p, jst.box,
                                   interpret=True, **kw), WW)
    ref = jf.water_water(jwx, jwv, jts.water, p, jst.box, **kw)
    _close(got[:4], ref[:4], WW[:4], f_atol=2e-5, e_rtol=2e-4,
           e_atol=(1e-4, 1e-3))
    np.testing.assert_allclose(got[4].numpy(), np.asarray(ref[4]),
                               rtol=1e-3, atol=1e-3)       # φ
    # on a CPU tensor the dispatching contract is the plain version
    out = tf.water_water_tally_plain(wt, tst.box, tts.water, tts.params,
                                     **kw)
    assert torch.equal(got[3], out[..., 3, :] + out[..., 4, :])
    assert not out[..., 6:, :].any()
    # the per-atom tallies add up to the totals
    np.testing.assert_allclose(float(torch.sum(got[3])),
                               float(got[0] + got[1]), rtol=1e-5)


def _engine_close(got, ref, names, f_atol, e_rtol, e_atol):
    for name in names:
        r = np.asarray(getattr(ref, name))
        scale = max(1.0, np.abs(r).max())
        np.testing.assert_allclose(getattr(got, name).numpy() / scale,
                                   r / scale, atol=f_atol, err_msg=name)
    for name in ("e_lj", "e_coul", "e_bonded", "e_site", "e_pot"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(ref, name)), rtol=e_rtol,
                                   atol=e_atol, err_msg=name)
