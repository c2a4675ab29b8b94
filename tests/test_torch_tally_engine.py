"""Parity of the port's engine tally dispatch (compute_forces with
need_tally, use_pallas_ww=True, compute_Hs) and of
water_intra_ewald_correction with the JAX package, on the boxes and at the
bars of tests/test_torch_tally.py (split from that file so that no port
test file collects more than five tests).
"""
import functools
import numpy as np
import jax
import torch
from constant_ph_tpu.engine import EngineConfig as JConfig
from constant_ph_tpu.tiled import forces as jf
from constant_ph_tpu.tiled import pallas_ww
from constant_ph_tpu.tiled.engine import TiledEngine as JEngine
from constant_ph_tpu.tiled.pallas_ww import water_water_pallas
from constant_ph_tpu_torch.engine import EngineConfig
from constant_ph_tpu_torch.tiled import forces as tf
from constant_ph_tpu_torch.tiled.engine import TiledEngine

from test_torch_tally import (  # noqa: F401  (fixtures and helpers)
    NVE,
    _engine_close,
    case,
)

# the suite runs six xdist workers on the same cores: one torch thread
# each keeps the port tests from oversubscribing them
torch.set_num_threads(1)


def test_water_intra_ewald_correction(case):
    _, _, jts, _, tts, _ = case
    n = len(jts.water_atom_ids)
    for alpha in (0.2, 0.3, 0.35):
        assert tf.water_intra_ewald_correction(tts.water, n, alpha) == \
            jf.water_intra_ewald_correction(jts.water, n, alpha)


def test_engine_tally_and_compute_Hs(case, monkeypatch):
    _, _, jts, jst, tts, tst = case
    jeng = JEngine(jts, JConfig(**NVE))
    ref = jax.jit(lambda s: jeng.compute_forces(s, need_tally=True))(jst)
    jHA, jHB = jax.jit(jeng.compute_Hs)(jst, ref)
    names = ("fw", "fs", "f_lam", "phi_s", "dUdlam", "eatom_w", "eatom_s")
    # need_tally on the plain tally path (water_water + water_solute)
    teng = TiledEngine(tts, EngineConfig(**NVE))
    got = teng.compute_forces(tst, need_tally=True)
    _engine_close(got, ref, names, 3e-6, 1e-5, 1e-4)
    HA, HB = teng.compute_Hs(tst)
    np.testing.assert_allclose(float(HA), float(jHA), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(HB), float(jHB), rtol=1e-5, atol=1e-4)
    # use_pallas_ww=True: K2 on every evaluation, tallies or not; the JAX
    # engine's Pallas kernel runs in interpret mode on the CPU
    monkeypatch.setattr(pallas_ww, "water_water_pallas", functools.partial(
        water_water_pallas, interpret=True))
    jk = JEngine(jts, JConfig(**NVE), use_pallas_ww=True)
    keng = TiledEngine(tts, EngineConfig(**NVE), use_pallas_ww=True)
    for tally in (False, True):
        ref = jax.jit(lambda s: jk.compute_forces(s, need_tally=tally))(jst)
        got = keng.compute_forces(tst, need_tally=tally)
        _engine_close(got, ref, names, 3e-6, 1e-5, 1e-4)
    HA, HB = keng.compute_Hs(tst, got)
    jHA, jHB = jax.jit(jk.compute_Hs)(jst, ref)
    np.testing.assert_allclose(float(HA), float(jHA), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(HB), float(jHB), rtol=1e-5, atol=1e-4)
    want = float(got.e_lj + got.e_coul + got.e_bonded)
    np.testing.assert_allclose(float(HA), want, rtol=1e-5)
