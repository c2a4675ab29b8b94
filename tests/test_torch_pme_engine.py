"""Parity of the tiled engine's PME path (compute_forces, hot path and
tally, and compute_Hs) with the JAX package, on the box and at the bars
of tests/test_torch_pme.py (split from that file so that no port test
file collects more than five tests).
"""
import numpy as np
import jax
import pytest
import torch
from constant_ph_tpu.engine import EngineConfig as JConfig
from constant_ph_tpu.tiled.engine import TiledEngine as JEngine
from constant_ph_tpu_torch.engine import EngineConfig
from constant_ph_tpu_torch.tiled.engine import TiledEngine

from test_torch_pme import (  # noqa: F401  (fixtures and helpers)
    NVE,
    _e_atol,
    _scaled_close,
    case,
)

# the suite runs six xdist workers on the same cores: one torch thread
# each keeps the port tests from oversubscribing them
torch.set_num_threads(1)


@pytest.mark.parametrize("need_tally", [False, True],
                         ids=["hot-path", "tally"])
def test_engine_pme_compute_forces_and_Hs(case, need_tally):
    jts, jst, tts, tst, jpp, tpp = case
    jeng = JEngine(jts, JConfig(**NVE), kspace_ep=jpp)
    teng = TiledEngine(tts, EngineConfig(**NVE), kspace_ep=tpp)
    ref = jax.jit(lambda s: jeng.compute_forces(s, need_tally=need_tally))(
        jst)
    got = teng.compute_forces(tst, need_tally=need_tally)
    assert teng.e_corr == jeng.e_corr
    names = ["fw", "fs", "f_lam", "phi_s", "dUdlam", "phi_recip_s"]
    if need_tally:
        names += ["eatom_w", "eatom_s"]
    for name in names:
        _scaled_close(getattr(got, name).numpy(), getattr(ref, name),
                      2.5e-4, name)
    e_atol = _e_atol(jts, jst)
    for name in ("e_lj", "e_coul", "e_bonded", "e_kspace", "e_site",
                 "e_pot"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(ref, name)), rtol=2e-5,
                                   atol=e_atol, err_msg=name)
    if need_tally:
        jHA, jHB = jax.jit(jeng.compute_Hs)(jst, ref)
        HA, HB = teng.compute_Hs(tst, got)
        np.testing.assert_allclose(float(HA), float(jHA), rtol=2e-5,
                                   atol=e_atol)
        np.testing.assert_allclose(float(HB), float(jHB), rtol=2e-5,
                                   atol=e_atol)
        # the tallies add up to the energy (the bar of tests/test_tiled.py)
        want = float(got.e_lj + got.e_coul + got.e_bonded + got.e_kspace
                     - teng.e_corr)
        np.testing.assert_allclose(float(HA), want, rtol=1e-3)
