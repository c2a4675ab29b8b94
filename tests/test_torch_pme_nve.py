"""A 2-block × 4-step NVE trajectory of the PyTorch port's tiled engine
at kspace_every = 2 (PME impulse MTS; thermostat "nve", λ thermostat
"none") following the JAX package's, from the same JAX-built state: the
dilute grid-4³ box of test_torch_pme.py ('cut' α 0.35, 40³ mesh).

Tolerances: positions within 1e-4 Å, velocities 2e-5 Å/fs, λ 1e-6,
h_conserved − e_kspace rtol 2e-6 (the bars of
test_torch_engine.py::test_nve_trajectory_follows_jax); e_kspace within
rtol 2e-5 plus the self-term atol of test_torch_pme.py, and non-zero on
exactly the h_valid rows; the carried phi_recip_s within 2.5e-4 of its
max (the bar of the PME compute_forces test there).
"""
import jax
import numpy as np
import pytest
import torch

from constant_ph_tpu.engine import EngineConfig as JConfig
from constant_ph_tpu.tiled.engine import TiledEngine as JEngine
from constant_ph_tpu_torch.engine import EngineConfig
from constant_ph_tpu_torch.tiled.engine import TiledEngine

from test_torch_pme import NVE, _e_atol, _scaled_close, build_case

# one torch thread per xdist worker, as the other port tests
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case():
    return build_case()


def test_pme_nve_trajectory_follows_jax(case):
    jts, jst, tts, tst, jpp, tpp = case
    cfg = dict(NVE, kspace_every=2)
    jst2, jov, jobs = jax.jit(JEngine(jts, JConfig(**cfg),
                                      kspace_ep=jpp).make_run(8))(jst)
    teng = TiledEngine(tts, EngineConfig(**cfg), kspace_ep=tpp)
    tst2, tov, tobs = teng.make_run(8)(tst)
    assert bool(tov) == bool(jov) is False
    np.testing.assert_allclose(tst2.wx.numpy(), np.asarray(jst2.wx),
                               atol=1e-4)
    np.testing.assert_allclose(tst2.sx.numpy(), np.asarray(jst2.sx),
                               atol=1e-4)
    np.testing.assert_allclose(tst2.wv.numpy(), np.asarray(jst2.wv),
                               atol=2e-5)
    np.testing.assert_allclose(tobs.lam.numpy(), np.asarray(jobs.lam),
                               atol=1e-6)
    np.testing.assert_allclose(
        (tobs.h_conserved - tobs.e_kspace).numpy(),
        np.asarray(jobs.h_conserved - jobs.e_kspace), rtol=2e-6)
    np.testing.assert_allclose(tobs.e_kspace.numpy(),
                               np.asarray(jobs.e_kspace), rtol=2e-5,
                               atol=_e_atol(jts, jst))
    np.testing.assert_array_equal(tobs.h_valid.numpy(),
                                  np.asarray(jobs.h_valid))
    # PME ran on the boundary steps only: the even counters
    hv = tobs.h_valid.numpy()
    np.testing.assert_array_equal(hv, np.arange(1, 9) % 2 == 0)
    np.testing.assert_array_equal(tobs.e_kspace.numpy() != 0.0, hv)
    # the MTS carry persists in the state, as the JAX package keeps it
    _scaled_close(tst2.phi_recip_s.numpy(), jst2.phi_recip_s, 2.5e-4,
                  "phi_recip_s")
    assert tst2.step_host == int(tst2.step) == 8
