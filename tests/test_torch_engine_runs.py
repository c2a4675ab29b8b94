"""The port's TiledEngine Langevin and NHC runs and its FIRE minimisation on
the box of tests/test_torch_engine.py, and EngineConfig's refusal of odd
lambda_inner (split from test_torch_engine.py and
test_torch_numerics.py so that no port test file collects more than
five tests).
"""
import pytest
import torch
from constant_ph_tpu_torch.engine import EngineConfig
from constant_ph_tpu_torch.tiled.engine import TiledEngine

from test_torch_engine import (  # noqa: F401  (fixtures and helpers)
    case,
)

# the suite runs six xdist workers on the same cores: one torch thread
# each keeps the port tests from oversubscribing them
torch.set_num_threads(1)


@pytest.mark.parametrize("thermostat", ["langevin", "nhc"])
def test_thermostatted_run_finite_and_thermal(case, thermostat):
    _, _, tts, tst = case
    cfg = EngineConfig(dt=1.0, thermostat=thermostat, gamma=0.01,
                       lambda_thermostat=thermostat, rebuild_every=4, seed=3)
    eng = TiledEngine(tts, cfg)
    st, ov, obs = eng.make_run(8)(tst)
    assert not bool(ov)
    for v in (obs.e_pot, obs.temp, obs.h_conserved, obs.lam, st.wx):
        assert torch.isfinite(v).all()
    assert 240.0 < float(obs.temp.min()) and float(obs.temp.max()) < 360.0
    assert -0.5 <= float(obs.lam.min()) and float(obs.lam.max()) <= 1.5
    # the engine's generator is seeded from the config: same seed, same run;
    # detailed_flags splits the overflow flag into (capacity, drift)
    st_b, (ov_cap, ov_drift), obs_b = TiledEngine(tts, cfg).make_run(
        8, detailed_flags=True)(tst)
    assert torch.equal(obs.temp, obs_b.temp)
    assert not bool(ov_cap) and not bool(ov_drift)


def test_minimize_lowers_energy(case):
    _, _, tts, tst = case
    eng = TiledEngine(tts, EngineConfig(dt=0.5, force_cap=50.0,
                                        rebuild_every=4))
    e0 = float(eng.compute_forces(tst).e_pot)
    st, e_hist = eng.make_minimize(8)(tst)
    assert e_hist.shape == (2,)
    assert float(e_hist[-1]) < e0
    assert float(torch.abs(st.wv).max()) == 0.0
    # no steps: no move, an empty history (JAX's scan of length 0) and the
    # velocities zeroed, as titrate --method metad asks with minimize_steps 0
    st, e_hist = eng.make_minimize(0)(tst)
    assert e_hist.shape == (0,)
    assert torch.equal(st.wx, tst.wx)
    assert float(torch.abs(st.wv).max()) == 0.0


def test_engine_config_rejects_odd_lambda_inner():
    with pytest.raises(ValueError, match="lambda_inner"):
        EngineConfig(lambda_inner=3)
    assert EngineConfig(lambda_inner=1).lambda_inner == 1
    assert EngineConfig(lambda_inner=8).lambda_inner == 8
