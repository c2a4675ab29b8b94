"""Parity of the PyTorch port's TiledEngine with the JAX package on the
dilute grid-4³ box (tile_safety 0.2, W = 20), plus the port's own guards.

- compute_forces: forces, φ, dU/dλ and f_λ against JAX, each scaled by
  max(1, |ref|max) within 3e-6, and energies within rtol 1e-5 / atol
  1e-4 kcal/mol (the tolerances tests/test_pallas_ww.py holds between the
  JAX package's two water-water paths; e_coul and e_site are float32 sums
  of large ± terms).
- A 2-block × 4-step NVE trajectory (thermostat "nve", λ thermostat
  "none", λ-RESPA on) from the same JAX-built state. The tolerances come
  from the float32 divergence measured on the CPU between the two
  packages over these 8 steps: positions 1.1e-5 Å, velocities 1.8e-6 Å/fs,
  λ 0 (equal), h_conserved 2e-4 of 906 kcal/mol. They are set at ~10×
  those: 1e-4 Å, 2e-5 Å/fs, 1e-6, and rtol 2e-6 on h_conserved.
- Langevin (atoms + λ) and NHC runs stay finite and in a temperature band
  (the two packages draw different random numbers, so no trajectory
  parity for Langevin).
"""
import ast
import os

import numpy as np
import jax
import pytest
import torch

from constant_ph_tpu.engine import EngineConfig as JConfig
from constant_ph_tpu.tiled.engine import TiledEngine as JEngine
from constant_ph_tpu_torch import metad, titration
from constant_ph_tpu_torch.engine import EngineConfig
from constant_ph_tpu_torch.parallel import replica
from constant_ph_tpu_torch.tiled.engine import TiledEngine

from test_torch_layout import jax_tiled, port_of

# the suite runs six xdist workers on the same cores: one torch thread
# each keeps the port tests from oversubscribing them
torch.set_num_threads(1)

NVE = dict(dt=1.0, thermostat="nve", lambda_thermostat="none",
           rebuild_every=4)


@pytest.fixture(scope="module")
def case():
    _, jts, jst = jax_tiled("dsf", 0.2)
    tts, tst = port_of(jts, jst)
    return jts, jst, tts, tst


def test_compute_forces_matches(case):
    jts, jst, tts, tst = case
    ref = jax.jit(JEngine(jts, JConfig(**NVE)).compute_forces)(jst)
    got = TiledEngine(tts, EngineConfig(**NVE)).compute_forces(tst)
    for name in ("fw", "fs", "f_lam", "phi_s", "dUdlam"):
        a = np.asarray(getattr(ref, name))
        scale = max(1.0, np.abs(a).max())
        np.testing.assert_allclose(getattr(got, name).numpy() / scale,
                                   a / scale, atol=3e-6, err_msg=name)
    for name in ("e_lj", "e_coul", "e_bonded", "e_site", "e_pot"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(ref, name)), rtol=1e-5,
                                   atol=1e-4, err_msg=name)


def test_nve_trajectory_follows_jax(case):
    jts, jst, tts, tst = case
    jst2, jov, jobs = jax.jit(JEngine(jts, JConfig(**NVE)).make_run(8))(jst)
    tst2, tov, tobs = TiledEngine(tts, EngineConfig(**NVE)).make_run(8)(tst)
    assert bool(tov) == bool(jov) is False
    np.testing.assert_array_equal(tst2.wid.numpy(), np.asarray(jst2.wid))
    np.testing.assert_allclose(tst2.wx.numpy(), np.asarray(jst2.wx),
                               atol=1e-4)
    np.testing.assert_allclose(tst2.sx.numpy(), np.asarray(jst2.sx),
                               atol=1e-4)
    np.testing.assert_allclose(tst2.wv.numpy(), np.asarray(jst2.wv),
                               atol=2e-5)
    np.testing.assert_allclose(tobs.lam.numpy(), np.asarray(jobs.lam),
                               atol=1e-6)
    np.testing.assert_allclose(tobs.h_conserved.numpy(),
                               np.asarray(jobs.h_conserved), rtol=2e-6)
    assert int(tst2.step) == 8


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


def test_unported_paths_raise(case):
    _, _, tts, _ = case
    # factorized-Ewald k-space (anything but PMEParams) waits for the
    # reference-engine slice; a live box needs PME in any case
    with pytest.raises(NotImplementedError, match="factorized-Ewald"):
        TiledEngine(tts, kspace_ep=object())
    with pytest.raises(ValueError, match="kspace_live_box requires PME"):
        TiledEngine(tts, EngineConfig(kspace_live_box=True),
                    kspace_ep=object())
    # the cross-device hill merges wait for the multi-GPU slice, and
    # replica exchange / TI on the reference engine for its slice
    for merge in (metad.make_mesh_walker_merge, metad.make_mesh_group_merge):
        with pytest.raises(NotImplementedError, match="item 12"):
            merge(None, "walk", metad.MetadParams())
    with pytest.raises(NotImplementedError, match="item 10"):
        replica.make_rex_runner(None, 4)
    with pytest.raises(NotImplementedError, match="item 10"):
        titration.calibrate_dG_ref(None, EngineConfig())
    with pytest.raises(ValueError, match="kspace_every"):
        TiledEngine(tts, EngineConfig(kspace_every=0))


def _imported_modules(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = [os.path.join(root, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(root, "constant_ph_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert len(paths) > 15
    banned = {"jax", "jaxlib", "flax", "constant_ph_tpu"}
    for path in paths:
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in banned, f"{path} imports {mod}"
