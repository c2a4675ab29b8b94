"""The port CLI's titrate and calibrate commands on the CPU.

Each test first runs the port's command for real, at a few steps, on the
n_side 3 acid of tests/test_cli.py:11: the JAX CLI's keys
(constant_ph_tpu/cli.py: cmd_titrate, _titrate_metad, cmd_calibrate),
finite values, fractions in [0, 1] and the JAX package's
Henderson–Hasselbalch reference; a 400-step metadynamics calibration
refuses with the named never-crossed error, as
tests/test_cli.py::test_cli_calibrate_metad_refuses_undersampled asks of
the JAX CLI.

The metad titration and both calibrations then hold the command's own
code against the JAX CLI's: both CLIs run one config on a 3-site
polypeptide with the tiled engine's runs replaced, in both packages
alike, by recorders (``_Recorder``). A recorded run advances the step,
and a metad run deposits one well-tempered hill per site through its
package's own ``metad.deposit`` at a λ that is a plain function of (pH,
step), so each chunk leaves other tables. The recorders must see the
same calls in both (FIRE's steps, the equilibration, the chunk of
50 · rebuild_every steps, the MetadParams with stride round(50 / dt), the
step of the state each call gets), and the printed JSON must agree: the
per-site fractions averaged over the second half of the chunks,
deprotonated_fraction = site 0, dG_ref and its profile. What runs
underneath is held against JAX elsewhere (calibrate_dG_ref_tiled in
test_torch_titration.py, deposit and deprotonated_fraction in
test_torch_metad.py, the tiled engine in the engine tests); a whole JAX
CLI command compiles the tiled engine two or three times, 100–160 s of
CPU a command. The replica-exchange titration is held to its keys only:
its swap uniforms come from a torch.Generator, JAX's from PRNGKeys.
"""
import contextlib
import dataclasses
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from constant_ph_tpu import cli as jcli
from constant_ph_tpu import metad as jmetad
from constant_ph_tpu import titration as jtitration
from constant_ph_tpu.observables import hh_curve
from constant_ph_tpu.tiled import engine as jengine
from constant_ph_tpu_torch import cli as tcli
from constant_ph_tpu_torch import metad as tmetad
from constant_ph_tpu_torch import titration as ttitration
from constant_ph_tpu_torch.tiled import engine as tengine

torch.set_num_threads(1)

ACID = dict(builder="solvated_acid", n_side=3, pH=5.0, pK=4.25, cutoff=4.5,
            coul_style="dsf", alpha=0.2, rigid_water=True)
POLY = dict(builder="solvated_polypeptide", n_residues=6, sites_every=2,
            box_len=24.0, water_spacing=3.4, cutoff=6.0, skin=1.5,
            coul_style="dsf", alpha=0.2, pH=5.0, seed=3)
ENGINE = dict(dt=1.0, thermostat="langevin", T=300.0, gamma=0.01,
              lambda_thermostat="langevin", rebuild_every=5)
METAD = dict(nbins=61, sigma=0.05, h0=0.5, gamma=8.0)
FIRE_MARK = 1000         # a recorded FIRE adds this to the state's step


def _run(main, path, argv, extra=()):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main([argv[0], path] + list(extra) + argv[1:])
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _write(tmp_path, name, **cfg):
    path = str(tmp_path / f"{name}.json")
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    return path


def _port(tmp_path, argv, engine=ENGINE, **cfg):
    """The port's command, run for real on the acid."""
    path = _write(tmp_path, "port", system=ACID, engine=engine, **cfg)
    return _run(tcli.main, path, argv, ["--device", "cpu"])


def _check_fractions(out, pHs):
    assert out["pH"] == pHs
    frac = np.asarray(out["deprotonated_fraction"])
    assert frac.shape == (len(pHs),) and np.all((frac >= 0) & (frac <= 1))
    np.testing.assert_allclose(out["hh_reference"],
                               np.asarray(hh_curve(4.25, np.asarray(pHs))),
                               rtol=1e-6)


def _hill_lam(pH, step, n_sites, chunk, ar):
    """Where a recorded metad chunk puts each site's hill: a plain
    function of the walker's pH and of how many chunks it has run."""
    c = (step - FIRE_MARK) // chunk
    return 0.2 + 0.1 * (pH - 4.0) + 0.05 * c + 0.3 * ar(n_sites)


class _Recorder:
    """Stands in for both packages' TiledEngine.make_minimize and
    make_run and their titration calibrators, recording each call."""

    def __init__(self, monkeypatch):
        self.calls = {"jax": [], "port": []}
        rec = self

        def mp_fields(mp):
            return None if mp is None else dataclasses.asdict(mp)

        def jax_minimize(eng, n_steps, **kw):
            rec.calls["jax"].append(("minimize", n_steps, kw))
            return lambda st: (st.replace(step=st.step + FIRE_MARK),
                               jnp.zeros((0,), jnp.float32))

        def port_minimize(eng, n_steps, **kw):
            rec.calls["port"].append(("minimize", n_steps, kw))

            def fire(st):
                return (dataclasses.replace(
                    st, step=st.step + FIRE_MARK,
                    step_host=st.step_host + FIRE_MARK),
                    torch.zeros(0))
            return fire

        def jax_make_run(eng, n_steps, detailed_flags=False):
            rec.calls["jax"].append(("run", n_steps, mp_fields(eng.metad)))

            def run(st):
                if eng.metad is not None:
                    S = st.metad_v.shape[0]
                    lam = _hill_lam(st.pH, st.step, S, n_steps, jnp.arange)
                    V, dV = jmetad.deposit(st.metad_v, st.metad_dv,
                                           lam.astype(jnp.float32),
                                           eng.metad)
                    st = st.replace(metad_v=V, metad_dv=dV)
                return (st.replace(step=st.step + n_steps),
                        jnp.zeros((), bool), None)
            return run

        def port_make_run(eng, n_steps, detailed_flags=False):
            rec.calls["port"].append(("run", n_steps, mp_fields(eng.metad)))

            def run(st, generators=None):
                if eng.metad is not None:
                    # the walkers come as one batch (R leading), with one
                    # generator each: the call JAX's recorder sees under
                    # jax.vmap, each walker's hill as JAX's
                    R = st.pH.shape[0]
                    assert st.wx.ndim == 4 and len(generators) == R
                    S = st.metad_v.shape[-2]
                    lam = _hill_lam(st.pH[:, None], st.step[:, None], S,
                                    n_steps, torch.arange)
                    V, dV = tmetad.deposit(st.metad_v, st.metad_dv,
                                           lam.to(torch.float32), eng.metad)
                    st = dataclasses.replace(st, metad_v=V, metad_dv=dV)
                st = dataclasses.replace(st, step=st.step + n_steps,
                                         step_host=st.step_host + n_steps)
                flag = torch.zeros(st.step.shape, dtype=torch.bool)
                return st, flag, None
            return run

        def calibrators(tag):
            def ti(tsys, tstate, cfg, *, return_profile=False, **kw):
                kw["kspace_ep"] = kw.get("kspace_ep") is not None
                kw["bias"] = dataclasses.asdict(kw["bias"])
                rec.calls[tag].append(("ti", int(tstate.step),
                                       return_profile, kw))
                prof = np.linspace(4.6, -18.1, 7) + 1e-3 * kw["sample_steps"]
                return -6.2 + 1e-3 * kw["equil_steps"], (
                    np.asarray(jtitration._GL_X), prof)

            def metad(tsys, tstate, cfg, *, metad_params=None, **kw):
                kw["kspace_ep"] = kw.get("kspace_ep") is not None
                kw["bias"] = dataclasses.asdict(kw["bias"])
                rec.calls[tag].append(("metad", int(tstate.step),
                                       mp_fields(metad_params), kw))
                return np.array([-6.1, -5.9, -6.0]) + 1e-4 * kw["n_steps"]
            return ti, metad

        for tag, eng_mod, tit_mod, minimize, make_run in (
                ("jax", jengine, jtitration, jax_minimize, jax_make_run),
                ("port", tengine, ttitration, port_minimize,
                 port_make_run)):
            monkeypatch.setattr(eng_mod.TiledEngine, "make_minimize",
                                minimize)
            monkeypatch.setattr(eng_mod.TiledEngine, "make_run", make_run)
            ti, metad = calibrators(tag)
            monkeypatch.setattr(tit_mod, "calibrate_dG_ref_tiled", ti)
            monkeypatch.setattr(tit_mod, "calibrate_dG_ref_metad", metad)

    def both(self, tmp_path, argv, **cfg):
        """The JAX and the port CLI on one config: (JAX's JSON, port's)."""
        path = _write(tmp_path, "both", system=POLY, **cfg)
        return (_run(jcli.main, path, argv),
                _run(tcli.main, path, argv, ["--device", "cpu"]))


def test_titrate_rex(tmp_path):
    out = _port(tmp_path, ["titrate", "--ph", "4.0,5.0"],
                run=dict(tiled=False, steps_per_swap=5, n_swaps=2))
    assert set(out) == {"pH", "deprotonated_fraction", "hh_reference",
                        "swap_acceptance"}
    _check_fractions(out, [4.0, 5.0])
    assert 0.0 <= out["swap_acceptance"] <= 1.0


def test_titrate_metad(tmp_path, monkeypatch):
    # chunks of 50 · rebuild_every steps: one chunk of 100 a walker
    out = _port(tmp_path, ["titrate", "--ph", "3.0,6.0", "--method", "metad"],
                engine=dict(ENGINE, rebuild_every=2),
                run=dict(steps=150, minimize_steps=20), metad=METAD)
    assert set(out) == {"method", "pH", "deprotonated_fraction", "per_site",
                        "hh_reference", "steps"}
    assert out["method"] == "metad" and out["steps"] == 100
    _check_fractions(out, [3.0, 6.0])
    per_site = np.asarray(out["per_site"])
    assert per_site.shape == (2, 1) and np.isfinite(per_site).all()

    # against the JAX CLI: 5 chunks of 50 steps (dt 2 fs: stride 25), the
    # tail being chunks 2-4; 3 sites, so site 0 is picked out of 3
    rec = _Recorder(monkeypatch)
    jout, tout = rec.both(
        tmp_path, ["titrate", "--ph", "3.0,4.5,6.0", "--method", "metad"],
        engine=dict(ENGINE, dt=2.0, rebuild_every=1),
        run=dict(steps=260, minimize_steps=30), metad=METAD)
    assert rec.calls["port"] == rec.calls["jax"]
    assert [c[:2] for c in rec.calls["jax"]] == [("minimize", 30),
                                                 ("run", 50)]
    assert rec.calls["jax"][1][2]["stride"] == 25
    assert set(tout) == set(jout) and tout["steps"] == jout["steps"] == 250
    for k in ("method", "pH", "hh_reference"):
        assert tout[k] == jout[k], k
    jps, tps = np.asarray(jout["per_site"]), np.asarray(tout["per_site"])
    assert jps.shape == tps.shape == (3, 3)
    np.testing.assert_allclose(tps, jps, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tout["deprotonated_fraction"], tps[:, 0])
    # the tables differ chunk to chunk and site to site, so another tail
    # window or site index would not agree
    assert np.ptp(jps, axis=1).min() > 1e-3


def test_calibrate_ti(tmp_path, monkeypatch):
    out = _port(tmp_path, ["calibrate", "--equil", "10", "--window-equil",
                           "5", "--samples", "10"], run={})
    assert set(out) == {"dG_ref", "lambda_nodes", "dUdlam_profile"}
    assert len(out["lambda_nodes"]) == len(out["dUdlam_profile"]) == 7
    assert np.isfinite(out["dG_ref"])
    assert np.isfinite(out["dUdlam_profile"]).all()

    # against the JAX CLI, TI and metad: FIRE's 300 steps, then the
    # equilibration, then the calibrator on the state they leave
    rec = _Recorder(monkeypatch)
    argv = ["calibrate", "--equil", "40", "--window-equil", "7",
            "--samples", "90"]
    engine = dict(ENGINE, dt=0.5)
    jout, tout = rec.both(tmp_path, argv, engine=engine, run={})
    assert rec.calls["port"] == rec.calls["jax"]
    assert [c[:2] for c in rec.calls["jax"]] == [
        ("minimize", 300), ("run", 40), ("ti", FIRE_MARK + 40)]
    assert rec.calls["jax"][2][2] is True
    assert {k: rec.calls["jax"][2][3][k] for k in (
        "equil_steps", "sample_steps", "kspace_ep")} == dict(
        equil_steps=7, sample_steps=90, kspace_ep=False)
    assert tout == jout
    rec.calls = {"jax": [], "port": []}
    jout, tout = rec.both(tmp_path, argv + ["--method", "metad"],
                          engine=engine, run={}, metad=METAD)
    assert rec.calls["port"] == rec.calls["jax"]
    assert rec.calls["jax"][2][:2] == ("metad", FIRE_MARK + 40)
    assert rec.calls["jax"][2][2]["stride"] == 100
    assert rec.calls["jax"][2][3]["n_steps"] == 90
    assert tout == jout and tout["method"] == "metad"


def test_calibrate_metad_refuses_undersampled(tmp_path):
    with pytest.raises(RuntimeError, match="never crossed"):
        _port(tmp_path, ["calibrate", "--equil", "20", "--samples", "400",
                         "--method", "metad"], run={})
