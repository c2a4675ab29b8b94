"""Parity of the port's CLI (constant_ph_tpu_torch/cli.py) with the JAX
package's (constant_ph_tpu/cli.py), on the n_side 3 acid of
tests/test_cli.py:11.

- The helpers: _build_system, _apply_dg_ref (scalar and per pK class),
  _make_engines and _resolve_kspace give the JAX package's System
  fields, EngineConfig, BiasParams, EwaldParams and PMEParams.
- One tiled `run` (NVE, λ thermostat "none", no minimisation, so JAX
  compiles the run alone) through both CLIs from one deck the JAX writer
  wrote from that acid, so both start from the same state (the builders
  draw their velocities from different generators). The summaries, the
  JSONL rows and the checkpoints agree at the tolerances of
  tests/test_torch_engine.py::test_nve_trajectory_follows_jax (positions
  1e-4 Å, velocities 2e-5 Å/fs, λ 1e-6, h_conserved rtol 2e-6;
  energies rtol 1e-5 + atol 1e-4 as test_compute_forces_matches). This
  is the file's one JAX compile.
- The reference engine's `run` with an Ewald kspace includes the
  reciprocal space (the JAX CLI drops it: ROADMAP Queue 3).
- The refusals, with the JAX CLI's messages where it has them.
"""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

from constant_ph_tpu import cli as jcli
from constant_ph_tpu.systems.lammps_data import (write_lammps_data,
                                                 write_sites_json)
from constant_ph_tpu.systems.water import solvated_acid
from constant_ph_tpu_torch import cli as tcli
from constant_ph_tpu_torch.ops.ewald import make_kspace_fn

torch.set_num_threads(1)

ACID = dict(builder="solvated_acid", n_side=3, pH=5.0, pK=4.25, cutoff=4.5,
            coul_style="dsf", alpha=0.2, rigid_water=True)
NVE = dict(dt=1.0, thermostat="nve", lambda_thermostat="none",
           rebuild_every=5)


def write_cfg(tmp_path, name, **cfg):
    path = str(tmp_path / f"{name}.json")
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    return path


def run_cli(main, argv):
    """The last stdout line of a CLI command, parsed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def assert_fields_equal(jobj, tobj):
    """Every field of a JAX config/params dataclass equals the port's."""
    import dataclasses

    for f in dataclasses.fields(jobj):
        a, b = getattr(jobj, f.name), getattr(tobj, f.name)
        if isinstance(b, torch.Tensor):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f.name)
        else:
            assert a == b, f.name


def test_helpers_match_jax(tmp_path):
    cfg = dict(system=ACID, engine=dict(NVE, gamma=0.02, kspace_every=2),
               bias=dict(w=150.0, switch_slope=40.0),
               kspace=dict(style="ewald", alpha=0.3, accuracy=1e-5))
    jsys = jcli._build_system(dict(ACID))
    tsys = tcli._build_system(dict(ACID), device="cpu")
    np.testing.assert_array_equal(tsys.state.x.numpy(),
                                  np.asarray(jsys.state.x))
    np.testing.assert_array_equal(tsys.spec.dq.numpy(),
                                  np.asarray(jsys.spec.dq))
    # ΔG_ref: a scalar, and a base with per-pK-class offsets
    for dg in (-39.37, {"base": -39.0, "class_offsets": {"4.25": 0.5}}):
        js = jcli._apply_dg_ref(dict(cfg, dg_ref=dg), jsys).spec
        ts = tcli._apply_dg_ref(dict(cfg, dg_ref=dg), tsys).spec
        np.testing.assert_array_equal(ts.dG_ref.numpy(),
                                      np.asarray(js.dG_ref))
    jecfg, jbias, jep = jcli._make_engines(cfg, jsys)
    tecfg, tbias, tep = tcli._make_engines(cfg, tsys)
    assert_fields_equal(jecfg, tecfg)
    assert_fields_equal(jbias, tbias)
    assert_fields_equal(jep, tep)
    # PME is deferred to the tile grid, then made the same way
    from constant_ph_tpu.tiled.layout import split_system as jsplit
    from constant_ph_tpu_torch.tiled.layout import split_system as tsplit

    cfg["kspace"] = dict(style="pme", alpha=0.3, spacing=1.2, p=4)
    jk = jcli._make_engines(cfg, jsys)[2]
    tk = tcli._make_engines(cfg, tsys)[2]
    assert jk == tk == ("pme", cfg["kspace"])
    jpp = jcli._resolve_kspace(jk, jsys.state.box, jsplit(jsys))
    tpp = tcli._resolve_kspace(tk, tsys.state.box,
                               tsplit(tsys, device="cpu"))
    assert_fields_equal(jpp, tpp)


def test_tiled_run_follows_jax(tmp_path):
    src = solvated_acid(**{k: v for k, v in ACID.items() if k != "builder"})
    deck, sidecar = str(tmp_path / "acid.data"), str(tmp_path / "acid.json")
    write_lammps_data(deck, src)
    write_sites_json(sidecar, src)
    system = dict(builder="lammps_data", path=deck, sites_json=sidecar,
                  rigid_water_types=[5, 6], cutoff=4.5, coul_style="dsf",
                  alpha=0.2, pH=5.0)
    out = {}
    for tag, main, extra in (("jax", jcli.main, []),
                             ("port", tcli.main, ["--device", "cpu"])):
        run = dict(steps=10, minimize_steps=0, observe_every=5, tiled=True,
                   checkpoint=str(tmp_path / f"{tag}.npz"),
                   output=str(tmp_path / f"{tag}.jsonl"))
        p = write_cfg(tmp_path, tag, system=system, engine=NVE, run=run)
        summary = run_cli(main, ["run", p] + extra)
        with open(run["output"]) as fh:
            rows = [json.loads(line) for line in fh]
        with np.load(run["checkpoint"]) as ck:
            leaves = {k: ck[k] for k in ck.files}
        out[tag] = summary, rows, leaves
    (js, jrows, jck), (ts, trows, tck) = out["jax"], out["port"]
    assert set(ts) == set(js) and ts["steps"] == js["steps"] == 10
    np.testing.assert_allclose(ts["e_pot"], js["e_pot"], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(ts["temp"], js["temp"], rtol=2e-6)
    np.testing.assert_allclose(ts["lambda_final"], js["lambda_final"],
                               atol=1e-6)
    assert ts["protonation_fraction"] == js["protonation_fraction"]
    assert len(trows) == len(jrows) == 2
    for a, b in zip(jrows, trows):
        assert set(a) == set(b) and a["step"] == b["step"]
        np.testing.assert_allclose(b["h_conserved"], a["h_conserved"],
                                   rtol=2e-6)
        for k in ("e_pot", "e_lj", "e_coul", "e_bonded", "e_site"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-4,
                                       err_msg=k)
        np.testing.assert_allclose(b["lam"], a["lam"], atol=1e-6)
    # the port's checkpoint adds the generator state to the JAX leaves
    assert set(tck) == set(jck) | {"torch_generator"}
    np.testing.assert_allclose(tck["x"], jck["x"], atol=1e-4)
    np.testing.assert_allclose(tck["v"], jck["v"], atol=2e-5)
    for k in ("step", "lam", "box", "pH"):
        np.testing.assert_allclose(tck[k], jck[k], atol=1e-6, err_msg=k)


def test_reference_run_includes_ewald(tmp_path):
    """The non-tiled run with kspace style ewald: its first energy is the
    reference Engine's with make_kspace_fn, and differs from real space
    alone by the reciprocal energy."""
    acid = dict(ACID, coul_style="cut", alpha=0.3)
    ks = dict(style="ewald", alpha=0.3, accuracy=1e-5)
    out = str(tmp_path / "obs.jsonl")
    p = write_cfg(tmp_path, "ewald", system=acid, engine=NVE, kspace=ks,
                  run=dict(steps=5, minimize_steps=0, observe_every=1,
                           tiled=False, output=out))
    summary = run_cli(tcli.main, ["run", p, "--device", "cpu"])
    with open(out) as fh:
        row = json.loads(fh.readline())
    cfg = dict(system=acid, engine=NVE, kspace=ks)
    system = tcli._build_system(dict(acid), device="cpu")
    ecfg, _, ep = tcli._make_engines(cfg, system)
    gen = torch.Generator().manual_seed(ecfg.seed)
    ref = system.make_engine(ecfg, kspace_fn=make_kspace_fn(ep)).run(
        system.state, 5, generator=gen)[2]
    bare = system.make_engine(ecfg).run(system.state, 5)[2]
    assert row["e_pot"] == float(ref.e_pot[0])
    assert row["e_kspace"] == float(ref.e_kspace[0]) != 0.0
    assert abs(row["e_pot"] - float(bare.e_pot[0])) > 1e-3
    assert summary["e_pot"] == float(ref.e_pot[-1])


def test_refusals(tmp_path):
    run = dict(steps=10, minimize_steps=0, observe_every=5)
    pme = dict(style="pme", alpha=0.3, spacing=1.5, p=4)
    ewald = dict(style="ewald", alpha=0.3)
    cases = (
        # PME on the reference engine
        (SystemExit, dict(kspace=pme, run=dict(run, tiled=False))),
        # NPT with baked-box Ewald
        (ValueError, dict(kspace=ewald, run=dict(run, tiled=True,
                                                 pressure=1.0))),
    )
    for i, (exc, extra) in enumerate(cases):
        p = write_cfg(tmp_path, f"bad{i}", system=ACID, engine=NVE, **extra)
        with pytest.raises(exc) as want:
            jcli.main(["run", p])
        with pytest.raises(exc) as got:
            tcli.main(["run", p, "--device", "cpu"])
        assert str(got.value) == str(want.value)
    # the port's own: NPT on the reference engine, and CUDA without CUDA
    p = write_cfg(tmp_path, "npt_ref", system=ACID, engine=NVE,
                  run=dict(run, tiled=False, pressure=1.0))
    with pytest.raises(SystemExit, match="requires the tiled engine"):
        tcli.main(["run", p, "--device", "cpu"])
    if not torch.cuda.is_available():
        p = write_cfg(tmp_path, "ok", system=ACID, engine=NVE, run=run)
        for argv in (["run", p], ["titrate", p, "--ph", "4"],
                     ["calibrate", p]):
            with pytest.raises(RuntimeError, match="is_available"):
                tcli.main(argv)
