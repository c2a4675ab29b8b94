"""Whole runs on the CPU at a tiny size: every driver to a correct
result, the same runs with the timed path broken underneath, or the
control in the program's place, to an incorrect one, and a cell made of
files that exist only in the test, on an engine without tiles."""
import dataclasses
import json
import os
import shutil
import textwrap
import time

import pytest
import torch

from cph_bench import harness
from cph_bench.tests.small import ROOT, bench_cells, cell, cells


def _run(c, seed=2**31 + 17):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return harness.run_cell(c, seed, 0.5, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", cells())
def test_dry_run_is_correct(name):
    res, checks = _run(cell(name))
    assert res["correct"], checks
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert set(res["metrics"]) == {"ns_per_day", "peak_mem_gib", "setup_s"}
    assert list(res)[-1] == "checks"


def _frozen(monkeypatch):
    """A step that returns its state unchanged."""
    from constant_ph_tpu_torch.tiled.engine import TiledEngine

    monkeypatch.setattr(TiledEngine, "step",
                        lambda self, st, frc, generators=None: (st, frc))


def _half(monkeypatch):
    """Half of the batch left out: the second half never moves."""
    from constant_ph_tpu_torch.tiled.engine import TiledEngine

    step = TiledEngine.step

    def half(self, st, frc, generators=None):
        new, frc_new = step(self, st, frc, generators)
        R = st.wx.shape[0]
        keep = torch.arange(R) < R // 2

        def mix(a, b):
            if not isinstance(a, torch.Tensor) or a.ndim == 0:
                return a
            m = keep.reshape((R,) + (1,) * (a.ndim - 1)).to(a.device)
            return torch.where(m, a, b)

        new = dataclasses.replace(new, **{
            f.name: mix(getattr(new, f.name), getattr(st, f.name))
            for f in dataclasses.fields(new) if f.name != "step_host"})
        return new, frc_new

    monkeypatch.setattr(TiledEngine, "step", half)


def _altered(monkeypatch):
    """The water-water forces altered where they are produced: 1 % high."""
    from constant_ph_tpu_torch.tiled import forces

    ww = forces.water_water_fast

    def altered(*a, **kw):
        e_lj, e_c, f = ww(*a, **kw)
        return e_lj, e_c, f * 1.01

    monkeypatch.setattr(forces, "water_water_fast", altered)


@pytest.mark.parametrize("fault", [_frozen, _half, _altered],
                         ids=["frozen_step", "half_batch", "altered_forces"])
@pytest.mark.parametrize("name", cells())
def test_a_broken_timed_path_reads_incorrect(monkeypatch, name, fault):
    fault(monkeypatch)
    res, checks = _run(cell(name))
    assert not res["correct"], checks


TINY_DRIVER = '''
"""Plain Langevin runs of every replica at its pH on the reference
Engine (all atoms in one array, a neighbour list): no tiles, no swaps,
no bias tables."""
import dataclasses

import torch

from cph_bench import prepare


class Run:
    def __init__(self, ctx):
        from constant_ph_tpu_torch import convert
        from constant_ph_tpu_torch.parallel import replica
        from constant_ph_tpu_torch.titration import apply_dG_ref

        from cph_bench.reference.forces import topology

        # the benchmark's relaxation (on tiles), carried over in atom order
        _, tst, _ = prepare.relaxed(ctx)
        top = topology(ctx.inputs, ctx.device)
        one = type("One", (), dict(wvalid=tst.wvalid[None],
                                   wid=tst.wid[None]))
        system = convert.system(ctx.inputs, ctx.device)
        system.spec = apply_dG_ref(system.spec, ctx.config["dG_ref"])
        st = system.state
        st = dataclasses.replace(st, **{
            k: prepare.atom_order(top, one, w[None], s[None])[0].to(
                st.x.dtype)
            for k, w, s in (("x", tst.wx, tst.sx), ("v", tst.wv, tst.sv))})
        self.cfg = prepare.engine_config(ctx.config["engine"], ctx.seed)
        self.engine = system.make_engine(self.cfg)
        reps, self.gens = prepare.replicas(
            st, prepare.ladder(ctx.mix), lambda ph: st.lam.clone(),
            ctx.seed, ctx.device)
        self.batch = replica.stack_replicas(reps)
        self.nbr = self.engine.build_neighbors(self.batch.x, self.batch.box)
        self.R = len(reps)
        self.steps_per_block = ctx.mix["steps_per_block"]
        self.dt_fs = self.cfg.dt
        self.run = self.engine.make_run(self.steps_per_block)
        self.reset()

    def reset(self):
        self.blocks, self.failed = 0, torch.zeros(self.R, dtype=torch.int32)

    def block(self):
        self.batch, self.nbr, obs = self.run(self.batch, self.nbr, self.gens)
        self.obs_last = dataclasses.replace(obs, **{
            f.name: getattr(obs, f.name)[:, -1]
            for f in dataclasses.fields(obs)})
        self.failed += prepare.failed_mask(
            self.batch, torch.zeros(self.R, dtype=torch.bool))
        self.blocks += 1

    def health(self):
        return self.R * self.blocks, int(self.failed.sum())

    def judged(self):
        eng, st, cfg = self.engine, self.batch, self.cfg
        with torch.no_grad():
            frc = eng.compute_forces(st.x, st.lam, st.box, st.pH, self.nbr)
            st1, _ = eng.step(st, frc, self.nbr, self.gens)

        def d(t):
            return t.to(torch.float64)

        return dict(x=d(st.x), v=d(st.v), box=d(st.box), lam=d(st.lam),
                    pH=d(st.pH), f=d(frc.f), f_lam=d(frc.f_lam),
                    e_pot=d(self.obs_last.e_pot),
                    e_has_kspace=self.obs_last.h_valid, obs_pH=d(st.pH),
                    x1=d(st1.x), kspace_factor=1,
                    step=dict(dt=cfg.dt, gamma=cfg.gamma, T=cfg.T),
                    metad=None)


def make(ctx):
    return Run(ctx)
'''


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A configuration, a mix and a driver that exist only here, found by
    their names in a BENCHMARK.json of their own; the driver runs the
    reference Engine, which has no tiles, and the run is judged as the
    benchmark's cells are."""
    base = cell(bench_cells()[0])
    root = tmp_path
    for sub in ("configs", "traffic", "drivers"):
        (root / "cph_bench" / sub).mkdir(parents=True)
    cfg = dict(base.config, builder=dict(base.config["builder"]))
    cfg["builder"]["params"] = dict(cfg["builder"]["params"], n_residues=6)
    # the reference Engine checks its list every rebuild_every steps; the
    # tiny box runs hot after its short relaxation
    cfg["engine"] = dict(cfg["engine"], rebuild_every=4)
    cfg["limits"] = {k: v for k, v in cfg["limits"].items()
                     if k != "table_gap"}
    (root / "cph_bench" / "configs" / "pep6.json").write_text(
        json.dumps(cfg))
    (root / "cph_bench" / "traffic" / "plain_r2.json").write_text(json.dumps(
        dict(driver="plain_runs", phs=[4.0, 7.0], walkers_per_ph=1,
             steps_per_block=12, warm_blocks=1, trace_blocks=2)))
    (root / "cph_bench" / "drivers" / "plain_runs.py").write_text(
        textwrap.dedent(TINY_DRIVER))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["configs"] = [dict(bench["configs"][0], name="pep6",
                             file="cph_bench/configs/pep6.json")]
    bench["workloads"] = [dict(name="pep6.plain_r2", config="pep6",
                               traffic="plain_r2", chips=1, why="a test")]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(os.path.join(ROOT, "cph_bench", "layers"),
                    root / "cph_bench" / "layers")
    c = harness.load_cell(str(root), "pep6.plain_r2")
    res, checks = _run(c)
    assert res["correct"], checks
    assert res["attempted"] >= 2
    assert {n for n, _, _ in checks} >= {"force_gap", "step_noise_dev"}


def test_a_traced_run_reads_the_per_layer_metrics_it_can(monkeypatch):
    """The traced window on the CPU: the device readers find no device
    operation and return nothing; relax_s comes from the host clock."""
    c = cell("acid_pme_tiny.rex_r16", trace_blocks=1)
    res, checks = harness.run_cell(c, 5, 0.5, True, "cpu",
                                   time.perf_counter())
    assert res["correct"], checks
    assert set(res["metrics"]) == {"relax_s"}
    assert res["device"]["window_s"] > 0 and "breakdown" in res


@pytest.mark.parametrize("name", bench_cells())
def test_one_run_on_the_card(name):
    """On the card only: the command's last line is the result, with the
    cell's end-to-end metrics and its checks last."""
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "cph_bench", "run.py"),
         "--workload", name, "--seed", str(2**31 + 99), "--seconds", "5",
         "--trace", "0"], capture_output=True, text=True, timeout=600,
        cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"ns_per_day", "peak_mem_gib", "setup_s"}
    assert list(res)[-1] == "checks"
    assert p.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("name", cells())
def test_the_control_reads_incorrect_where_the_program_reads_correct(name):
    """The control (the reference in TF32 in the program's place) through
    the run's own comparison: the same tiny run that reads correct reads
    incorrect with the control standing in, by far more than its limit
    on the forces."""
    from cph_bench.control import Control

    c = cell(name)
    res, checks = _run(c, seed=7)
    assert res["correct"], checks
    res, checks = harness.run_cell(c, 7, 0.5, False, "cpu",
                                   time.perf_counter(), wrap=Control)
    assert not res["correct"], checks
    got = {n: (v, lim) for n, v, lim in checks}
    assert got["force_gap"][0] > 3 * got["force_gap"][1], got
    assert got["step_noise_dev"][0] > 3 * got["step_noise_dev"][1], got
    assert got["constraint_gap"][0] > 3 * got["constraint_gap"][1], got
