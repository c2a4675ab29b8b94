"""The program's spans and counters in the traced window
(cph_bench/program.py): the reduction on a hand-made kineto-like event
list, the fields tracing.py computes unchanged by the program's ranges,
the four readers, and a traced window on the CPU."""
import types

import pytest
import torch

from cph_bench import harness, program, tracing
from cph_bench.tests.small import cell

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


class Ev:
    """One raw event, with the methods tracing and program call."""

    def __init__(self, name, a, b, dev=CPU, ua=False, corr=0, link=0):
        self.n, self.a, self.d = name, a, b - a
        self.dev, self.ua, self.corr, self.link = dev, ua, corr, link

    def name(self):
        return self.n

    def start_ns(self):
        return self.a

    def duration_ns(self):
        return self.d

    def device_type(self):
        return self.dev

    def is_user_annotation(self):
        return self.ua

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.link


def _kernel(name, op_id, rt_id, t_op, dev):
    """A torch op at t_op, its runtime launch 2 ns in, and its kernel on
    the device over ``dev``."""
    return [Ev(f"aten::{name}", t_op, t_op + 8, corr=op_id),
            Ev("cudaLaunchKernel", t_op + 2, t_op + 5, corr=rt_id),
            Ev(f"k_{name}", dev[0], dev[1], dev=CUDA, corr=rt_id,
               link=op_id)]


def _events(with_program):
    """A window [0, 1000] ns: a step [100, 500] that holds a SHAKE range
    [150, 250] and a force range [300, 450] around the benchmark's own
    water_solute_fast range [310, 440]; four kernels, one in each and
    one in the run alone; the GPU-side ranges the card reports
    (flagged as user annotations)."""
    ev = [Ev(tracing.WINDOW, 0, 1000, ua=True, corr=1),
          Ev("water_solute_fast", 310, 440, ua=True, corr=2),
          Ev("water_solute_fast", 320, 480, dev=CUDA, ua=True)]
    ev += _kernel("mul", 10, 110, 120, (130, 230))
    ev += _kernel("add", 11, 111, 160, (240, 300))
    ev += _kernel("ww", 12, 112, 315, (320, 480))
    ev += _kernel("sum", 13, 113, 600, (600, 700))
    if with_program:
        ev += [Ev("cph.run", 0, 1000, ua=True, corr=20),
               Ev("cph.step", 100, 500, ua=True, corr=21),
               Ev("cph.shake", 150, 250, ua=True, corr=22),
               Ev("cph.forces", 300, 450, ua=True, corr=23),
               Ev("cph.step", 130, 480, dev=CUDA, ua=True),
               Ev("cph.forces", 320, 480, dev=CUDA, ua=True)]
    return sorted(ev, key=lambda e: e.a)


def _prof(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


@pytest.fixture
def installed(monkeypatch):
    """program.install() on tracing, undone after the test."""
    monkeypatch.setattr(tracing, "reduce", tracing.reduce)
    monkeypatch.setattr(tracing, "traced_window", tracing.traced_window)
    program.install()


def test_the_program_fields_of_a_hand_made_window():
    got = program.reduce_program(_events(True), {"water_solute_fast"})
    ns = 1e-9
    # busy [130,230] [240,300] [320,480] [600,700]: idle 10, 20, 120, 300
    want = {"cph.run": (1, 1000, 420, 100, 4, 450),
            "cph.step": (1, 400, 320, 100, 3, 50),
            "cph.shake": (1, 100, 60, 60, 1, 10),
            "cph.forces": (1, 150, 160, 160, 1, 20)}
    assert set(got) == set(want)
    for name, vals in want.items():
        row = got[name]
        assert row["calls"] == vals[0] and row["ops"] == vals[4], name
        for k, v in zip(("host_s", "device_s", "self_device_s"), vals[1:4]):
            assert row[k] == pytest.approx(v * ns, abs=1e-15), (name, k)
        assert row["idle_s"] == pytest.approx(vals[5] * ns, abs=1e-15)
    assert program.reduce_program(_events(False)) == {}


def test_the_fields_tracing_computes_are_unchanged(installed):
    calls = {"water_solute_fast": [1]}
    old = tracing.Trace.__dataclass_fields__
    bare = tracing.reduce(_prof(_events(False)), calls, 4)
    full = tracing.reduce(_prof(_events(True)), calls, 4)
    for f in old:
        if f != "gaps":
            assert getattr(full, f) == getattr(bare, f), f
    # a gap's length is the same; its label is the innermost host range
    # over it, now and then one of the program's
    assert [s for s, _ in full.gaps] == [s for s, _ in bare.gaps]
    assert all(a == b or a.startswith("cph.")
               for (_, a), (_, b) in zip(full.gaps, bare.gaps))
    assert bare.span_device_s == pytest.approx({"water_solute_fast": 160e-9})
    assert bare.device_ops == 4 and bare.busy_s == pytest.approx(420e-9)
    assert set(full.program) == {"cph.run", "cph.step", "cph.shake",
                                 "cph.forces"}
    assert bare.program == {}


def test_the_readers_on_a_hand_made_window(installed):
    tr = tracing.reduce(_prof(_events(True)), {}, 4)
    tr.counters = {"forces": 5}
    run = types.SimpleNamespace(steps_per_block=2)
    read = {m: harness.reader(cell("peptide20_dsf_27k.metad_r12"), m).read
            for m in ("integrate_ms", "idle_step_ms", "idle_boundary_ms",
                      "forces_per_step")}
    assert read["integrate_ms"](tr, None, run) == pytest.approx(160e-6)
    assert read["idle_step_ms"](tr, None, run) == pytest.approx(50e-6)
    # window 870 ns, busy 420: 450 idle, 50 of it in the step; 2 blocks
    assert read["idle_boundary_ms"](tr, None, run) == pytest.approx(200e-6)
    assert read["forces_per_step"](tr, None, run) == 1.25
    # nothing where the program has no spans or counters, or no device op
    bare = tracing.reduce(_prof(_events(False)), {}, 4)
    bare.counters = {}
    assert all(r(bare, None, run) is None for r in read.values())
    tr.device_ops = 0
    assert all(r(tr, None, run) is None for r in read.values())


def test_a_traced_window_on_the_cpu_fills_program_and_counters(installed):
    """The tiny metad cell, one 12-step block traced: its spans and its
    counters are read; the readers find no device operation."""
    c = cell("peptide20_dsf_27k.metad_r12")
    torch.set_num_threads(min(4, torch.get_num_threads()))
    ctx = harness.Context(c, 2**31 + 5, "cpu")
    run = harness.driver(c).make(ctx)
    run.block()
    tr = tracing.traced_window(run, 1, ctx.sync, {})
    steps = run.steps_per_block
    blocks = steps // run.cfg.rebuild_every
    assert tr.batched_steps == steps
    assert tr.counters["steps"] == tr.program["cph.step"]["calls"] == steps
    assert tr.counters["forces"] == tr.program["cph.forces"]["calls"] \
        == steps + blocks
    assert tr.counters["rebins"] == blocks
    assert tr.counters["hill_merges"] == \
        run.G * run.wpp * (steps // run.mp.stride)
    assert tr.counters["swaps"] == 0
    assert tr.program["cph.metad.deposit_many"]["calls"] == run.G
    assert {"cph.run", "cph.rebin", "cph.shake", "cph.observe",
            "cph.forces.water_solute"} <= set(tr.program)
    assert all(v["host_s"] > 0 and v["device_s"] == 0
               for v in tr.program.values())
    for m in ("integrate_ms", "idle_step_ms", "idle_boundary_ms",
              "forces_per_step"):
        assert harness.reader(c, m).read(tr, ctx, run) is None, m
