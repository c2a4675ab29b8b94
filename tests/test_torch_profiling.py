"""The port's spans and counters (constant_ph_tpu_torch/profiling.py), on
the port alone.

- Under a CPU torch.profiler a tiled ``make_run`` (the dilute 4³-cell
  acid of tests/torch_ranks.py at W 16, PME at kspace_every 2, in-run
  metadynamics deposits; 2 blocks of 4 steps) records every span its
  path takes, each under its parent, and no other; ``cph.step`` once a
  step, ``cph.forces`` once a step and once a block start, as the
  counters count them; the run gives the same bits as one without the
  profiler.
- On the card only: K1 launches once a force evaluation, as the counter
  ``k1_launches`` counts it.

The reference engine, ``span`` without a profiler and the campaign
layer's spans and counters: tests/test_torch_profiling_calls.py.
"""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from constant_ph_tpu_torch import metad, profiling
from constant_ph_tpu_torch.engine import EngineConfig
from constant_ph_tpu_torch.tiled.engine import TiledEngine

import torch_ranks as tr

# one torch thread per xdist worker, as the other port tests
torch.set_num_threads(1)

BLOCK, BLOCKS = 4, 2
STEPS = BLOCK * BLOCKS
# (span, parent span) of the tiled run: PME on the MTS boundaries only,
# a deposit at each block end (stride = block)
TILED_TREE = {
    ("cph.run", None), ("cph.rebin", "cph.run"), ("cph.forces", "cph.run"),
    ("cph.step", "cph.run"), ("cph.shake", "cph.step"),
    ("cph.forces", "cph.step"), ("cph.observe", "cph.run"),
    ("cph.metad.deposit", "cph.run"),
    ("cph.forces.water_water", "cph.forces"),
    ("cph.forces.water_solute", "cph.forces"),
    ("cph.forces.solute_solute", "cph.forces"),
    ("cph.forces.kspace", "cph.forces"),
    ("cph.forces.lambda", "cph.forces")}


def _traced(fn):
    """fn() under a CPU profiler, the counters zeroed first: (its result,
    [(span, enclosing span or None)] in start order, counters)."""
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = sorted(
        (e.start_ns(), -e.duration_ns(), e.name())
        for e in prof.profiler.kineto_results.events()
        if e.name().startswith("cph."))
    pairs, open_ = [], []
    for a, neg_d, name in ranges:
        while open_ and open_[-1][1] <= a:
            open_.pop()
        pairs.append((name, open_[-1][0] if open_ else None))
        open_.append((name, a - neg_d))
    return out, pairs, profiling.counters()


def _tiled_run():
    ts, st, pp, _ = tr.pme_box(16)
    mp = metad.MetadParams(nbins=61, stride=BLOCK)
    V, dV = metad.init_tables(ts.spec.n_sites, mp, device="cpu")
    st = dataclasses.replace(st, metad_v=V, metad_dv=dV)
    cfg = EngineConfig(**dict(tr.LANGEVIN, rebuild_every=BLOCK,
                              kspace_every=2))
    run = TiledEngine(ts, cfg, kspace_ep=pp, metad=mp).make_run(STEPS)
    return lambda: run(st, torch.Generator().manual_seed(11))


@pytest.fixture(scope="module")
def tiled():
    """The tiled run traced, and the same run untraced."""
    run = _tiled_run()
    traced = _traced(run)
    profiling.reset_counters()
    return traced, run()


def _count(pairs, name):
    return sum(n == name for n, _ in pairs)


def test_a_tiled_run_records_its_span_tree(tiled):
    (_, pairs, _), _ = tiled
    assert set(pairs) == TILED_TREE
    assert {n for n, _ in pairs} <= set(profiling.SPANS)


def test_a_tiled_run_counts_steps_forces_rebins_and_deposits(tiled):
    (_, pairs, c), _ = tiled
    assert _count(pairs, "cph.step") == c["steps"] == STEPS
    assert _count(pairs, "cph.forces") == c["forces"] == STEPS + BLOCKS
    assert _count(pairs, "cph.rebin") == c["rebins"] == BLOCKS
    assert _count(pairs, "cph.metad.deposit") == c["deposits"] == BLOCKS
    # the block starts (step 0 and 4) and the even steps 2, 4, 6, 8
    assert _count(pairs, "cph.forces.kspace") == BLOCKS + STEPS // 2
    assert c["k1_launches"] == c["k2_launches"] == 0      # plain on the CPU


def test_a_traced_run_gives_the_bits_of_an_untraced_one(tiled):
    ((st1, ov1, obs1), _, _), (st0, ov0, obs0) = tiled
    assert torch.equal(ov1, ov0)
    for a, b in ((st1, st0), (obs1, obs0)):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), f.name
            else:
                assert x == y, f.name


def test_k1_launches_once_a_force_evaluation_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU build")
    from constant_ph_tpu_torch.systems.water import solvated_acid
    from constant_ph_tpu_torch.tiled.layout import (
        retile, split_system, to_tiled)

    sys_ = solvated_acid(device="cuda", **tr.DILUTE)
    ts = split_system(sys_, device="cuda")
    ts, st = retile(ts, to_tiled(ts, sys_.state), 16)
    eng = TiledEngine(ts, EngineConfig(**dict(tr.LANGEVIN,
                                              rebuild_every=BLOCK)))
    profiling.reset_counters()
    eng.make_run(STEPS)(st, torch.Generator("cuda").manual_seed(1))
    c = profiling.counters()
    assert c["k1_launches"] == c["forces"] == STEPS + BLOCKS
    assert c["k1_slab_launches"] == c["k2_launches"] == 0
