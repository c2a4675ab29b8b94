"""The port's spans and counters (constant_ph_tpu_torch/profiling.py)
beyond the tiled run (tests/test_torch_profiling.py), on the port alone:

- under a CPU torch.profiler a reference ``Engine`` run
  (torch_ranks.ref_rex_batch, 2 blocks of 2 steps) records every span its
  path takes, each under its parent, and no other, as the counters count
  the steps and force evaluations;
- with no profiler, ``span`` hands out one shared no-op context and never
  makes a record_function;
- the campaign layer: deposit_many counts its hills, swap_phs its calls,
  each opens its span, and so does every collective.
"""
import contextlib

import torch

from constant_ph_tpu_torch import metad, profiling
from constant_ph_tpu_torch.lambda_dyn import BiasParams
from constant_ph_tpu_torch.parallel import comm, replica

import torch_ranks as tr
from test_torch_profiling import _count, _traced

# one torch thread per xdist worker, as the other port tests
torch.set_num_threads(1)

REF_TREE = {
    ("cph.run", None), ("cph.nbr_build", "cph.run"),
    ("cph.forces", "cph.run"), ("cph.step", "cph.run"),
    ("cph.forces", "cph.step"), ("cph.observe", "cph.run"),
    ("cph.forces.pair", "cph.forces"), ("cph.forces.lambda", "cph.forces")}


def test_a_reference_run_records_its_span_tree():
    eng, batch, nbr = tr.ref_rex_batch(2)
    run = eng.make_run(4)                    # rebuild_every 2: 2 blocks
    gens = replica.replica_generators([3, 4], "cpu")
    _, pairs, c = _traced(lambda: run(batch, nbr, gens))
    assert set(pairs) == REF_TREE
    assert _count(pairs, "cph.step") == c["steps"] == 4
    assert _count(pairs, "cph.forces") == c["forces"] == 4 + 2
    assert _count(pairs, "cph.nbr_build") == 2


def test_without_a_profiler_a_span_makes_nothing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a record_function was made")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = profiling.span("cph.step"), profiling.span("cph.forces")
    assert a is b and isinstance(a, contextlib.nullcontext)
    eng, batch, nbr = tr.ref_rex_batch(2)
    profiling.reset_counters()
    eng.make_run(2)(batch, nbr, replica.replica_generators([1, 2], "cpu"))
    assert profiling.counters()["steps"] == 2


def test_merges_swaps_and_collectives_count_and_open_spans():
    mp = metad.MetadParams(nbins=61)
    V, dV = metad.init_tables(2, mp, device="cpu")
    seq = torch.rand(3, 2, generator=torch.Generator().manual_seed(2))
    _, batch, _ = tr.ref_rex_batch(2)
    t = torch.ones(4)

    def calls():
        metad.deposit_many(V, dV, seq, mp)
        replica.swap_phs(batch, torch.Generator().manual_seed(3),
                         BiasParams(), 0)
        comm.all_reduce_sum(t)
        comm.all_gather(t)
        comm.broadcast(t)
        comm.halo_exchange(t, t)

    _, pairs, c = _traced(calls)
    assert pairs == [(n, None) for n in (
        "cph.metad.deposit_many", "cph.rex.swap", "cph.comm.all_reduce",
        "cph.comm.all_gather", "cph.comm.broadcast",
        "cph.comm.halo_exchange")]
    assert c["hill_merges"] == 3 and c["swaps"] == 1
    profiling.reset_counters()
    assert set(profiling.counters().values()) == {0}
