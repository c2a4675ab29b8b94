"""Elastic production driver for the tiled engine (port of
constant_ph_tpu/tiled/elastic.py).

Runs MD in chunks with LAMMPS-style capacity management (the
grow-on-overflow analog of `memory->grow`, SURVEY.md §2.3.7): the rebin
capacity flag trips one slot EARLY (layout.rebin), so when it fires the
chunk-start state is still complete — the driver retiles to a roomier W
(layout.retile_auto) and redoes the chunk, never dropping a molecule. A
flag that persists immediately after a retile is the dangerous-build
(drift) monitor instead; it is counted and reported, as LAMMPS counts
dangerous builds.

Noise: the JAX package keeps its PRNG key in the state, so a redo draws
the same noise. Here one ``torch.Generator`` drives every chunk of every
engine (a retile builds a new engine, whose own generator would restart
from its seed); its state is taken at each chunk start and restored for
a redo, so a redo equals a run started from the chunk's start state at
the larger W. The chunk-start state stays on the device; only a retile
reads it back. Each chunk reads two values on the host (the capacity
flag and the molecule count), as the JAX driver does.

With ``spatial`` (a process group) the engines run on x-slabs
(TiledEngine(spatial=group)) and the state is the rank's slab
(parallel.spatial.shard_tiled_state). The capacity flag comes alike on
every rank from the run's rebin; on it the tiles are gathered once, every
rank retiles the whole grid alike and keeps its slab of the new tiles.
The molecule count is summed over the ranks. ``on_chunk`` receives the
rank's slab: parallel.spatial.gather_state gives the whole grid on every
rank, for the checkpoint and trajectory writers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from constant_ph_tpu_torch.engine import Observables
from constant_ph_tpu_torch.lambda_dyn import BiasParams
from constant_ph_tpu_torch.parallel import spatial as spatial_mod
from constant_ph_tpu_torch.tiled.engine import TiledEngine
from constant_ph_tpu_torch.tiled.layout import retile_auto


@dataclasses.dataclass
class ElasticInfo:
    n_retiles: int = 0
    n_dangerous_blocks: int = 0
    final_W: int = 0
    retile_steps: list = dataclasses.field(default_factory=list)


def concat_observables(parts) -> Observables:
    """Observables of consecutive runs joined along the step axis."""
    return Observables(**{
        f.name: torch.cat([getattr(o, f.name) for o in parts])
        for f in dataclasses.fields(Observables)})


def _run_elastic(ts, tst, cfg, n_steps, chunk, make_engine, margin_min,
                 generator, on_chunk, check_sync, boundary=None):
    """The elastic loop: chunks of ``chunk`` steps (a multiple of
    rebuild_every), retile and redo on the capacity flag, on_chunk(done,
    ts, tst, obs) after each chunk, then ``boundary(eng, tst) → tst``
    (the NPT volume move). Returns (ts, tst, obs, ElasticInfo)."""
    gen = generator
    if gen is None:
        gen = torch.Generator(device=ts.device).manual_seed(cfg.seed)
    eng = make_engine(ts)
    run = eng.make_run(chunk, detailed_flags=True)
    n_waters = eng.n_waters
    info = ElasticInfo()
    parts = []
    done = 0
    while done < n_steps:
        g0 = gen.get_state()
        if check_sync:
            torch.cuda.set_sync_debug_mode("error")
        try:
            tst2, (ov_cap, ov_drift), obs = run(tst, gen)
        finally:
            if check_sync:
                torch.cuda.set_sync_debug_mode("default")
        if bool(ov_cap):
            # capacity: grow W and REDO the chunk from its (complete)
            # start state with the chunk's noise; the early flag
            # guarantees nothing was lost. On slabs the whole grid is
            # retiled on every rank alike and sharded again
            full = tst
            if eng.slab is not None:
                full = spatial_mod.gather_tiles(tst, eng.slab, ts.params)
            occ = int(full.wvalid.sum(dim=-1).max())
            ts, tst = retile_auto(ts, full, max(occ, ts.params.W),
                                  margin_min=margin_min)
            if eng.slab is not None:
                tst = spatial_mod.shard_tiled_state(tst, eng.slab.group,
                                                    ts.params)
            gen.set_state(g0)
            eng = make_engine(ts)
            run = eng.make_run(chunk, detailed_flags=True)
            info.n_retiles += 1
            info.retile_steps.append(done)
            continue
        if bool(ov_drift):
            # dangerous build (water drift past skin between rebins):
            # counted, as in LAMMPS; not a capacity problem
            info.n_dangerous_blocks += 1
        tst = tst2
        done += chunk
        assert int(eng.slab_total(tst.wvalid.sum())) == n_waters, \
            "molecule count changed — capacity invariant violated"
        parts.append(obs)
        if on_chunk is not None:
            on_chunk(done, ts, tst, obs)
        if boundary is not None:
            tst = boundary(eng, tst)
    info.final_W = ts.params.W
    return ts, tst, concat_observables(parts), info


def elastic_run(ts, tst, cfg, n_steps: int, *, chunk: int = 2000,
                bias=None, kspace_ep=None, margin_min: int = 6,
                on_chunk: Optional[Callable] = None, generator=None,
                check_sync: bool = False, spatial=None):
    """Run ``n_steps`` of tiled MD with elastic tile capacity.

    on_chunk(step_count, ts, tst, obs) is called after every completed
    chunk (trajectory writers, loggers). ``generator`` drives the noise of
    every chunk (default: a new one seeded with cfg.seed). With
    ``check_sync`` each chunk runs under torch.cuda.set_sync_debug_mode
    ("error"): a host sync inside a chunk raises (a check for the card).
    Returns (ts, tst, obs_concat, ElasticInfo). Retiling keeps the cell
    grid, so PME params remain valid across retiles. With ``spatial`` (a
    process group, parallel.spatial.make_spatial_mesh) every rank calls it
    with its slab of the state and gets its slab back; ``on_chunk`` sees
    the slab (parallel.spatial.gather_state gives the whole grid)."""
    # make_run(chunk) runs ceil(chunk / rebuild_every) whole blocks: round
    # the chunk up so `done` counts real steps
    chunk = -(-chunk // cfg.rebuild_every) * cfg.rebuild_every

    def make_engine(ts_):
        return TiledEngine(ts_, cfg, bias=bias or BiasParams(),
                           kspace_ep=kspace_ep, spatial=spatial)

    return _run_elastic(ts, tst, cfg, n_steps, chunk, make_engine,
                        margin_min, generator, on_chunk, check_sync)
