"""Profiling and timing on the card (port of
constant_ph_tpu/profiling.py).

Wall-clock step benchmarking that ends in torch.cuda.synchronize() (the
JAX package's block_until_ready), ns/day meters, a torch.profiler trace
(Chrome format) in place of the XProf trace, per-component timing with
CUDA events, and the kernel timers chip_smoke.py uses: device time from a
CUDA graph (``graph_ms``), from CUDA events (``cuda_ms``), and the device
busy time of a run block under torch.profiler (``profile_block``).

Spans and counters inside the program:

- ``span(name)`` is a ``torch.profiler.record_function`` range while a
  profiler runs, and one shared ``contextlib.nullcontext`` otherwise (a
  flag check; nothing is made, no dispatcher call); ``spanned(name)``
  wraps a function in one. Any torch.profiler run records them beside
  the kernels launched inside them, on the same clock: ``with
  profiling.trace(logdir): ...`` writes them into ``logdir/trace.json``.
  ``SPANS`` names every span, all under ``cph.``; the tree (parent →
  children):

      cph.run → cph.rebin, cph.nbr_build, cph.step, cph.forces (block
          start), cph.observe, cph.metad.deposit
      cph.step → cph.shake, cph.forces
      cph.forces → cph.forces.water_water, .water_solute, .solute_solute,
          .pair, .kspace (an MTS boundary only), .lambda
      cph.minimize → cph.rebin, cph.forces, cph.shake
      cph.metad.deposit_many, cph.rex.swap, cph.comm.<kind>: under the
          caller's span

- ``COUNTERS`` are plain host integers, always on (a dict increment,
  never a read of a device value): force evaluations, steps, rebins,
  in-run deposits, hills merged by ``metad.deposit_many``, ``swap_phs``
  calls, and the launches of the CUDA kernels K1 and K2 (all, and those
  through their slab entries). Read them with ``counters()``, zero them
  with ``reset_counters()``. Overflow flags, accepted swaps and failed
  replica-blocks stay device tensors that the caller reads when it
  synchronises anyway; the collectives have their own counter
  (parallel/comm.STATS).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler

from constant_ph_tpu_torch import units

SPANS = ("cph.run", "cph.rebin", "cph.nbr_build", "cph.step", "cph.shake",
         "cph.forces", "cph.forces.water_water", "cph.forces.water_solute",
         "cph.forces.solute_solute", "cph.forces.pair", "cph.forces.kspace",
         "cph.forces.lambda", "cph.observe", "cph.metad.deposit",
         "cph.metad.deposit_many", "cph.rex.swap", "cph.comm.all_reduce",
         "cph.comm.all_gather", "cph.comm.broadcast",
         "cph.comm.halo_exchange", "cph.minimize")
COUNTERS = dict.fromkeys(
    ("forces", "steps", "rebins", "deposits", "hill_merges", "swaps",
     "k1_launches", "k1_slab_launches", "k2_launches", "k2_slab_launches"),
    0)
_OFF = contextlib.nullcontext()


def span(name: str):
    """A record_function range named ``name`` while a profiler runs; the
    shared no-op context otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _autograd_profiler.record_function(name)


def spanned(name: str):
    """Decorator: each call of the function inside ``span(name)``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return wrapper
    return deco


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` (one of COUNTERS)."""
    COUNTERS[name] += n


def counters() -> dict:
    """A copy of the counters."""
    return dict(COUNTERS)


def reset_counters():
    """Zero every counter."""
    for k in COUNTERS:
        COUNTERS[k] = 0


def _sync():
    """Wait for the card's queued work (nothing to wait for when CUDA was
    never used)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def benchmark_run(run_fn, state, *args, n_calls: int = 5,
                  steps_per_call: int, dt_fs: float, warmup: int = 2):
    """Time a run function run_fn(state, *args) → (state, ...). Returns
    dict with ms/step and ns/day (host clock around calls that end in a
    synchronize)."""
    for _ in range(warmup):
        state = run_fn(state, *args)[0]
    _sync()
    t0 = time.perf_counter()
    for _ in range(n_calls):
        state = run_fn(state, *args)[0]
    _sync()
    wall = time.perf_counter() - t0
    n_steps = n_calls * steps_per_call
    ms_per_step = 1e3 * wall / n_steps
    ns_day = (n_steps * dt_fs / units.FS_PER_NS) / (wall / 86400.0)
    return {"ms_per_step": ms_per_step, "ns_per_day": ns_day,
            "wall_s": wall, "steps": n_steps}


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace (CPU and CUDA activity) of the
    enclosed work into ``logdir/trace.json`` (Chrome / Perfetto format).
    Yields the profiler, whose key_averages() the caller may read."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def time_components(fns: dict, *, n_calls: int = 10) -> dict:
    """Time a dict of nullary thunks individually: ms a call, host clock
    around n_calls calls that end in a synchronize, after one warm-up
    call."""
    out = {}
    for name, fn in fns.items():
        fn()
        _sync()
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn()
        _sync()
        out[name] = 1e3 * (time.perf_counter() - t0) / n_calls
    return out


def cuda_ms(fn, n):
    """Device time of one call of fn: CUDA events around n calls after two
    warm-up calls (the host's launch cost is in it when the host is slower
    than the device)."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def graph_ms(fn, n):
    """Device time of one call of fn: n calls captured in one CUDA graph
    and the graph replayed between two events, so the host's time to
    launch each call (the Python wrapper) is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


@dataclasses.dataclass
class BlockProfile:
    busy_ms_per_step: float      # device busy time a step
    ops_per_step: float          # device operations a step
    rows: list                   # (device µs, count, name), busiest first


def profile_block(run_block, st, block):
    """One run block under torch.profiler: device busy time by kernel and
    device operations a step. Returns (state after the block,
    BlockProfile)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st = run_block(st)[0]
        torch.cuda.synchronize()
    # the spans' own rows are ranges, not device work
    ka = [e for e in prof.key_averages() if not (
        getattr(e, "is_user_annotation", False)
        or e.key.startswith("cph."))]
    # device-side rows (kernels, copies); where the profiler lists none,
    # each CPU op's self device time counts its own kernels once
    rows = [(e.self_device_time_total, e.count, e.key) for e in ka
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not rows:
        rows = [(e.self_device_time_total, e.count, e.key) for e in ka
                if e.self_device_time_total > 0]
    rows.sort(reverse=True)
    return st, BlockProfile(
        busy_ms_per_step=sum(r[0] for r in rows) / 1e3 / block,
        ops_per_step=sum(r[1] for r in rows) / block, rows=rows)
