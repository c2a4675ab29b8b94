"""Profiling and timing on the card (port of
constant_ph_tpu/profiling.py).

Wall-clock step benchmarking that ends in torch.cuda.synchronize() (the
JAX package's block_until_ready), ns/day meters, a torch.profiler trace
(Chrome format) in place of the XProf trace, per-component timing with
CUDA events, and the kernel timers chip_smoke.py uses: device time from a
CUDA graph (``graph_ms``), from CUDA events (``cuda_ms``), and the device
busy share of a run block under torch.profiler (``profile_block``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch

from constant_ph_tpu_torch import units


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
    ka = prof.key_averages()
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
