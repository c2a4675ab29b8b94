"""The program's own spans and counters in the traced window.

constant_ph_tpu_torch opens ``cph.*`` record_function ranges inside
itself whenever a profiler runs (its ``profiling.SPANS``: the run loop,
the step, the force layers, the block boundary's rebin and deposits),
and keeps host counters (``profiling.counters()``: force evaluations,
steps, rebins, kernel launches). Both are read here, beside what
tracing.py reads:

- ``Trace.program``: for each ``cph.*`` span name, ``calls``, ``host_s``
  (the ranges' host time), ``device_s`` (device time of the operations
  launched while a range of that name was open on the host: inclusive),
  ``self_device_s`` (each operation counted only in the innermost open
  range), ``ops`` (the operations in ``device_s``) and ``idle_s`` (the
  window's idle time while a range of that name was open). An operation's
  launch is the host's CUDA runtime call of the same correlation id, or
  else the torch op its linked correlation id names.
- ``Trace.counters``: the counters' change across the traced blocks.

``install()`` adds both to what tracing.traced_window returns, by
wrapping ``tracing.reduce`` and ``tracing.traced_window``; every field
that tracing.py computes is computed as before, from the same events.
The readers call it when the harness loads them, which is before the
traced window. On a program without spans or counters both are empty
and the readers return nothing."""
from __future__ import annotations

import functools

import numpy as np
import torch

from cph_bench import tracing

PREFIX = "cph."


def counters() -> dict:
    """The program's counters now ({} where it keeps none)."""
    from constant_ph_tpu_torch import profiling

    read = getattr(profiling, "counters", None)
    return dict(read()) if read is not None else {}


def reduce_program(events, span_names=()) -> dict:
    """{span: {calls, host_s, device_s, self_device_s, ops, idle_s}} of
    the program's ``cph.*`` ranges in kineto's raw ``events``. Device
    operations, the window and its idle time are taken as
    tracing.reduce takes them (``span_names``: the benchmark's own
    ranges, not device work)."""
    cuda = torch.autograd.DeviceType.CUDA
    skip = set(span_names) | {tracing.WINDOW}
    d_t, d_corr, d_link = [], [], []
    runtime, torch_op = {}, {}
    ranges = []                              # (start, end, name)
    window = None
    for e in events:
        a, n = e.start_ns(), e.name()
        b = a + e.duration_ns()
        if e.device_type() == cuda:
            if not (e.is_user_annotation() or n in skip
                    or n.startswith(PREFIX)):
                d_t.append((a, b))
                d_corr.append(e.correlation_id())
                d_link.append(e.linked_correlation_id())
        elif n.startswith(PREFIX):
            ranges.append((a, b, n))
        elif n == tracing.WINDOW and e.is_user_annotation():
            window = (a, b)
        elif n.startswith("cu"):             # CUDA runtime / driver calls
            runtime[e.correlation_id()] = a
        elif "::" in n:                      # torch ops
            torch_op.setdefault(e.correlation_id(), a)
    if not ranges:
        return {}
    iv = np.array(d_t, np.float64).reshape(-1, 2)
    launch = np.array([runtime.get(c, torch_op.get(k, np.nan))
                       for c, k in zip(d_corr, d_link)], np.float64)
    dur = iv[:, 1] - iv[:, 0]
    idle = _idle(iv, window)
    out = {}
    for name in sorted({n for _, _, n in ranges}):
        mine = np.array([(a, b) for a, b, n in ranges if n == name],
                        np.float64)
        union = _union(mine)
        inside = _holder(union, launch) >= 0
        out[name] = dict(
            calls=len(mine),
            host_s=float(np.sum(mine[:, 1] - mine[:, 0])) * 1e-9,
            device_s=float(np.sum(dur[inside])) * 1e-9,
            self_device_s=0.0, ops=int(np.sum(inside)),
            idle_s=float(sum(idle(a, b) for a, b in union)) * 1e-9)
    owner = _innermost(ranges, launch)
    for k, du in zip(owner, dur):
        if k >= 0:
            out[ranges[k][2]]["self_device_s"] += float(du) * 1e-9
    return out


def _union(iv):
    """Sorted, merged intervals of an (n, 2) array."""
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    merged = []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return np.array(merged, np.float64).reshape(-1, 2)


def _holder(iv, t):
    """For each time of ``t``, the index of the interval of ``iv`` (n, 2),
    sorted and disjoint, that holds it, or -1."""
    if not len(iv):
        return np.full(len(t), -1)
    j = np.searchsorted(iv[:, 0], t, side="right") - 1
    ok = (j >= 0) & ~np.isnan(t)
    ok[ok] &= t[ok] <= iv[j[ok], 1]
    return np.where(ok, j, -1)


def _idle(iv, window):
    """idle(a, b): the window's idle time inside [a, b], the window and
    its gaps as tracing.reduce takes them (first device operation to the
    end of the final synchronise)."""
    if not len(iv):
        return lambda a, b: 0.0
    t0 = float(iv[:, 0].min())
    t1 = max(float(window[1]) if window else t0, float(iv[:, 1].max()))
    busy = _union(iv)
    ga = np.concatenate([[t0], busy[:, 1]])
    gb = np.concatenate([busy[:, 0], [t1]])
    keep = gb > ga
    ga, gb = ga[keep], gb[keep]
    before = np.concatenate([[0.0], np.cumsum(gb - ga)])

    def upto(t):
        k = np.searchsorted(ga, t, side="right") - 1
        if k < 0:
            return 0.0
        return before[k] + min(max(t - ga[k], 0.0), gb[k] - ga[k])

    return lambda a, b: upto(b) - upto(a)


def _innermost(ranges, t):
    """For each time of ``t``, the index in ``ranges`` of the innermost
    range open at it, or -1: ranges nest, so those of one depth are
    disjoint and the deepest that holds a time is its innermost."""
    order = sorted(range(len(ranges)),
                   key=lambda i: (ranges[i][0], -ranges[i][1]))
    depth, stack = {}, []
    for i in order:
        a, b, _ = ranges[i]
        while stack and ranges[stack[-1]][1] <= a:
            stack.pop()
        depth[i] = len(stack)
        stack.append(i)
    owner = np.full(len(t), -1)
    for d in sorted(set(depth.values())):
        ids = np.array([i for i in order if depth[i] == d])
        h = _holder(np.array([ranges[i][:2] for i in ids], np.float64), t)
        owner[h >= 0] = ids[h[h >= 0]]
    return owner


def install():
    """Make tracing.traced_window's Trace carry ``program`` and
    ``counters`` (once; later calls do nothing)."""
    if getattr(tracing.traced_window, "_with_program", False):
        return
    reduce, window = tracing.reduce, tracing.traced_window

    @functools.wraps(reduce)
    def reduce_with_program(prof, calls, batched_steps):
        tr = reduce(prof, calls, batched_steps)
        tr.program = reduce_program(prof.profiler.kineto_results.events(),
                                    calls)
        return tr

    @functools.wraps(window)
    def window_with_counters(*args, **kw):
        before = counters()
        tr = window(*args, **kw)
        tr.counters = {k: v - before.get(k, 0)
                       for k, v in counters().items()}
        return tr

    window_with_counters._with_program = True
    tracing.reduce = reduce_with_program
    tracing.traced_window = window_with_counters


def spans(tr):
    """The Trace's program spans where the window ran device work, else
    None."""
    p = getattr(tr, "program", None)
    return p if p and tr.device_ops else None
