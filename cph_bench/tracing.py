"""The traced window: ``trace_blocks`` blocks under torch.profiler (CPU
and CUDA activity), with spans of the benchmark's own around the calls
into the layers that have per-layer metrics, and the reduction of the
trace to what the readers in cph_bench/layers take.

A span is a ``torch.profiler.record_function`` range opened by a wrapper
that the traced run puts around a function of the port (the module
attribute the engine calls through); the device time of the kernels
launched inside it is the span's device time. Each reader names the
spans it needs in its ``SPANS`` ({span: (module, attribute)}); untraced
runs install no wrapper.

The window runs from its first device operation to the end of the final
synchronise, inside a range of its own (``WINDOW``), so that the
profiler's start-up and the host's first launches before the device has
work are not counted as idle."""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib

import numpy as np
import torch

WINDOW = "cph_bench.window"


@contextlib.contextmanager
def spans(wanted):
    """Wrap each function of ``wanted`` ({span: (module, attribute)}) in
    a record_function range named after the span; count its calls.
    Yields {span: [calls]}; restores on exit."""
    calls = {}
    saved = []
    for name, (mod_name, attr) in wanted.items():
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr, None)
        if fn is None:
            continue
        calls[name] = [0]

        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls[_name][0] += 1
            with torch.profiler.record_function(_name):
                return _fn(*a, **kw)

        functools.update_wrapper(wrapped, fn)
        setattr(mod, attr, wrapped)
        saved.append((mod, attr, fn))
    try:
        yield calls
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


@dataclasses.dataclass
class Trace:
    window_s: float              # first device op to the final synchronise
    busy_s: float                # union of device intervals
    device_ops: int              # kernels, copies and sets
    by_name: dict                # device op name → (seconds, count)
    gaps: list                   # (seconds, host op during the gap)
    span_device_s: dict          # span → device seconds inside it
    span_calls: dict             # span → calls
    batched_steps: int


def reduce(prof, calls, batched_steps) -> Trace:
    """The raw profiler events (kineto's, without torch's per-event
    parse, which takes minutes on a window of ~10⁶ events) reduced to the
    Trace. A device op belongs to a span when the host op that launched
    it (its linked correlation id, as torch's own attribution links
    them) started inside the span's range."""
    cuda = torch.autograd.DeviceType.CUDA
    span_names = set(calls) | {WINDOW}
    d_name, d_t, d_link = [], [], []
    h_name, h_t, h_id = [], [], []
    s_name, s_t = [], []
    window = None                # the WINDOW range on the host
    for e in prof.profiler.kineto_results.events():
        a, n = e.start_ns(), e.name()
        b = a + e.duration_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation() and n not in span_names:
                d_name.append(n)
                d_t.append((a, b))
                d_link.append(e.linked_correlation_id())
        elif e.is_user_annotation() and n == WINDOW:
            window = (a, b)
        elif e.is_user_annotation() and n in span_names:
            s_name.append(n)
            s_t.append((a, b))
        else:
            h_name.append(n)
            h_t.append((a, b))
            h_id.append(e.correlation_id())
    iv = np.array(d_t, np.float64).reshape(-1, 2)
    if window is None:
        window = (iv[:, 0].min(), iv[:, 1].max()) if len(iv) else (0, 0)
    t0 = float(iv[:, 0].min()) if len(iv) else float(window[0])
    t1 = max(float(window[1]), float(iv[:, 1].max()) if len(iv) else t0)
    order = np.argsort(iv[:, 0], kind="stable")
    merged = []
    for a, b in iv[order]:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    edges = [t0] + [x for ab in merged for x in ab] + [t1]
    gaps = sorted(((edges[2 * k + 1] - edges[2 * k], edges[2 * k],
                    edges[2 * k + 1]) for k in range(len(edges) // 2)),
                  reverse=True)
    ht = np.array(h_t, np.float64).reshape(-1, 2)
    named = []
    for length, a, b in gaps[:10]:
        mid = 0.5 * (a + b)
        inside = np.nonzero((ht[:, 0] <= mid) & (ht[:, 1] >= mid))[0]
        what = (h_name[inside[np.argmin(ht[inside, 1] - ht[inside, 0])]]
                if len(inside) else "no host op")
        named.append((length * 1e-9, what))
    by_name = {}
    for n, (a, b) in zip(d_name, d_t):
        s, k = by_name.get(n, (0.0, 0))
        by_name[n] = (s + (b - a) * 1e-9, k + 1)
    # device time inside each span, through the launching host op
    span_s = {}
    if s_t and d_t:
        launch = dict(zip(h_id, ht[:, 0]))
        st = np.array(s_t, np.float64)
        so = np.argsort(st[:, 0], kind="stable")
        st, sn = st[so], [s_name[i] for i in so]
        at = np.array([launch.get(k, np.nan) for k in d_link])
        j = np.searchsorted(st[:, 0], at, side="right") - 1
        ok = (j >= 0) & ~np.isnan(at)
        ok[ok] &= at[ok] <= st[j[ok], 1]
        dur = iv[:, 1] - iv[:, 0]
        for jj, du in zip(j[ok], dur[ok]):
            span_s[sn[jj]] = span_s.get(sn[jj], 0.0) + du * 1e-9
    return Trace(window_s=(t1 - t0) * 1e-9, busy_s=busy * 1e-9,
                 device_ops=len(d_t), by_name=by_name, gaps=named,
                 span_device_s=span_s,
                 span_calls={k: v[0] for k, v in calls.items()},
                 batched_steps=batched_steps)


def traced_window(run, n_blocks, sync, wanted):
    """n_blocks blocks of the driver under the profiler, ending in
    ``sync()``, with the spans ``wanted`` ({span: (module, attribute)}).
    Returns the reduced Trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with spans(wanted) as calls:
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                for _ in range(n_blocks):
                    run.block()
                sync()
    return reduce(prof, calls, n_blocks * run.steps_per_block)


def breakdown(tr: Trace) -> dict:
    ops = sorted(((s, n) for n, (s, _) in tr.by_name.items()),
                 reverse=True)[:10]
    return {"device_ops": [[n[:120], s] for s, n in ops],
            "idle_gaps": [[n[:120], s] for s, n in tr.gaps]}
