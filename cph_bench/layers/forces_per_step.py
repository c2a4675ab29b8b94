"""Force evaluations a batched step in the traced window, from the
program's counter ``forces`` (profiling.counters(), its change across
the traced blocks; cph_bench/program.py): the run loop
(tiled/engine.make_run) evaluates forces once a step and again at each
rebuild block's start, after the rebin. Read where the window ran device
work."""
from cph_bench import program

program.install()


def read(tr, ctx, run):
    n = getattr(tr, "counters", {}).get("forces", 0)
    if not n or not tr.device_ops:
        return None
    return n / tr.batched_steps
