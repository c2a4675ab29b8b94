"""Device idle time while the host issues a step, in ms a batched step:
the traced window's idle time inside the program's span ``cph.step``
(tiled/engine.TiledEngine.step) over its calls (cph_bench/program.py)."""
from cph_bench import program

program.install()


def read(tr, ctx, run):
    p = program.spans(tr)
    step = p and p.get("cph.step")
    if not step or not step["calls"]:
        return None
    return 1e3 * step["idle_s"] / step["calls"]
