"""Device idle time outside the steps, in ms a driver block: the traced
window's idle time less that inside the program's span ``cph.step``,
over the driver's blocks (batched steps ÷ steps a block). It is the
idle time of the block boundary (rebin, the force evaluation at each
rebuild block's start, the drift check, the observables, the driver's
hill merges) (cph_bench/program.py)."""
from cph_bench import program

program.install()


def read(tr, ctx, run):
    p = program.spans(tr)
    step = p and p.get("cph.step")
    if not step or not step["calls"]:
        return None
    blocks = tr.batched_steps / run.steps_per_block
    return 1e3 * (tr.window_s - tr.busy_s - step["idle_s"]) / blocks
