"""Device time of the step outside its force evaluation, in ms a batched
step (tiled/engine.TiledEngine.step: BAOAB, λ-RESPA, the Langevin noise,
tile SHAKE/RATTLE): the operations launched inside the program's span
``cph.step`` and in none nested in it, plus those of ``cph.shake``, over
the steps (cph_bench/program.py)."""
from cph_bench import program

program.install()


def read(tr, ctx, run):
    p = program.spans(tr)
    step = p and p.get("cph.step")
    if not step or not step["calls"]:
        return None
    shake = p.get("cph.shake", {}).get("device_s", 0.0)
    return 1e3 * (step["self_device_s"] + shake) / step["calls"]
