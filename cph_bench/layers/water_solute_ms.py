"""Device time of one batched call of the water×solute block
(tiled/forces.water_solute_fast), in ms: the device time inside the
benchmark's span around it in the traced window, over its calls."""

SPANS = {"water_solute_fast": ("constant_ph_tpu_torch.tiled.forces",
                               "water_solute_fast")}


def read(tr, ctx, run):
    n = tr.span_calls.get("water_solute_fast", 0)
    s = tr.span_device_s.get("water_solute_fast", 0.0)
    return 1e3 * s / n if n and s > 0 else None
