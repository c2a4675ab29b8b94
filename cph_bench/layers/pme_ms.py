"""Device time of one batched call of smooth PME
(ops/pme.pme_recip_tiled, as tiled/engine calls it), in ms: the device
time inside the benchmark's span around it in the traced window, over
its calls."""

SPANS = {"pme_recip_tiled": ("constant_ph_tpu_torch.tiled.engine",
                             "pme_recip_tiled")}


def read(tr, ctx, run):
    n = tr.span_calls.get("pme_recip_tiled", 0)
    s = tr.span_device_s.get("pme_recip_tiled", 0.0)
    return 1e3 * s / n if n and s > 0 else None
