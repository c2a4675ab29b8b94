"""Device operations (kernels, copies, sets) of the traced window per
batched step (the whole batch one step on): what the run loop
(tiled/engine.make_run) launches."""


def read(tr, ctx, run):
    if tr.device_ops == 0:
        return None
    return tr.device_ops / tr.batched_steps
