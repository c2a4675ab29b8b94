"""Device idle share of the traced window: 1 − (union of the device
operations' intervals) ÷ (the first device operation to the end of the
final synchronise), both from one torch.profiler trace."""


def read(tr, ctx, run):
    if tr.window_s <= 0 or tr.device_ops == 0:
        return None
    return 1.0 - tr.busy_s / tr.window_s
