"""Kernel K1's share of its roofline (csrc/ww_pair.cu), in %: the least
time of its launches (cph_bench/roofline.py: the water pairs inside rc
at the window's last state, the same for every launch of the window,
times the FLOP a pair, over the FP32 peak) over K1's device time in the
trace. Its launch is the pair kernel and its energy reduction. The
pairs are counted from the tiles K1 reads (run.batch of a tiled
driver): each valid slot one water."""
import torch

from cph_bench import roofline

KERNELS = ("ww_pair_kernel", "energy_sum_kernel")


def _pairs(run, rc):
    """(water pairs inside rc summed over the batch, tile atoms summed
    over the batch)."""
    st = run.batch
    pairs = 0
    for r in range(st.wx.shape[0]):
        cells, slots = torch.nonzero(st.wvalid[r] > 0.5, as_tuple=True)
        x = torch.stack([st.wx[r][:, cells, 3 * slots + a].T
                         for a in range(3)], dim=1)        # (M, 3, 3)
        pairs += roofline.water_pairs_in_cutoff(
            x.to(torch.float32), st.box[r].to(torch.float32), rc)
    return pairs, int(st.wx[0, 0].numel()) * st.wx.shape[0]


def read(tr, ctx, run):
    seconds, launches = 0.0, 0
    for name, (s, n) in tr.by_name.items():
        if any(k in name for k in KERNELS):
            seconds += s
            launches += n * (KERNELS[0] in name)
    if not launches or seconds <= 0:
        return None
    params = ctx.config["builder"]["params"]
    pairs, slots = _pairs(run, float(params["cutoff"]))
    least = launches * roofline.k1_least_seconds(pairs, slots,
                                                 params["coul_style"])
    return 100.0 * least / seconds
