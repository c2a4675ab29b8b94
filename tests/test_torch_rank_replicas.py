"""The replica batch split over ranks (parallel/replica.py with a process
group; here 2 ranks of gloo, spawned, one torch thread each, the port
only) held to the one-process batch at one thread:

- a reference-engine REX run (make_rex_runner, 4 replicas, 3 blocks of 2
  steps with swaps) and a tiled one (make_rex_runner_tiled, K1's plain
  version): each replica's λ and positions bitwise the one-process
  batch's, the pHs after each swap too;
- the swap decided alike on every rank (the all-gathered pHs and
  accepted masks);
- parallel.dryrun.dryrun_multichip(2, device="cpu") runs its three legs
  (the REX block, the spatial leg, the campaign leg with its merge).
"""
import numpy as np
import pytest

from constant_ph_tpu_torch.parallel import comm, dryrun

import torch_ranks as tr

R, BLOCKS = 4, 3


@pytest.fixture(scope="module")
def rex(tmp_path_factory):
    """The one-process batches at one thread, and one spawn of 2 ranks
    running both engines' blocks."""
    one = {kind: tr.run_one_thread(tr.rex_blocks, 0, 1, kind, R, BLOCKS)
           for kind in ("ref", "tiled")}
    ranks = comm.run_ranks(tr.rex_both, 2, (R, BLOCKS),
                           init_dir=tmp_path_factory.mktemp("rex"))
    return one, ranks


@pytest.mark.parametrize("kind", ["ref", "tiled"])
def test_rex_over_ranks_bitwise_per_replica(kind, rex):
    one, ranks = rex[0][kind], [o[kind] for o in rex[1]]
    for k in ("lam", "x", "pH"):
        got = np.concatenate([o[k] for o in ranks], axis=0)
        np.testing.assert_array_equal(got, one[k], err_msg=k)
    np.testing.assert_array_equal(ranks[0]["accepted"], one["accepted"])


def test_swap_alike_on_every_rank(rex):
    for kind in ("ref", "tiled"):
        one, ranks = rex[0][kind], [o[kind] for o in rex[1]]
        for out in ranks:
            np.testing.assert_array_equal(out["all_pH"], one["pH"])
            np.testing.assert_array_equal(out["accepted"],
                                          ranks[0]["accepted"])
        # the pH multiset is kept
        np.testing.assert_array_equal(np.sort(one["pH"]),
                                      np.sort(tr.REX_PHS))


def test_dryrun_multichip_two_ranks_cpu(tmp_path):
    out = dryrun.dryrun_multichip(2, device="cpu", init_dir=tmp_path)
    assert len(out) == 2
    for o in out:
        assert np.all(np.isfinite(o["rex"]["h"]))
        assert np.all(np.isfinite(o["spatial"]["e_pot"]))
        assert o["campaign"]["landed"] > 0.0
    np.testing.assert_array_equal(out[0]["campaign"]["V"],
                                  out[1]["campaign"]["V"])
    np.testing.assert_array_equal(out[0]["spatial"]["sx"],
                                  out[1]["spatial"]["sx"])
