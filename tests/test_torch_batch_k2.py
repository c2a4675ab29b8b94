"""K2's plain version on a batch of replicas against the JAX package's
Pallas kernel under jax.vmap.

The batch is R = 3 distinct replicas of the dilute grid-4³ acid box
(test_torch_batch_ops.replicas). water_water_tally (packing and K2's
plain version, water_water_tally_plain) on the batch is held against
jax.vmap(water_water_pallas(..., interpret=True)), whose batching rule
gives the Pallas call a leading grid axis as the CUDA kernel's grid z
dimension does, at the bars tests/test_torch_tally.py holds the single
call to: energies rtol 1e-5 (atol 1e-5 e_lj, 1e-4 e_coul), forces,
per-atom energies and φ scaled by max(1, |ref|max) within 3e-6. The
packed batch is each replica's packing, and the pairs K2's bound counts
are each replica's own.
"""
import jax
import numpy as np
import pytest
import torch

from constant_ph_tpu.tiled.pallas_ww import water_water_pallas
from constant_ph_tpu_torch.tiled import forces as tf

from test_torch_batch_ops import R, replicas
from test_torch_layout import jax_tiled, port_of

# one torch thread per xdist worker, as the other port tests
torch.set_num_threads(1)

STYLE = dict(style="cut", alpha=0.35)


@pytest.fixture(scope="module")
def case():
    _, jts, jst = jax_tiled(**STYLE)
    tts, tst = port_of(jts, jst)
    jb, tb = replicas(jst, tst, seed=4)
    p = jts.params
    shape, vshape = (R, 3) + p.grid + (3 * p.W,), (R,) + p.grid + (p.W,)
    return (jts, jb.wx.reshape(shape), jb.wvalid.reshape(vshape), jb.box,
            tts, tb.wx.reshape(shape), tb.wvalid.reshape(vshape), tb.box)


def _scaled(got, ref, atol=3e-6):
    ref = np.asarray(ref)
    scale = max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(got.numpy() / scale, ref / scale, atol=atol)


def test_k2_plain_batch_matches_vmapped_pallas(case):
    jts, jwx, jwv, jbox, tts, twx, twv, tbox = case
    p = jts.params
    kw = dict(STYLE, rc=p.cutoff)
    got = tf.water_water_tally(twx, twv, tts.water, tts.params, tbox, **kw)
    ref = jax.vmap(lambda wx, wv, box: water_water_pallas(
        wx, wv, jts.water, p, box, interpret=True, **kw))(jwx, jwv, jbox)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-5, atol=1e-5)          # e_lj
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-5, atol=1e-4)          # e_coul
    f_ref = np.stack([np.asarray(ref[2][d]) for d in range(3)], axis=1)
    for r in range(R):
        _scaled(got[2][r], f_ref[r])
        _scaled(got[3][r], np.asarray(ref[3])[r])            # eatom
        _scaled(got[4][r], np.asarray(ref[4])[r])            # φ
    assert abs(float(got[1][0] - got[1][2])) > 1e-2


def test_k2_packing_and_pairs_per_replica(case):
    _, _, _, _, tts, twx, twv, tbox = case
    p = tts.params
    wt = tf.pack_water_tiles(twx, twv, tts.water, p)
    assert wt.shape == (R,) + p.grid + (8, 3 * p.W)
    n = tf.water_pairs_in_cutoff_tally(wt, tbox, p, p.cutoff)
    out = tf.water_water_tally_plain(wt, tbox, tts.water, p, **STYLE,
                                     rc=p.cutoff)
    for r in range(R):
        one = tf.pack_water_tiles(twx[r], twv[r], tts.water, p)
        assert torch.equal(wt[r], one)
        assert int(n[r]) == int(tf.water_pairs_in_cutoff_tally(
            one, tbox[r], p, p.cutoff))
        _scaled(out[r], tf.water_water_tally_plain(
            one, tbox[r], tts.water, p, **STYLE, rc=p.cutoff), atol=1e-6)
