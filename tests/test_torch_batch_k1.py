"""K1's plain version on a batch of replicas against the JAX package's
Pallas kernel under jax.vmap.

The batch is R = 3 distinct replicas of the dilute grid-4³ acid box
(test_torch_batch_ops.replicas: perturbed positions, a box 0.2 % longer
a replica). water_water_fast_plain on the batch is held against
jax.vmap(water_water_pallas_fast(..., interpret=True)), whose batching
rule gives the Pallas call a leading grid axis as the CUDA kernel's grid
z dimension does, at the bars tests/test_torch_forces.py holds the single
call to: energies rtol 1e-5 (atol 1e-5 e_lj, 1e-4 e_coul), forces scaled
by max(1, |f|max) within 3e-6. The dispatcher on a CPU batch is the
plain version, and the pairs K1's bound counts are each replica's own.
"""
import jax
import numpy as np
import pytest
import torch

from constant_ph_tpu.tiled.pallas_ww import water_water_pallas_fast
from constant_ph_tpu_torch.tiled import forces as tf

from test_torch_batch_ops import R, replicas
from test_torch_layout import jax_tiled, port_of

# one torch thread per xdist worker, as the other port tests
torch.set_num_threads(1)

STYLE = dict(style="dsf", alpha=0.2)


@pytest.fixture(scope="module")
def case():
    _, jts, jst = jax_tiled(**STYLE)
    tts, tst = port_of(jts, jst)
    jb, tb = replicas(jst, tst)
    p = jts.params
    shape = (R, 3) + p.grid + (3 * p.W,)
    return jts, jb.wx.reshape(shape), jb.box, tts, tb.wx.reshape(shape), \
        tb.box


def test_k1_plain_batch_matches_vmapped_pallas(case):
    jts, jwx, jbox, tts, twx, tbox = case
    p = jts.params
    kw = dict(STYLE, rc=p.cutoff)
    got = tf.water_water_fast_plain(twx, tts.water, tts.params, tbox, **kw)
    ref = jax.vmap(lambda wx, box: water_water_pallas_fast(
        wx, jts.water, p, box, interpret=True, **kw))(jwx, jbox)
    assert got[0].shape == got[1].shape == (R,)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-5, atol=1e-5)          # e_lj
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-5, atol=1e-4)          # e_coul
    f_ref = np.stack([np.asarray(ref[2][d]) for d in range(3)], axis=1)
    for r in range(R):
        scale = max(1.0, np.abs(f_ref[r]).max())
        np.testing.assert_allclose(got[2][r].numpy() / scale,
                                   f_ref[r] / scale, atol=3e-6)
    # the replicas differ: a batch that read one replica's box for all
    # would not match
    assert abs(float(got[1][0] - got[1][2])) > 1e-2


def test_k1_dispatch_and_pairs_per_replica(case):
    _, _, _, tts, twx, tbox = case
    p = tts.params
    kw = dict(STYLE, rc=p.cutoff)
    disp = tf.water_water_fast(twx, tts.water, p, tbox, **kw)
    plain = tf.water_water_fast_plain(twx, tts.water, p, tbox, **kw)
    for a, b in zip(disp, plain):
        assert torch.equal(a, b)
    n = tf.water_pairs_in_cutoff(twx, p, tbox, p.cutoff)
    assert n.shape == (R,)
    for r in range(R):
        assert int(n[r]) == int(tf.water_pairs_in_cutoff(twx[r], p, tbox[r],
                                                         p.cutoff))
