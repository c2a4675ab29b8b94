"""Parity of the PyTorch port's tile force blocks and tile SHAKE with the
JAX package, on the dilute grid-4³ box of tests/test_pallas_ww.py (with
tile_safety 0.2, so W = 20).

water_water_fast_plain (the plain version of the CUDA kernel's function)
is held against both JAX forms of the contract: the XLA
``water_water_fast`` and the Pallas ``water_water_pallas_fast`` in
interpret mode, at the tolerances tests/test_pallas_ww.py holds those two
to each other: energies rtol 1e-5 (atol 1e-5 e_lj, 1e-4 e_coul — the
Coulomb total is a float32 sum of large ± terms), forces scaled by
max(1, |f|max) within 3e-6. The CUDA kernel itself runs only on the GPU;
chip_smoke.py holds it against water_water_fast_plain there.
"""
import numpy as np
import pytest
import torch

from constant_ph_tpu.tiled import forces as jf
from constant_ph_tpu.tiled.pallas_ww import water_water_pallas_fast
from constant_ph_tpu_torch.tiled import cuda_ww
from constant_ph_tpu_torch.tiled import forces as tf
from constant_ph_tpu_torch.tiled.hard_tiles import COULOMB

from test_torch_layout import jax_tiled, port_of

# the suite runs six xdist workers on the same cores: one torch thread
# each keeps the port tests from oversubscribing them
torch.set_num_threads(1)

STYLES = [("dsf", 0.2), ("cut", 0.35)]


@pytest.fixture(scope="module", params=STYLES, ids=lambda s: s[0])
def case(request):
    style, alpha = request.param
    _, jts, jst = jax_tiled(style, alpha)
    tts, tst = port_of(jts, jst)
    return style, alpha, jts, jst, tts, tst


def _grid5(x, p):
    gx, gy, gz = p.grid
    return x.reshape(3, gx, gy, gz, 3 * p.W)


def _assert_ww_close(got, ref):
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-5,
                               atol=1e-5)     # e_lj
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-5,
                               atol=1e-4)     # e_coul
    f_r = np.stack([np.asarray(ref[2][d]) for d in range(3)])
    scale = max(1.0, np.abs(f_r).max())
    np.testing.assert_allclose(got[2].numpy() / scale, f_r / scale,
                               atol=3e-6)


def test_water_water_plain_matches_xla_and_pallas(case):
    style, alpha, jts, jst, tts, tst = case
    p = jts.params
    kw = dict(style=style, alpha=alpha, rc=p.cutoff)
    got = tf.water_water_fast_plain(_grid5(tst.wx, p), tts.water,
                                    tts.params, tst.box, **kw)
    wxg = _grid5(jst.wx, p)
    _assert_ww_close(got, jf.water_water_fast(wxg, jts.water, p, jst.box,
                                              **kw))
    _assert_ww_close(got, water_water_pallas_fast(
        wxg, jts.water, p, jst.box, interpret=True, **kw))
    # on a CPU tensor the dispatching contract is the plain version
    disp = tf.water_water_fast(_grid5(tst.wx, p), tts.water, tts.params,
                               tst.box, **kw)
    for a, b in zip(disp, got):
        assert torch.equal(a, b)


# the hard tiles at their W 24 in each Coulomb setting, and padded with
# parked slots to W 208 (the width configs/hewl_like.json builds, where
# the CUDA kernels stage their stencil in passes)
HARD_WW = [(s, a, None) for s, a in COULOMB] + [("cut", 0.30, 208)]


def test_cuda_wrapper_refuses_cpu_tensors(case):
    style, alpha, _, _, tts, tst = case
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ww.water_water_cuda(_grid5(tst.wx, tts.params), tts.water,
                                 tts.params, tst.box, style=style,
                                 alpha=alpha, rc=tts.cutoff)
