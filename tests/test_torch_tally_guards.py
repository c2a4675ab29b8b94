"""The K2 wrapper's refusals and the grid-(1,1,1) tally path, on the boxes
and at the bars of tests/test_torch_tally.py (split from that file so
that no port test file collects more than five tests).
"""
import jax
import pytest
import torch
from constant_ph_tpu.engine import EngineConfig as JConfig
from constant_ph_tpu.systems.water import solvated_acid as jax_solvated_acid
from constant_ph_tpu.tiled import layout as jl
from constant_ph_tpu.tiled.engine import TiledEngine as JEngine
from constant_ph_tpu_torch.engine import EngineConfig
from constant_ph_tpu_torch.tiled import cuda_ww
from constant_ph_tpu_torch.tiled import forces as tf
from constant_ph_tpu_torch.tiled.engine import TiledEngine
from test_torch_layout import port_of

from test_torch_tally import (  # noqa: F401  (fixtures and helpers)
    NVE,
    _engine_close,
    _grids,
    case,
)

# the suite runs six xdist workers on the same cores: one torch thread
# each keeps the port tests from oversubscribing them
torch.set_num_threads(1)


def test_k2_wrapper_refuses_cpu_tensors_and_small_grids(case):
    style, alpha, _, _, tts, tst = case
    p = tts.params
    wt = tf.pack_water_tiles(*_grids(tst, p, tst.wx), tts.water, p)
    kw = dict(style=style, alpha=alpha, rc=tts.cutoff)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ww.water_water_tally_cuda(wt, tst.box, tts.water, p, **kw)
    small = type(p)(grid=(2, 4, 4), W=p.W, half_stencil=p.half_stencil,
                    cutoff=p.cutoff, skin=p.skin)
    with pytest.raises(ValueError, match="grid >= 3"):
        tf.water_water_tally_plain(wt[:2], tst.box, tts.water, small, **kw)
    with pytest.raises(ValueError, match="grid >= 3"):
        cuda_ww.water_water_tally_cuda(wt[:2], tst.box, tts.water, small,
                                       **kw)


def test_grid_below_three_takes_tally_path():
    """A 12.8 Å box gives one cell: K1 and K2 need grid ≥ 3, so the engine
    resets use_pallas_ww and runs water_water with per-pair min image."""
    sys_ = jax_solvated_acid(n_side=4, spacing=3.2, rigid_water=True,
                             lambda_coupled=True, cutoff=6.0, skin=1.0,
                             coul_style="dsf", alpha=0.2, seed=5, pH=5.0)
    jts = jl.split_system(sys_, skin=1.0)
    assert jts.params.grid == (1, 1, 1)
    jst = jl.to_tiled(jts, sys_.state)
    tts, tst = port_of(jts, jst)
    ref = jax.jit(JEngine(jts, JConfig(**NVE)).compute_forces)(jst)
    teng = TiledEngine(tts, EngineConfig(**NVE), use_pallas_ww=True)
    assert teng.use_pallas_ww is False
    got = teng.compute_forces(tst)
    _engine_close(got, ref, ("fw", "fs", "f_lam", "phi_s", "dUdlam"), 3e-6,
                  1e-5, 1e-4)
