"""The port's x-slab decomposition against the JAX package's unsharded
forces at production water density (tests/test_spatial.py:56-90: 3.1 Å
spacing, n_side 16, the smallest such box whose cell grid's x divides by
2), at 2 ranks of gloo: energies rtol 1e-4, water forces 1e-5 of max
(the bars of tests/test_spatial.py:56). Both packages run the box
retiled to its occupancy + 8 (72 slots a cell)."""
import numpy as np
import jax
import pytest

from constant_ph_tpu.engine import EngineConfig as JConfig
from constant_ph_tpu.systems.water import solvated_acid as jax_solvated_acid
from constant_ph_tpu.tiled import layout as jl
from constant_ph_tpu.tiled.engine import TiledEngine as JEngine
from constant_ph_tpu_torch.parallel import comm

import torch_ranks as tr

W = 72


@pytest.fixture(scope="module")
def jax_forces():
    sys_ = jax_solvated_acid(**tr.DENSE)
    ts = jl.split_system(sys_)
    assert ts.params.grid[0] % 2 == 0
    tst = jl.to_tiled(ts, sys_.state)
    assert int(np.asarray(tst.wvalid).sum(-1).max()) + 8 == W
    ts, tst = jl.retile(ts, tst, W)
    frc = jax.jit(JEngine(ts, JConfig(**tr.NVE)).compute_forces)(tst)
    return {k: np.asarray(getattr(frc, k))
            for k in ("fw", "fs", "e_lj", "e_coul")}


def test_slab_forces_match_jax_production_density(jax_forces, tmp_path):
    ranks = comm.run_ranks(tr.slab_forces, 2, ("dense", W),
                           init_dir=tmp_path)
    ref = jax_forces
    for out in ranks:
        # f32 cross-rank reduction order shifts global sums by O(1e-5)
        # relative at this N (tests/test_spatial.py:68)
        np.testing.assert_allclose(out["e_lj"], ref["e_lj"], rtol=1e-4)
        np.testing.assert_allclose(out["e_coul"], ref["e_coul"], rtol=1e-4)
    fw = np.concatenate([o["fw"] for o in ranks], axis=1)
    scale = max(1.0, np.abs(ref["fw"]).max())
    np.testing.assert_allclose(fw / scale, ref["fw"] / scale, atol=1e-5)
