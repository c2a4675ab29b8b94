"""The port's x-slab decomposition (parallel/spatial.py,
TiledEngine(spatial=group)) against the JAX package's unsharded forces on
the dilute 4³-cell box of tests/test_spatial.py:19-32, at 2 and 4 ranks
of gloo (spawned, one torch thread each, the port only): energies rtol
1e-5, water forces 1e-5 of max, dU/dλ rtol 1e-4 / atol 1e-3 (the bars of
tests/test_spatial.py:35). Both packages run the box retiled to its
occupancy + 8 (16 slots a cell, the JAX package's retile): the same
molecules in the same cells, fewer parked slots.
"""
import numpy as np
import jax
import pytest

from constant_ph_tpu.engine import EngineConfig as JConfig
from constant_ph_tpu.systems.water import solvated_acid as jax_solvated_acid
from constant_ph_tpu.tiled import layout as jl
from constant_ph_tpu.tiled.engine import TiledEngine as JEngine
from constant_ph_tpu_torch.parallel import comm

import torch_ranks as tr

W = 16


@pytest.fixture(scope="module")
def jax_forces():
    sys_ = jax_solvated_acid(**tr.DILUTE)
    ts = jl.split_system(sys_)
    assert ts.params.grid == (4, 4, 4)
    ts, tst = jl.retile(ts, jl.to_tiled(ts, sys_.state), W)
    frc = jax.jit(JEngine(ts, JConfig(**tr.NVE)).compute_forces)(tst)
    return {k: np.asarray(getattr(frc, k))
            for k in ("fw", "fs", "e_lj", "e_coul", "dUdlam")}


@pytest.fixture(scope="module")
def slabs(tmp_path_factory):
    """One force evaluation on slabs at 2 and at 4 ranks (a spawn each)."""
    return {n: comm.run_ranks(tr.slab_forces, n, ("dilute", W),
                              init_dir=tmp_path_factory.mktemp(f"w{n}"))
            for n in (2, 4)}


@pytest.mark.parametrize("n", [2, 4])
def test_slab_forces_match_jax_unsharded(jax_forces, slabs, n):
    ranks = slabs[n]
    ref = jax_forces
    for out in ranks:
        for k in ("e_lj", "e_coul"):
            np.testing.assert_allclose(out[k], ref[k], rtol=1e-5)
        np.testing.assert_allclose(out["dUdlam"], ref["dUdlam"], rtol=1e-4,
                                   atol=1e-3)
        # the replicated solute's forces and the sums: every rank alike
        tr.assert_tree_equal({k: out[k] for k in ("fs", "e_lj", "e_coul")},
                             {k: ranks[0][k] for k in ("fs", "e_lj",
                                                       "e_coul")})
    # the slabs' water forces in rank order are the whole grid's
    fw = np.concatenate([o["fw"] for o in ranks], axis=1)
    scale = max(1.0, np.abs(ref["fw"]).max())
    np.testing.assert_allclose(fw / scale, ref["fw"] / scale, atol=1e-5)
    scale_s = max(1.0, np.abs(ref["fs"]).max())
    np.testing.assert_allclose(ranks[0]["fs"] / scale_s,
                               ref["fs"] / scale_s, atol=1e-5)


def test_slab_forces_one_halo_exchange(slabs):
    """A force evaluation on slabs exchanges one ghost layer each way
    (two messages), all-reduces once and gathers nothing."""
    for n, ranks in slabs.items():
        for out in ranks:
            st = out["stats"]
            assert st["halo_exchange"]["calls"] == 1
            assert st["halo_exchange"]["sends"] == 2
            assert st["all_reduce"]["calls"] == 1
            assert st["all_gather"]["calls"] == 0
