"""FIRE, the MC barostat, the pressure and the elastic NPT driver of the
port's tiled engine on x-slabs (TiledEngine(spatial=group)) held to its
single-process runs, at 2 ranks of gloo (one spawn, one torch thread a
rank) on the dilute 4³-cell box of tests/test_spatial.py:19-32, retiled
to 16 slots a cell:

- FIRE, 10 steps in 2 blocks: the energy history within rtol 2e-5 and
  the positions within 1e-4 Å (the bars of tests/test_spatial.py:116-135);
- four chained MC moves with fixed uniforms on PME over the live box: the
  same decisions, boxes within rtol 1e-6, every rank's decisions and
  boxes bitwise alike, one broadcast of the decision's inputs a move; the
  pressure within tests/test_torch_npt.py's bar (rtol 2e-3, atol 5 atm);
- the DSF pressure on slabs against the JAX package's unsharded
  make_pressure_fn, at that bar;
- npt_elastic_run in 2 chunks from W 8, where the fullest cells are
  full: one retile to W 16 on every rank alike, the same moves and
  volumes, each chunk's state gathered to the whole grid
  (parallel.spatial.gather_state) within 1e-4 Å of the single process's.
"""
import numpy as np
import jax
import pytest

from constant_ph_tpu.engine import EngineConfig as JConfig
from constant_ph_tpu.systems.water import solvated_acid as jax_solvated_acid
from constant_ph_tpu.tiled import layout as jl
from constant_ph_tpu.tiled import npt as jnpt
from constant_ph_tpu.tiled.engine import TiledEngine as JEngine
from constant_ph_tpu_torch.parallel import comm

import torch_ranks as tr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The single-process paths, and one spawn of 2 ranks running them on
    slabs."""
    one = tr.run_one_thread(tr.minimize_paths)
    ranks = comm.run_ranks(tr.slab_minimize, 2,
                           init_dir=tmp_path_factory.mktemp("slabs"))
    return one, ranks


def _whole(ranks, path, key):
    """The ranks' slabs of a tile array joined along the cell axis."""
    return np.concatenate([o[path][key] for o in ranks], axis=1)


def test_fire_on_slabs_follows_single_process(runs):
    one, ranks = runs[0]["fire"], runs[1]
    assert one["e"].shape == (2,)
    for out in ranks:
        np.testing.assert_allclose(out["fire"]["e"], one["e"], rtol=2e-5)
        np.testing.assert_allclose(out["fire"]["sx"], one["sx"], atol=1e-4)
    tr.assert_tree_equal(ranks[0]["fire"]["sx"], ranks[1]["fire"]["sx"])
    np.testing.assert_allclose(_whole(ranks, "fire", "wx"), one["wx"],
                               atol=1e-4)


def test_mc_moves_on_slabs_take_the_same_decisions(runs):
    one, ranks = runs[0]["mc"], runs[1]
    flags = list(one["accepted"])
    assert True in flags and False in flags
    for out in ranks:
        mc = out["mc"]
        np.testing.assert_array_equal(mc["accepted"], one["accepted"])
        np.testing.assert_allclose(mc["box"], one["box"], rtol=1e-6)
        np.testing.assert_allclose(mc["pressure"], one["pressure"],
                                   rtol=2e-3, atol=5.0)
        # two broadcasts a move (the uniforms, then the energies and the
        # molecule count), the NPT run's two moves included
        assert out["stats"]["broadcast"]["calls"] == 2 * (
            len(tr.MC_U) + len(out["npt"]["volume"]))
    keys = ("accepted", "box", "pressure")
    tr.assert_tree_equal({k: ranks[0]["mc"][k] for k in keys},
                         {k: ranks[1]["mc"][k] for k in keys})
    np.testing.assert_allclose(_whole(ranks, "mc", "wx"), one["wx"],
                               atol=1e-4)


def test_pressure_on_slabs_matches_jax_unsharded(runs):
    sys_ = jax_solvated_acid(**tr.DILUTE)
    ts = jl.split_system(sys_)
    ts, tst = jl.retile(ts, jl.to_tiled(ts, sys_.state), 16)
    ref = float(jax.jit(jnpt.make_pressure_fn(
        JEngine(ts, JConfig(**tr.NVE)), T=tr.MC["T"]))(tst))
    assert np.isfinite(ref)
    for out in runs[1]:
        np.testing.assert_allclose(float(out["mc"]["pressure_dsf"]), ref,
                                   rtol=2e-3, atol=5.0)


def test_npt_elastic_run_on_slabs_retiles_alike(runs):
    one, ranks = runs[0]["npt"], runs[1]
    assert one["retiles"] == 1 and one["W"] > tr.NPT_W
    assert len(one["volume"]) == tr.NPT_STEPS // tr.NPT_CHUNK
    for out in ranks:
        npt = out["npt"]
        assert (npt["retiles"], npt["W"], npt["accepted"]) == (
            one["retiles"], one["W"], one["accepted"])
        np.testing.assert_allclose(npt["volume"], one["volume"], rtol=1e-6)
        np.testing.assert_allclose(npt["e_pot"], one["e_pot"], rtol=2e-5)
        np.testing.assert_allclose(npt["sx"], one["sx"], atol=1e-4)
        # on_chunk's slab gathered to the whole grid on every rank
        np.testing.assert_allclose(npt["chunk_wx"], one["chunk_wx"],
                                   atol=1e-4)
    keys = ("box", "volume", "chunk_wx", "sx")
    tr.assert_tree_equal({k: ranks[0]["npt"][k] for k in keys},
                         {k: ranks[1]["npt"][k] for k in keys})
    np.testing.assert_allclose(_whole(ranks, "npt", "wx"), one["wx"],
                               atol=1e-4)
