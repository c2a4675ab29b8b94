"""Factorized Ewald k-space and a grid below 3 cells on the port's tiled
engine on x-slabs (TiledEngine(spatial=group)), at 2 ranks of gloo (one
spawn, one torch thread a rank):

- the dilute 4³-cell box of tests/test_spatial.py:19-32 with erfc real
  space (α 0.3; retiled to 16 slots a cell) on Ewald at accuracy 1e-4:
  the forces against the JAX package's unsharded
  TiledEngine(kspace_ep=…).compute_forces at the bars of
  tests/test_torch_tiled_ewald.py (forces, φ and dU/dλ 1e-5 of
  max(1, |ref|max); energies rtol 2e-5 plus 2e-5 of the self term), and
  against the port's single-process call (forces 1e-5 of max, energies
  rtol 2e-5); a 10-step NVE run at the bars of
  tests/test_spatial.py:116-135; compute_Hs (K2's slab entry's plain
  version, the water's tallies) within rtol 2e-5;
- the same box on a hand-made 2 × 4 × 4 grid (the plain tally path):
  the forces, energies and compute_Hs within 1e-6 of max / rtol 1e-6 of
  the single-process call, through one all-gather of the tiles and no
  halo exchange.
"""
import numpy as np
import jax
import pytest

from constant_ph_tpu.engine import EngineConfig as JConfig
from constant_ph_tpu.ops import ewald as jewald
from constant_ph_tpu.systems.water import solvated_acid as jax_solvated_acid
from constant_ph_tpu.tiled import layout as jl
from constant_ph_tpu.tiled.engine import TiledEngine as JEngine
from constant_ph_tpu_torch.parallel import comm

import torch_ranks as tr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The single-process paths, and one spawn of 2 ranks running them on
    slabs."""
    one = tr.run_one_thread(tr.ewald_paths)
    ranks = comm.run_ranks(tr.slab_ewald, 2,
                           init_dir=tmp_path_factory.mktemp("slabs"))
    return one, ranks


def _scaled(a, b, atol, floor=1.0):
    scale = max(floor, float(np.abs(b).max()))
    np.testing.assert_allclose(np.asarray(a) / scale, np.asarray(b) / scale,
                               atol=atol)


def _whole(ranks, kind, key):
    """The ranks' rows of a water array joined along the cell axis."""
    axis = 1 if key == "fw" else 0
    return np.concatenate([o[kind][key] for o in ranks], axis=axis)


def test_ewald_forces_on_slabs_match_jax_unsharded(runs):
    sys_ = jax_solvated_acid(**tr.EWALD)
    ts = jl.split_system(sys_)
    ts, tst = jl.retile(ts, jl.to_tiled(ts, sys_.state), 16)
    ep = jewald.make_ewald_params(np.asarray(tst.box), tr.EWALD["alpha"])
    ref = jax.jit(JEngine(ts, JConfig(**tr.NVE),
                          kspace_ep=ep).compute_forces)(tst)
    # 2e-5 of the self term Cα/√π·Σq² (float64): each package sums Σq²
    # in float32 in its own order
    q2 = (np.sum(np.tile(ts.water.q_pattern, ts.params.W) ** 2
                 * np.repeat(np.asarray(tst.wvalid, np.float64), 3, axis=-1))
          + np.sum(np.asarray(ts.solute.q0, np.float64) ** 2))
    atol = 2e-5 * 332.06371 * tr.EWALD["alpha"] / np.sqrt(np.pi) * q2
    one, ranks = runs[0]["ewald"], runs[1]
    got = {k: ranks[0]["ewald"][k] for k in ("fs", "dUdlam", "phi_s")}
    got["fw"] = _whole(ranks, "ewald", "fw")
    for k, v in got.items():
        _scaled(v, np.asarray(getattr(ref, k)), 1e-5)
        _scaled(v, one[k], 1e-5)
    for out in ranks:
        for k in ("e_lj", "e_coul", "e_kspace", "e_pot"):
            np.testing.assert_allclose(out["ewald"][k],
                                       float(getattr(ref, k)), rtol=2e-5,
                                       atol=atol, err_msg=k)
            np.testing.assert_allclose(out["ewald"][k], one[k], rtol=2e-5,
                                       err_msg=k)
        # one halo exchange, the real-space sums and the water's S(k) in
        # an all-reduce each, nothing gathered
        st = out["ewald"]["stats"]
        assert (st["halo_exchange"]["calls"], st["all_reduce"]["calls"],
                st["all_gather"]["calls"]) == (1, 2, 0)
    keys = ("fs", "e_pot", "dUdlam")
    tr.assert_tree_equal({k: ranks[0]["ewald"][k] for k in keys},
                         {k: ranks[1]["ewald"][k] for k in keys})


def test_ewald_nve_run_on_slabs(runs):
    one, ranks = runs[0]["nve"], [o["nve"] for o in runs[1]]
    assert one["e_pot"].shape == (tr.EWALD_STEPS,)
    for out in ranks:
        np.testing.assert_allclose(out["e_pot"], one["e_pot"], rtol=2e-5)
        np.testing.assert_allclose(out["ke"], one["ke"], rtol=2e-4,
                                   atol=1e-2)
        np.testing.assert_allclose(out["sx"], one["sx"], atol=1e-4)
        assert not out["overflow"]
    tr.assert_tree_equal({k: ranks[0][k] for k in ("lam", "sx", "e_pot")},
                         {k: ranks[1][k] for k in ("lam", "sx", "e_pot")})
    wx = np.concatenate([o["wx"] for o in ranks], axis=1)
    np.testing.assert_allclose(wx, one["wx"], atol=1e-4)


def test_ewald_compute_hs_on_slabs(runs):
    one, ranks = runs[0]["ewald"], runs[1]
    for out in ranks:
        for k in ("HA", "HB"):
            np.testing.assert_allclose(out["ewald"][k], one[k], rtol=2e-5)
    _scaled(_whole(ranks, "ewald", "eatom_w"), one["eatom_w"], 1e-5)
    _scaled(ranks[0]["ewald"]["eatom_s"], one["eatom_s"], 1e-5)


def test_grid2_box_on_two_ranks(runs):
    one, ranks = runs[0]["grid2"], runs[1]
    assert [o["grid2"]["fw"].shape[1] for o in ranks] == [
        one["fw"].shape[1] // 2] * 2
    _scaled(_whole(ranks, "grid2", "fw"), one["fw"], 1e-6, floor=0.0)
    for out in ranks:
        g2 = out["grid2"]
        _scaled(g2["fs"], one["fs"], 1e-6, floor=0.0)
        for k in ("e_lj", "e_coul", "e_pot", "HA", "HB"):
            np.testing.assert_allclose(g2[k], one[k], rtol=1e-6, err_msg=k)
        # the whole grid's tiles gathered once; no halo, nothing summed
        st = g2["stats"]
        assert (st["all_gather"]["calls"], st["halo_exchange"]["calls"],
                st["all_reduce"]["calls"]) == (1, 0, 0)
