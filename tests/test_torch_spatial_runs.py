"""Runs of the port's tiled engine on x-slabs (parallel/spatial.py) held
to its single-process runs, at 2 ranks of gloo (spawned, one torch thread
each) on the dilute 4³-cell box of tests/test_spatial.py:19-32, retiled
to 16 slots a cell:

- a 10-step NVE run at the bars of tests/test_spatial.py:116-135 (e_pot
  rtol 2e-5, ke rtol 2e-4 / atol 1e-2, solute positions 1e-4 Å);
- the communication: one halo exchange (two messages) a force
  evaluation on every rank, and exactly one all-gather of the tiles a
  rebuild_every block (in place of the JAX package's HLO check at
  tests/test_spatial.py:94, which has no torch analog);
- a Langevin block (atoms and λ) against the single-process run, and λ,
  v_λ and the solute bitwise alike on both ranks;
- PME on slabs (each rank spreads its own cells, the mesh all-reduced)
  against the single-process call within 1e-6 of max;
- the one refusal left, a grid x the ranks do not divide, and the paths
  that refused on slabs until they were ported: FIRE, the pressure and
  factorized Ewald construct on slabs and return finite results
  (tests/test_torch_spatial_minimize.py and test_torch_spatial_ewald.py
  hold them to the single-process paths).
"""
import numpy as np
import pytest

from constant_ph_tpu_torch.parallel import comm

import torch_ranks as tr

W = 16
STEPS = 10
LANG_STEPS = 8


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The single-process runs and PME call, and one spawn of 2 ranks
    running all of them on slabs."""
    one = dict(nve=tr.run_one_thread(tr.slab_run_whole, "dilute", W, tr.NVE,
                                     STEPS),
               langevin=tr.run_one_thread(tr.slab_run_whole, "dilute", W,
                                          tr.LANGEVIN, LANG_STEPS),
               pme=tr.run_one_thread(tr.pme_whole, W))
    ranks = comm.run_ranks(tr.slab_runs, 2, (W, STEPS, LANG_STEPS),
                           init_dir=tmp_path_factory.mktemp("slabs"))
    return one, ranks


def test_nve_on_slabs_follows_single_process(runs):
    one, ranks = runs[0]["nve"], [o["nve"] for o in runs[1]]
    for out in ranks:
        np.testing.assert_allclose(out["e_pot"], one["e_pot"], rtol=2e-5)
        np.testing.assert_allclose(out["ke"], one["ke"], rtol=2e-4,
                                   atol=1e-2)
        np.testing.assert_allclose(out["sx"], one["sx"], atol=1e-4)
        assert not out["overflow"]
    wx = np.concatenate([o["wx"] for o in ranks], axis=1)
    np.testing.assert_allclose(wx, one["wx"], atol=1e-4)


def test_slab_halo_and_gather_counts(runs):
    blocks = -(-STEPS // tr.NVE["rebuild_every"])
    evals = blocks + STEPS            # one at each block start, one a step
    for out in runs[1]:
        st = out["nve"]["stats"]
        assert st["halo_exchange"]["calls"] == evals
        assert st["halo_exchange"]["sends"] == 2 * evals
        assert st["all_gather"]["calls"] == blocks


def test_langevin_on_slabs(runs):
    one, ranks = runs[0]["langevin"], [o["langevin"] for o in runs[1]]
    keys = ("lam", "v_lam", "sx", "sv", "e_pot", "ke", "h")
    tr.assert_tree_equal({k: ranks[0][k] for k in keys},
                         {k: ranks[1][k] for k in keys})
    # the same noise as the single-process run: the trajectories differ
    # by float32 sums taken in another order only
    np.testing.assert_allclose(ranks[0]["e_pot"], one["e_pot"], rtol=2e-5)
    np.testing.assert_allclose(ranks[0]["ke"], one["ke"], rtol=2e-4,
                               atol=1e-2)
    np.testing.assert_allclose(ranks[0]["lam"], one["lam"], atol=1e-5)
    np.testing.assert_allclose(ranks[0]["sx"], one["sx"], atol=1e-4)


def test_pme_on_slabs_matches_single_call(runs):
    e, fw, fs, phi = runs[0]["pme"]
    ranks = [o["pme"] for o in runs[1]]
    fw_s = np.concatenate([o[1] for o in ranks], axis=1)
    scale = np.abs(fw).max()
    np.testing.assert_allclose(fw_s / scale, fw / scale, atol=1e-6)
    for out in ranks:
        np.testing.assert_allclose(out[0], e, rtol=1e-6)
        np.testing.assert_allclose(out[2] / np.abs(fs).max(),
                                   fs / np.abs(fs).max(), atol=1e-6)
        np.testing.assert_allclose(out[3] / np.abs(phi).max(),
                                   phi / np.abs(phi).max(), atol=1e-6)


def test_slab_refusals(runs):
    for ranks in runs[1]:
        out = ranks["refusals"]
        assert "not divisible" in out["grid"]
        assert out["minimize"].shape == (1,)
        for k in ("minimize", "pressure", "ewald"):
            assert np.isfinite(out[k]).all(), k
