"""A batched 2-block × 4-step NVE run of the port's TiledEngine with PME
at kspace_every 2 and in-run metadynamics deposits, against jax.vmap of
the JAX engine's make_run.

The batch is R = 3 distinct replicas of the PME box of
tests/test_torch_pme.py (the dilute grid-4³ acid, 'cut' α 0.35, 40³
mesh) made by test_torch_batch_ops.replicas (perturbed positions, a box
0.2 % longer a replica, its own λ, λ velocity and pH), each with its own
seeded bias tables; the k-space runs on each replica's live box
(kspace_live_box), so the batched influence function is in the run.
Bars, replica by replica, those of tests/test_torch_pme_nve.py and
tests/test_torch_campaign.py for one state: positions within 1e-4 Å,
velocities 2e-5 Å/fs, λ 1e-6, h_conserved − e_kspace rtol 2e-6,
e_kspace rtol 2e-5 plus the PME self-term atol, the tables and ext_work
1e-6·h0/σ (metad_dv 1e-6·h0/σ²), the MTS carry within 2.5e-4 of its
max; the h_valid rows as JAX's and the flags (R,), all clear.
"""
import jax
import numpy as np
import torch

from constant_ph_tpu.engine import EngineConfig as JConfig
from constant_ph_tpu.tiled.engine import TiledEngine as JEngine
from constant_ph_tpu_torch.engine import EngineConfig
from constant_ph_tpu_torch.tiled.engine import TiledEngine

from test_torch_batch_forces import batch_tables
from test_torch_batch_ops import R, replicas
from test_torch_pme import NVE, _e_atol, _scaled_close, build_case

# one torch thread per xdist worker, as the other port tests
torch.set_num_threads(1)


def test_batched_pme_nve_run_with_deposits_follows_vmapped_jax():
    jts, jst, tts, tst, jpp, tpp = build_case()
    jb, tb = replicas(jst, tst, seed=7)
    jb, tb, jp, tp = batch_tables(jb, tb, seed=8)
    cfg = dict(NVE, kspace_every=2, kspace_live_box=True)
    jeng = JEngine(jts, JConfig(**cfg), kspace_ep=jpp, metad=jp)
    jb2, jov, jobs = jax.jit(jax.vmap(jeng.make_run(8)))(jb)
    teng = TiledEngine(tts, EngineConfig(**cfg), kspace_ep=tpp, metad=tp)
    tb2, tov, tobs = teng.make_run(8)(tb, [torch.Generator()] * R)
    assert tov.shape == (R,) and not tov.any() and not np.asarray(jov).any()
    assert tobs.lam.shape == (R, 8) + tuple(tb.lam.shape[1:])
    bars = {"wx": 1e-4, "sx": 1e-4, "wv": 2e-5}
    slope = {"metad_v": tp.h0 / tp.sigma, "ext_work": tp.h0 / tp.sigma,
             "metad_dv": tp.h0 / tp.sigma ** 2}
    bars.update({k: 1e-6 * v for k, v in slope.items()})
    for name, atol in bars.items():
        np.testing.assert_allclose(getattr(tb2, name).numpy(),
                                   np.asarray(getattr(jb2, name)), rtol=0,
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(tobs.lam.numpy(), np.asarray(jobs.lam),
                               atol=1e-6)
    np.testing.assert_allclose(
        (tobs.h_conserved - tobs.e_kspace).numpy(),
        np.asarray(jobs.h_conserved - jobs.e_kspace), rtol=2e-6)
    np.testing.assert_array_equal(tobs.h_valid.numpy(),
                                  np.asarray(jobs.h_valid))
    for r in range(R):
        np.testing.assert_allclose(tobs.e_kspace[r].numpy(),
                                   np.asarray(jobs.e_kspace)[r], rtol=2e-5,
                                   atol=_e_atol(jts, jst))
        _scaled_close(tb2.phi_recip_s[r].numpy(),
                      np.asarray(jb2.phi_recip_s)[r], 2.5e-4, "phi_recip_s")
    # every replica's hills landed (one a block) and ext_work booked them
    assert (tb2.ext_work > tb.ext_work).all()
    assert not torch.equal(tb2.metad_v[0], tb.metad_v[0])
    assert tb2.step_host == 8 and tb2.step.tolist() == [8] * R
