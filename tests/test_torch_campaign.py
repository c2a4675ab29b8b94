"""Parity of the PyTorch port's TiledEngine with metadynamics against the
JAX package, on the dilute grid-4³ acid box (tile_safety 0.2, W = 20).

- compute_forces with non-zero bias tables (f_λ, dU/dλ, e_site, e_pot),
  λ inside and outside the grid, at test_torch_engine.py's tolerances.
- A 2-block × 4-step NVE run with in-run deposits (stride 4: one hill a
  block): λ and h_conserved follow JAX at test_torch_engine.py's NVE bars
  (λ 1e-6, h_conserved rtol 2e-6). The tables and ext_work follow from
  the hills' λ, so their bar is the λ bar times a hill's steepest slope:
  1e-6·h0/σ for metad_v and ext_work, 1e-6·h0/σ² for metad_dv (measured on
  the CPU: metad_dv within 1.65e-5, 1.0e-7·h0/σ²).
- A metad_frozen run leaves the tables as they were.

solvated_polypeptide and the replica functions are held in
test_torch_replica.py.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from constant_ph_tpu import metad as jmetad
from constant_ph_tpu.engine import EngineConfig as JConfig
from constant_ph_tpu.tiled.engine import TiledEngine as JEngine
from constant_ph_tpu_torch import metad
from constant_ph_tpu_torch.engine import EngineConfig
from constant_ph_tpu_torch.tiled.engine import TiledEngine

from test_torch_layout import jax_tiled, port_of

# the suite runs six xdist workers on the same cores: one torch thread
# each keeps the port tests from oversubscribing them
torch.set_num_threads(1)

NVE = dict(dt=1.0, thermostat="nve", lambda_thermostat="none",
           rebuild_every=4)
MP = dict(nbins=121, sigma=0.05, h0=0.4, gamma=10.0, stride=4)


@pytest.fixture(scope="module")
def acid():
    _, jts, jst = jax_tiled("dsf", 0.2)
    return (jts, jst) + port_of(jts, jst)


def with_tables(jst, tst, seed=0):
    """Both states with the same seeded non-zero bias tables (1 site)."""
    jp = jmetad.MetadParams(**MP)
    rng = np.random.default_rng(seed)
    V, dV = jmetad.init_tables(1, jp)
    for lam in rng.uniform(0.1, 0.9, size=(6, 1)).astype(np.float32):
        V, dV = jmetad.deposit(V, dV, jnp.asarray(lam), jp)
    jst = jst.replace(metad_v=V, metad_dv=dV)
    tst = dataclasses.replace(tst, metad_v=torch.as_tensor(np.array(V)),
                              metad_dv=torch.as_tensor(np.array(dV)))
    return jst, tst, jp, metad.MetadParams(**MP)


def test_compute_forces_with_tables_matches(acid):
    jts, jst, tts, tst = acid
    jst, tst, jp, tp = with_tables(jst, tst)
    jforces = jax.jit(JEngine(jts, JConfig(**NVE), metad=jp).compute_forces)
    teng = TiledEngine(tts, EngineConfig(**NVE), metad=tp)
    for lam in (0.37, 0.5, 1.17):         # the last outside [lo, hi]
        js = jst.replace(lam=jnp.full_like(jst.lam, lam))
        ts = dataclasses.replace(tst, lam=torch.full_like(tst.lam, lam))
        ref = jforces(js)
        got = teng.compute_forces(ts)
        for name in ("f_lam", "dUdlam", "fs"):
            a = np.asarray(getattr(ref, name))
            scale = max(1.0, np.abs(a).max())
            np.testing.assert_allclose(getattr(got, name).numpy() / scale,
                                       a / scale, atol=3e-6, err_msg=name)
        for name in ("e_site", "e_pot"):
            np.testing.assert_allclose(float(getattr(got, name)),
                                       float(getattr(ref, name)), rtol=1e-5,
                                       atol=1e-4, err_msg=name)
        if lam == 0.5:
            # the bias is in: without it f_λ differs
            bare = TiledEngine(tts, EngineConfig(**NVE)).compute_forces(ts)
            assert float(torch.abs(bare.f_lam - got.f_lam).max()) > 1e-3
    with pytest.raises(ValueError, match="metadynamics tables"):
        TiledEngine(tts, EngineConfig(**NVE), metad=tp).compute_forces(
            acid[3])


def test_nve_run_with_deposits_follows_jax(acid):
    jts, jst, tts, tst = acid
    jst, tst, jp, tp = with_tables(jst, tst, seed=1)
    jst2, jov, jobs = jax.jit(JEngine(jts, JConfig(**NVE), metad=jp)
                              .make_run(8))(jst)
    teng = TiledEngine(tts, EngineConfig(**NVE), metad=tp)
    tst2, tov, tobs = teng.make_run(8)(tst)
    assert bool(tov) == bool(jov) is False
    np.testing.assert_allclose(tobs.lam.numpy(), np.asarray(jobs.lam),
                               atol=1e-6)
    slope = {"metad_v": tp.h0 / tp.sigma, "ext_work": tp.h0 / tp.sigma,
             "metad_dv": tp.h0 / tp.sigma ** 2}
    for name, k in slope.items():
        np.testing.assert_allclose(getattr(tst2, name).numpy(),
                                   np.asarray(getattr(jst2, name)), rtol=0,
                                   atol=1e-6 * k, err_msg=name)
    np.testing.assert_allclose(tobs.h_conserved.numpy(),
                               np.asarray(jobs.h_conserved), rtol=2e-6)
    # two hills landed (one a block), and ext_work booked them
    hills = metad.deposit_many(tst.metad_v, tst.metad_dv,
                               tobs.lam[[3, 7]], tp)
    assert not torch.equal(tst2.metad_v, tst.metad_v)
    assert float(tst2.ext_work) > 0.0
    torch.testing.assert_close(tst2.metad_v, hills[0], rtol=0,
                               atol=1e-5 * float(hills[0].abs().max()))
    # metad_frozen: the bias acts, the tables stay
    frozen = TiledEngine(tts, EngineConfig(**NVE), metad=tp,
                         metad_frozen=True)
    tst3, _, fobs = frozen.make_run(4)(tst)
    assert torch.equal(tst3.metad_v, tst.metad_v)
    assert torch.equal(tst3.metad_dv, tst.metad_dv)
    assert float(tst3.ext_work) == float(tst.ext_work)
    torch.testing.assert_close(fobs.lam[:4], tobs.lam[:4])
