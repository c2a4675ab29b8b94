"""The port's TiledEngine.compute_forces on a batch of replicas with
metadynamics tables against jax.vmap of the JAX engine's.

The batch is R = 3 distinct replicas of the dilute grid-4³ acid box
(test_torch_batch_ops.replicas: perturbed positions, a box 0.2 % longer
a replica, its own λ and pH), each with its own seeded bias tables. The
bars are tests/test_torch_campaign.py's for one state: f_λ, dU/dλ and
the forces scaled by max(1, |ref|max) within 3e-6, e_site and e_pot
rtol 1e-5 plus atol 1e-4. Then, on the port alone, observe and
compute_Hs of the batch against each replica's single call (1e-6 of the
single's max, rtol 1e-6), and a single state through compute_forces is
the batch of one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from constant_ph_tpu import metad as jmetad
from constant_ph_tpu.engine import EngineConfig as JConfig
from constant_ph_tpu.tiled.engine import TiledEngine as JEngine
from constant_ph_tpu_torch import metad
from constant_ph_tpu_torch.engine import EngineConfig
from constant_ph_tpu_torch.parallel.replica import unstack_replicas
from constant_ph_tpu_torch.tiled.engine import TiledEngine

from test_torch_batch_ops import R, close_to_singles, replicas
from test_torch_layout import jax_tiled, port_of

# one torch thread per xdist worker, as the other port tests
torch.set_num_threads(1)

NVE = dict(dt=1.0, thermostat="nve", lambda_thermostat="none",
           rebuild_every=4)
MP = dict(nbins=121, sigma=0.05, h0=0.4, gamma=10.0, stride=4)


def batch_tables(jb, tb, seed):
    """The batches with their own seeded non-zero bias tables a replica
    (six hills each at seeded λ)."""
    jp = jmetad.MetadParams(**MP)
    rng = np.random.default_rng(seed)
    S = jb.lam.shape[-1]
    Vs, dVs = [], []
    for _ in range(jb.lam.shape[0]):
        V, dV = jmetad.init_tables(S, jp)
        for lam in rng.uniform(0.1, 0.9, size=(6, S)).astype(np.float32):
            V, dV = jmetad.deposit(V, dV, jnp.asarray(lam), jp)
        Vs.append(np.asarray(V))
        dVs.append(np.asarray(dV))
    V, dV = np.stack(Vs), np.stack(dVs)
    return (jb.replace(metad_v=jnp.asarray(V), metad_dv=jnp.asarray(dV)),
            dataclasses.replace(tb, metad_v=torch.as_tensor(V),
                                metad_dv=torch.as_tensor(dV)),
            jp, metad.MetadParams(**MP))


@pytest.fixture(scope="module")
def case():
    _, jts, jst = jax_tiled("dsf", 0.2)
    tts, tst = port_of(jts, jst)
    jb, tb = replicas(jst, tst, seed=5)
    return (jts, tts) + batch_tables(jb, tb, seed=6)


def test_batched_compute_forces_matches_vmapped_jax(case):
    jts, tts, jb, tb, jp, tp = case
    ref = jax.vmap(JEngine(jts, JConfig(**NVE), metad=jp).compute_forces)(
        jb)
    got = TiledEngine(tts, EngineConfig(**NVE), metad=tp).compute_forces(tb)
    for name in ("fw", "fs", "f_lam", "dUdlam"):
        a = np.asarray(getattr(ref, name))
        for r in range(R):
            scale = max(1.0, np.abs(a[r]).max())
            np.testing.assert_allclose(
                getattr(got, name)[r].numpy() / scale, a[r] / scale,
                atol=3e-6, err_msg=f"{name}[{r}]")
    for name in ("e_site", "e_pot"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-4, err_msg=name)
    # each replica's own λ, pH and tables are in: the sites' forces differ
    assert float(torch.abs(got.f_lam[0] - got.f_lam[1]).max()) > 1e-2


def test_batched_observe_and_hs_match_singles(case):
    _, tts, _, tb, _, tp = case
    eng = TiledEngine(tts, EngineConfig(**NVE), metad=tp)
    frc = eng.compute_forces(tb)
    obs = eng.observe(tb, frc)
    HA, HB = eng.compute_Hs(tb)
    singles = unstack_replicas(tb)
    f1 = [eng.compute_forces(s) for s in singles]
    for name in ("fw", "fs", "f_lam", "e_pot", "phi_recip_s"):
        close_to_singles(getattr(frc, name), [getattr(f, name) for f in f1],
                         name)
    o1 = [eng.observe(s, f) for s, f in zip(singles, f1)]
    for name in ("ke", "temp", "ke_lam", "h_conserved", "h_valid", "lam"):
        close_to_singles(getattr(obs, name).to(torch.float32),
                         [getattr(o, name).to(torch.float32) for o in o1],
                         name)
    hs = [eng.compute_Hs(s) for s in singles]
    close_to_singles(HA, [h[0] for h in hs], "HA")
    close_to_singles(HB, [h[1] for h in hs], "HB")
    assert HA.shape == obs.e_pot.shape == (R,)
