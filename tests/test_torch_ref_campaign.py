"""Replica exchange and ΔG_ref calibration on the port's reference engine,
against the JAX package, on a 190-atom box (solvated_acid n_side 4, DSF
α 0.2, rc 6, the all-pairs list), both packages from the same float32
positions and velocities.

- make_rex_runner: 3 replicas at pH 4, 5 and 6 with λ 0.3, 0.5 and 0.7,
  each with its own neighbour list, one 8-step NVE block (λ moving) and
  an even swap fed the JAX block's own uniforms: the accept mask and the
  pH values equal, positions within 1e-4 Å and λ within 1e-6 (the bars
  of tests/test_torch_ref_engine.py's NVE run), the last observables'
  h_conserved within rtol 1e-5.
- calibrate_dG_ref: NVE, λ frozen, 2 nodes, 4 + 8 steps a node, no FIRE
  (the port's FIRE departs from the JAX package's on rigid water by
  design, constant_ph_tpu_torch/minimize.py): ΔG_ref within rtol 1e-4 of
  JAX's (measured 3.7e-6 on the CPU: a mean of 8 float32 dU/dλ values
  along slightly different trajectories).
- A Langevin REX sweep on the port alone (generators made by the runner,
  uniforms from the swap generator, both parities): the pH multiset is
  kept, the run stays finite, and a second runner with the same seeds
  repeats it bit for bit.

The JAX side compiles three small functions here (the REX block and the
calibration's two runs; ~3 s each on 190 atoms).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from constant_ph_tpu.engine import EngineConfig as JConfig
from constant_ph_tpu.parallel import replica as jrep
from constant_ph_tpu.systems.water import solvated_acid as jax_solvated_acid
from constant_ph_tpu.titration import calibrate_dG_ref as jax_calibrate
from constant_ph_tpu_torch import convert
from constant_ph_tpu_torch.engine import EngineConfig
from constant_ph_tpu_torch.parallel import replica
from constant_ph_tpu_torch.systems.water import solvated_acid
from constant_ph_tpu_torch.titration import calibrate_dG_ref

from test_torch_layout import fields_dict

torch.set_num_threads(1)

SYSTEM = dict(n_side=4, cutoff=6.0, skin=1.5, seed=3, pH=5.0,
              coul_style="dsf", alpha=0.2)
NVE = dict(dt=1.0, thermostat="nve", lambda_thermostat="none",
           rebuild_every=4)


def test_rex_block_matches_jax():
    jsys = jax_solvated_acid(**SYSTEM)
    tsys = solvated_acid(device="cpu", **SYSTEM)
    jeng = jsys.make_engine(JConfig(**NVE))
    teng = tsys.make_engine(EngineConfig(**NVE))
    jstates = [jsys.state.replace(
        pH=jnp.asarray(ph, jnp.float32), lam=jnp.asarray([lam], jnp.float32),
        key=jax.random.PRNGKey(i))
        for i, (ph, lam) in enumerate(((4.0, 0.3), (5.0, 0.5), (6.0, 0.7)))]
    R = len(jstates)
    nbr = jeng.build_neighbors(jsys.state.x, jsys.state.box)
    jbatch = jrep.stack_replicas(jstates)
    jnbrs = jax.tree.map(lambda a: jnp.broadcast_to(a[None], (R,) + a.shape),
                         nbr)
    key = jax.random.PRNGKey(42)
    jout = jax.jit(jrep.make_rex_runner(jeng, 8), static_argnums=3)(
        jbatch, jnbrs, key, 0)
    u = np.asarray(jax.random.uniform(jax.random.split(key)[1], (R,)))

    tbatch = replica.stack_replicas(
        [convert.system_state(fields_dict(s), device="cpu")
         for s in jstates])
    tnbr = convert.neighbor_list(fields_dict(nbr), device="cpu")
    tnbrs = replica.stack_replicas([tnbr] * R)
    gen = torch.Generator().manual_seed(0)
    block = replica.make_rex_runner(teng, 8)
    states, nbrs, gen2, acc, last = block(tbatch, tnbrs, gen,
                                          0, u=torch.as_tensor(np.array(u)))
    assert gen2 is gen and len(block.generators) == R
    jstates2, jnbrs2, _, jacc, jlast = jout
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(states.pH.numpy(), np.asarray(jstates2.pH))
    assert sorted(states.pH.tolist()) == [4.0, 5.0, 6.0]
    np.testing.assert_allclose(states.x.numpy(), np.asarray(jstates2.x),
                               atol=1e-4)
    np.testing.assert_allclose(states.lam.numpy(), np.asarray(jstates2.lam),
                               atol=1e-6)
    np.testing.assert_allclose(last.h_conserved.numpy(),
                               np.asarray(jlast.h_conserved), rtol=1e-5)
    assert nbrs.idx.shape == (R,) + tnbr.idx.shape
    np.testing.assert_allclose(nbrs.x_ref.numpy(), np.asarray(jnbrs2.x_ref),
                               atol=1e-4)
    assert states.step_host == 8


def test_calibrate_dG_ref_matches_jax():
    jsys = jax_solvated_acid(**SYSTEM)
    tsys = solvated_acid(device="cpu", **SYSTEM)
    tsys = dataclasses.replace(
        tsys, state=convert.system_state(fields_dict(jsys.state),
                                         device="cpu"))
    # no FIRE: on rigid water the port's FIRE takes the force tangent to
    # the constraints and the JAX package's does not (test_torch_lj_fire)
    kw = dict(site=0, equil_steps=4, sample_steps=8, minimize_steps=0,
              nodes=[0.2, 0.8], weights=[0.5, 0.5])
    cfg = dict(NVE, rebuild_every=5)
    ref = jax_calibrate(jsys, JConfig(**cfg), **kw)
    got = calibrate_dG_ref(tsys, EngineConfig(**cfg), **kw)
    assert np.isfinite(got) and abs(got) > 1.0
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_rex_langevin_keeps_ph_multiset():
    tsys = solvated_acid(device="cpu", **SYSTEM)
    cfg = EngineConfig(dt=1.0, thermostat="langevin", gamma=0.01,
                       lambda_thermostat="langevin", rebuild_every=4, seed=5)
    eng = tsys.make_engine(cfg)
    phs = (4.0, 5.0, 6.0, 7.0)
    batch = replica.stack_replicas([
        dataclasses.replace(tsys.state, pH=torch.tensor(ph)) for ph in phs])
    nbr = eng.build_neighbors(tsys.state.x, tsys.state.box)
    nbrs = replica.stack_replicas([nbr] * len(phs))

    def sweep():
        block = replica.make_rex_runner(eng, 4)
        gen = torch.Generator().manual_seed(1)
        st, nb = batch, nbrs
        for parity in (0, 1):
            st, nb, gen, acc, last = block(st, nb, gen, parity)
        return st, acc, last

    st, acc, last = sweep()
    assert sorted(st.pH.tolist()) == sorted(phs)
    assert bool(replica.replica_finite(st).all())
    assert torch.isfinite(last.h_conserved).all()
    st_b, acc_b, _ = sweep()
    assert torch.equal(st.x, st_b.x) and torch.equal(acc, acc_b)
