"""The LJ fluid builder, FIRE and NVE conservation of the port's reference
engine.

- lj_fluid against the JAX builder: positions, masses, types, the pair
  tables, the exclusion tables and the neighbour sizing equal; velocities
  come from the port's own generator (zero total momentum, T near the
  asked one).
- fire_minimize against the JAX package where the two are the same
  algorithm, on flexible water (solvated_acid n_side 4, rigid_water
  False: 190 atoms, no constraints, blocks within the skin), both from
  the same positions: the per-block energy history within rtol 1e-5 and
  the relaxed positions within 1e-4 Å.
- fire_minimize on rigid water with Ewald real space + reciprocal space,
  where the port projects the force onto the constraints (the JAX
  package's FIRE climbs there; constant_ph_tpu_torch/minimize.py): the
  energy falls block after block, the waters stay rigid, the velocities
  are the input's.
- NVE on the LJ fluid with the tests/test_nve.py bar: the spread of
  h_conserved and its drift over 400 steps of 4 fs below 2 % of the mean
  kinetic energy.
"""
import dataclasses

import numpy as np
import torch

from constant_ph_tpu.engine import EngineConfig as JConfig
from constant_ph_tpu.minimize import fire_minimize as jax_fire_minimize
from constant_ph_tpu.systems import lj_fluid as jax_lj_fluid
from constant_ph_tpu.systems.water import solvated_acid as jax_solvated_acid
from constant_ph_tpu_torch import convert, units
from constant_ph_tpu_torch.engine import Engine, EngineConfig
from constant_ph_tpu_torch.minimize import fire_minimize
from constant_ph_tpu_torch.ops.ewald import make_ewald_params, make_kspace_fn
from constant_ph_tpu_torch.systems.lj import lj_fluid
from constant_ph_tpu_torch.systems.water import R_HH, solvated_acid

from test_torch_layout import fields_dict

torch.set_num_threads(1)


def test_lj_fluid_matches_jax():
    for kw in (dict(n_cells=3, T=80.0, seed=3), dict(n_cells=5, seed=1)):
        jff, jst, jnp_ = jax_lj_fluid(**kw)
        ff, st, nbp = lj_fluid(device="cpu", **kw)
        np.testing.assert_array_equal(st.x.numpy(), np.asarray(jst.x))
        np.testing.assert_array_equal(st.box.numpy(), np.asarray(jst.box))
        for name in ("mass", "q0", "type"):
            np.testing.assert_array_equal(getattr(ff, name).numpy(),
                                          np.asarray(getattr(jff, name)))
        for name in ("c12", "c6", "e_shift", "special_lj", "special_coul"):
            np.testing.assert_array_equal(getattr(ff.pair, name).numpy(),
                                          np.asarray(getattr(jff.pair, name)))
        assert (ff.pair.cutoff, ff.pair.alpha, ff.pair.coul_style) == (
            jff.pair.cutoff, jff.pair.alpha, jff.pair.coul_style)
        np.testing.assert_array_equal(ff.excl_idx, np.asarray(jff.excl_idx))
        np.testing.assert_array_equal(ff.excl_code,
                                      np.asarray(jff.excl_code))
        assert nbp == convert.neighbor_params(
            {f.name: getattr(jnp_, f.name) for f in dataclasses.fields(jnp_)})
        assert st.lam.shape == jst.lam.shape == (0,)
        m = ff.mass
        assert torch.abs((m[:, None] * st.v).sum(0)).max() < 1e-3
        T = float(2 * 0.5 * units.MVV2E * (m[:, None] * st.v ** 2).sum()
                  / ((3 * m.shape[0] - 3) * units.BOLTZ))
        assert 0.6 * kw.get("T", 120.0) < T < 1.4 * kw.get("T", 120.0)


def test_fire_energy_history_matches_jax():
    kw = dict(n_side=4, cutoff=6.0, skin=1.5, seed=3, pH=5.0,
              coul_style="dsf", alpha=0.2, rigid_water=False)
    jsys = jax_solvated_acid(**kw)
    tsys = solvated_acid(device="cpu", **kw)
    assert tsys.constraints is None
    cfg = dict(dt=1.0, thermostat="nve", lambda_thermostat="none",
               rebuild_every=5)
    jst, je = jax_fire_minimize(jsys.make_engine(JConfig(**cfg)),
                                jsys.state, n_steps=20)
    st0 = convert.system_state(fields_dict(jsys.state), device="cpu")
    eng = tsys.make_engine(EngineConfig(**cfg))
    st, e = fire_minimize(eng, st0, n_steps=20)
    assert e.shape == (4,)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-5)
    assert float(e[-1]) < float(e[0])
    np.testing.assert_allclose(st.x.numpy(), np.asarray(jst.x), atol=1e-4)


def test_fire_descends_on_rigid_water_with_ewald():
    tsys = solvated_acid(n_side=4, cutoff=6.0, skin=1.5, seed=3, pH=5.0,
                         coul_style="cut", alpha=0.35, device="cpu")
    ep = make_ewald_params(tsys.state.box.numpy(), 0.35, accuracy=1e-5,
                           device="cpu")
    eng = tsys.make_engine(EngineConfig(rebuild_every=5),
                           kspace_fn=make_kspace_fn(ep))
    st0 = tsys.state
    st, e = fire_minimize(eng, st0, n_steps=60)
    assert e.shape == (12,)
    assert bool((e[1:] < e[:-1]).all()), e
    assert torch.equal(st.v, st0.v)
    xm = st.x[tsys.constraints.triplets]
    for a, b, d in ((0, 1, 1.0), (0, 2, 1.0), (1, 2, R_HH)):
        r = torch.linalg.norm(xm[:, a] - xm[:, b], dim=-1)
        assert float(torch.abs(r - d).max()) < 1e-4


def test_lj_nve_conserves_energy():
    ff, state, nbp = lj_fluid(n_cells=3, T=80.0, seed=3, device="cpu")
    eng = Engine(ff, nbp, EngineConfig(dt=4.0, thermostat="nve",
                                       rebuild_every=10))
    state, nbr, obs = eng.run(state, 400)
    e = obs.h_conserved.double().numpy()
    ke = obs.ke.double().numpy()
    assert np.all(np.isfinite(e)) and not bool(nbr.overflow)
    assert np.std(e) < 0.02 * np.mean(ke), (np.std(e), np.mean(ke))
    assert abs(e[-1] - e[0]) < 0.02 * np.mean(ke), (e[0], e[-1])
    assert state.step_host == 400
