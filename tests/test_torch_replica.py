"""Parity of the PyTorch port's campaign set-up and replica functions with
the JAX package.

- solvated_polypeptide at the campaign script's ``--small`` settings
  (examples/titration_metad_multisite.py): positions bit-equal, force
  field, λ table, bonded terms and exclusions equal, and the tiles slot
  for slot after split_system / to_tiled.
- swap_phs with JAX's own uniforms; replica_finite, replica_healthy and
  rollback_replicas against JAX on stacked states of the dilute acid box;
  the rollback reseeds the failed replica's generator only; the
  replica-exchange block on the port alone (its Langevin noise is the
  port's own).
- hh_curve, protonation_fraction and the JSONL/CSV writers against JAX.
"""
import dataclasses
import io

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from constant_ph_tpu import observables as jobservables
from constant_ph_tpu.lambda_dyn import BiasParams as JBias
from constant_ph_tpu.parallel import replica as jreplica
from constant_ph_tpu.systems.protein import (
    solvated_polypeptide as jax_polypeptide)
from constant_ph_tpu.tiled import layout as jl
from constant_ph_tpu_torch import convert, observables
from constant_ph_tpu_torch.engine import EngineConfig
from constant_ph_tpu_torch.lambda_dyn import BiasParams
from constant_ph_tpu_torch.parallel import replica
from constant_ph_tpu_torch.systems.protein import solvated_polypeptide
from constant_ph_tpu_torch.tiled import layout as tl
from constant_ph_tpu_torch.tiled.engine import TiledEngine

from test_torch_layout import (assert_same_tiles, fields_dict, jax_tiled,
                               port_of)

# the suite runs six xdist workers on the same cores: one torch thread
# each keeps the port tests from oversubscribing them
torch.set_num_threads(1)

# the campaign script's --small build and split
SMALL = dict(n_residues=8, sites_every=2, box_len=26.0, water_spacing=3.4,
             cutoff=6.0, skin=1.2, coul_style="dsf", alpha=0.2, pH=5.0,
             dq_scale=1.0, n_buffer_waters=8)
SMALL_SPLIT = dict(skin=1.2, tile_safety=1.72)


@pytest.fixture(scope="module")
def acid():
    _, jts, jst = jax_tiled("dsf", 0.2)
    return (jts, jst) + port_of(jts, jst)


def test_polypeptide_matches_jax():
    jsys = jax_polypeptide(**SMALL)
    tsys = solvated_polypeptide(device="cpu", **SMALL)
    np.testing.assert_array_equal(tsys.state.x.numpy(),
                                  np.asarray(jsys.state.x))
    for name in ("mass", "q0", "type"):
        np.testing.assert_array_equal(getattr(tsys.ff, name).numpy(),
                                      np.asarray(getattr(jsys.ff, name)))
    for name in ("c6", "c12", "e_shift", "special_lj", "special_coul"):
        np.testing.assert_array_equal(
            getattr(tsys.ff.pair, name).numpy(),
            np.asarray(getattr(jsys.ff.pair, name)), err_msg=name)
    # the same special pairs with the same codes in every row; the JAX
    # package builds the table with its native C++ code where a
    # compiler is present, which lists a row's 1-3 and 1-4 partners in
    # bond order rather than sorted (its Python fallback, which the port
    # follows, sorts them)
    def pairs(idx, code):
        return [sorted(zip(c.tolist(), i.tolist()))
                for i, c in zip(np.asarray(idx), np.asarray(code))]

    assert pairs(tsys.ff.excl_idx, tsys.ff.excl_code) == pairs(
        jsys.ff.excl_idx, jsys.ff.excl_code)
    for sub in ("spec", "bonded"):
        for name, val in fields_dict(getattr(jsys, sub)).items():
            np.testing.assert_array_equal(
                getattr(getattr(tsys, sub), name).numpy(), val,
                err_msg=f"{sub}.{name}")
    np.testing.assert_array_equal(tsys.groupH_mask.numpy(),
                                  np.asarray(jsys.groupH_mask))
    np.testing.assert_array_equal(tsys.state.lam.numpy(),
                                  np.asarray(jsys.state.lam))
    assert tsys.spec.n_sites == 4
    # velocities come from the port's generator: finite, zero momentum
    v, m = tsys.state.v, tsys.ff.mass
    assert torch.isfinite(v).all()
    assert torch.abs((m[:, None] * v).sum(0)).max() < 1e-3
    # the split and the tiles, slot for slot (on the JAX velocities)
    jts = jl.split_system(jsys, **SMALL_SPLIT)
    tts = tl.split_system(tsys, device="cpu", **SMALL_SPLIT)
    assert tts.params == tl.TileParams(**dataclasses.asdict(jts.params))
    for name, val in fields_dict(jts.solute).items():
        np.testing.assert_array_equal(getattr(tts.solute, name).numpy(), val,
                                      err_msg=name)
    for name, val in fields_dict(jts.spec).items():
        np.testing.assert_array_equal(getattr(tts.spec, name).numpy(), val,
                                      err_msg=name)
    np.testing.assert_array_equal(tts.solute_ids, jts.solute_ids)
    np.testing.assert_array_equal(
        tts.solute_constraints.triplets.numpy(),
        np.asarray(jts.solute_constraints.triplets))
    state = convert.system_state(
        {k: v for k, v in fields_dict(jsys.state).items() if k != "key"},
        device="cpu")
    jst = jl.to_tiled(jts, jsys.state)
    tst = tl.to_tiled(tts, state)
    assert_same_tiles(jst, tst)
    assert tuple(tst.metad_v.shape) == tuple(jst.metad_v.shape) == (0, 0)


def _stacked(jst, R=5, seed=3):
    """R JAX replicas of one state at a pH ladder with seeded λ."""
    rng = np.random.default_rng(seed)
    lam = rng.uniform(-0.05, 1.05, size=(R,) + jst.lam.shape)
    reps = [jst.replace(pH=jnp.asarray(3.0 + r, jnp.float32),
                        lam=jnp.asarray(lam[r], jnp.float32),
                        key=jax.random.PRNGKey(100 + r)) for r in range(R)]
    return reps


def _port_stack(reps):
    return replica.stack_replicas([
        convert.tiled_state(fields_dict(r), device="cpu") for r in reps])


def test_swap_phs_with_jax_uniforms(acid):
    for parity in (0, 1):
        _swap_matches(acid, parity)


def _swap_matches(acid, parity):
    _, jst, _, _ = acid
    reps = _stacked(jst, R=5)
    # flatten λ differences so some swaps are rejected, some accepted
    jb = jreplica.stack_replicas(reps)
    tb = _port_stack(reps)
    bias = BiasParams()
    for k in range(4):
        key = jax.random.PRNGKey(10 * k + parity)
        jnew, jacc = jreplica.swap_phs(jb, key, JBias(), parity)
        u = torch.as_tensor(np.array(jax.random.uniform(key, (5,))))
        tnew, tacc = replica.swap_phs(tb, None, bias, parity, u=u)
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
        np.testing.assert_array_equal(tnew.pH.numpy(), np.asarray(jnew.pH))
        assert sorted(tnew.pH.tolist()) == sorted(tb.pH.tolist())
    # uniforms drawn from a generator: the same seed, the same sweep
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    assert torch.equal(replica.swap_phs(tb, g1, bias, parity)[1],
                       replica.swap_phs(tb, g2, bias, parity)[1])


def test_replica_health_and_rollback_match_jax(acid):
    _, jst, _, _ = acid
    reps = _stacked(jst, R=5)
    prev_j = jreplica.stack_replicas(reps)
    bad = list(reps)
    bad[1] = bad[1].replace(wv=bad[1].wv.at[0, 3, 5].set(jnp.nan))
    bad[2] = bad[2].replace(lam=jnp.full_like(bad[2].lam, 1.4))
    bad[3] = bad[3].replace(v_lam=jnp.full_like(bad[3].v_lam, 0.9))
    bad[4] = bad[4].replace(ext_work=jnp.asarray(jnp.inf, jnp.float32))
    jb = jreplica.stack_replicas(bad)
    tb, prev_t = _port_stack(bad), _port_stack(reps)
    jfin = np.asarray(jreplica.replica_finite(jb))
    tfin = replica.replica_finite(tb)
    np.testing.assert_array_equal(tfin.numpy(), jfin)
    assert jfin.tolist() == [True, False, True, True, False]
    np.testing.assert_array_equal(replica.replica_healthy(tb).numpy(),
                                  np.asarray(jreplica.replica_healthy(jb)))
    assert replica.replica_healthy(tb).tolist() == [True] + [False] * 4
    gens = replica.replica_generators(range(5), "cpu")
    seeds = [g.initial_seed() for g in gens]
    jr = jreplica.rollback_replicas(jb, prev_j, jnp.asarray(jfin), salt=2)
    tr = replica.rollback_replicas(tb, prev_t, tfin, salt=2,
                                   generators=gens)
    for name in ("wx", "wv", "sx", "lam", "v_lam", "pH", "ext_work",
                 "metad_v"):
        np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                      np.asarray(getattr(jr, name)),
                                      err_msg=name)
    # restored bit for bit, healthy replicas untouched, and only the
    # failed replicas' generators reseeded
    for r in (1, 4):
        assert torch.equal(tr.wv[r], prev_t.wv[r])
    for r in (0, 2, 3):
        assert torch.equal(tr.lam[r], tb.lam[r])
    assert [g.initial_seed() != s for g, s in zip(gens, seeds)] == [
        False, True, False, False, True]
    back = replica.unstack_replicas(tr)
    assert len(back) == 5 and torch.equal(back[2].lam, tr.lam[2])


def test_rex_block_and_observables(acid):
    _, jst, tts, _ = acid
    reps = _stacked(jst, R=2)
    tb = _port_stack(reps)
    tb = dataclasses.replace(tb, lam=torch.clamp(tb.lam, 0.05, 0.95))
    cfg = EngineConfig(dt=1.0, thermostat="langevin", gamma=0.01,
                       lambda_thermostat="langevin", rebuild_every=2, seed=4)
    eng = TiledEngine(tts, cfg)
    outs = []
    for _ in range(2):
        block = replica.make_rex_runner_tiled(eng, 2, with_stats=True)
        outs.append(block(tb, torch.Generator().manual_seed(0), 0))
    st, _, acc, ov, stats = outs[0]
    assert tuple(acc.shape) == (2,) and tuple(ov.shape) == (2,)
    assert not bool(ov.any())
    assert sorted(st.pH.tolist()) == sorted(tb.pH.tolist())
    assert tuple(stats["frac_deprot"].shape) == (2, 1)
    assert tuple(stats["obs_last"].temp.shape) == (2,)
    assert torch.isfinite(st.wx).all() and st.step_host == 2
    # per-replica generators seeded from (engine seed, replica): the
    # same runner twice gives the same trajectories, replicas differ
    assert torch.equal(st.wv, outs[1][0].wv)
    assert not torch.equal(st.wv[0], st.wv[1])
    # the host-side observables and HH reference
    lam = stats["obs_last"].lam
    np.testing.assert_array_equal(
        observables.protonation_fraction(lam, burn_in=0.0),
        jobservables.protonation_fraction(lam.numpy(), burn_in=0.0))
    pks, phs = np.array([4.25, 3.65, 6.5]), np.linspace(3.0, 7.0, 9)
    np.testing.assert_array_equal(
        observables.hh_curve(pks[:, None], phs[None, :]),
        jobservables.hh_curve(pks[:, None], phs[None, :]))
    rows = list(observables.observables_to_rows(stats["obs_last"]))
    assert len(rows) == 2 and rows[0]["lam"] == lam[0].tolist()
    # the writers print what the JAX package's print for the same rows
    for name in ("write_jsonl", "write_csv"):
        got, ref = io.StringIO(), io.StringIO()
        getattr(observables, name)(stats["obs_last"], got, step0=4)
        getattr(jobservables, name)(stats["obs_last"], ref, step0=4)
        assert got.getvalue() == ref.getvalue() != ""
