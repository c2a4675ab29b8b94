"""The reference engine's run on a replica batch, against ``jax.vmap`` of
the JAX package's and against the port's own looped runs, on R = 3
replicas of a 1,537-atom box (solvated_acid n_side 8, rc 6, skin 0.3:
the cell path on a 3³ grid; 'cut' α 0.35 + factorized Ewald, rigid
water, λ moving with the λ-RESPA drift). The replicas share the
positions and differ in velocities (× 1.6, × 0, × 1), λ (0.3, 0.5, 0.7)
and pH (4, 5, 6), so that at the second block's start replicas 0 and 2
have moved past skin/2 (0.34 and 0.21 Å) and rebuild their lists while
replica 1 (0.07 Å) keeps its own.

- A 2 × 4-step NVE block of make_rex_runner in both packages, JAX's
  jitted (its block is jax.vmap(make_run) and the swap, so this one
  compile gives both references), the port's fed JAX's swap uniforms:
  the batched run leaves each replica where JAX's vmapped run does, at
  the bars of tests/test_torch_ref_engine.py (positions 1e-4 Å,
  velocities 2e-5 Å/fs, λ 1e-6, h_conserved within 1e-6 of the energy
  scale), with the same replicas rebuilt; the accept mask and the pH
  permutation equal JAX's. The port's block makes one run call for all
  R and one list build a rebuild_every block (counted by wrapping
  Engine.make_run and build_neighbor_list), and equals that batched run
  followed by the swap, bit for bit.
- A 2 × 2-step Langevin run (atoms and λ) of the batch with one
  torch.Generator a replica against R single runs fed generators of the
  same seeds:
  replica r draws its noise from its own generator in its single run's
  order, and the batch does each replica's arithmetic (bitwise on the
  CPU, measured).
- The CLI's titrate rex (the port's, on the CPU) runs each block of all
  replicas as one run call, with one list build at the start and one a
  rebuild_every block, each on the whole batch (counted).
"""
import contextlib
import io
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from constant_ph_tpu.engine import EngineConfig as JConfig
from constant_ph_tpu.ops.ewald import make_ewald_params as jax_ewald_params
from constant_ph_tpu.ops.ewald import make_kspace_fn as jax_kspace_fn
from constant_ph_tpu.parallel import replica as jrep
from constant_ph_tpu.systems.water import solvated_acid as jax_solvated_acid
from constant_ph_tpu_torch import cli, convert, engine as engine_mod
from constant_ph_tpu_torch.engine import Engine, EngineConfig
from constant_ph_tpu_torch.ops.ewald import make_ewald_params, make_kspace_fn
from constant_ph_tpu_torch.parallel import replica
from constant_ph_tpu_torch.systems.water import solvated_acid

from test_torch_layout import fields_dict
from test_torch_ref_engine import energy_scale

torch.set_num_threads(1)

SYSTEM = dict(n_side=8, cutoff=6.0, skin=0.3, seed=9, pH=5.0,
              coul_style="cut", alpha=0.35)
NVE = dict(dt=1.0, thermostat="nve", lambda_thermostat="none",
           rebuild_every=4)
LANGEVIN = dict(dt=1.0, thermostat="langevin", T=300.0, gamma=0.01,
                lambda_thermostat="langevin", rebuild_every=2, seed=9)
# (velocity scale, λ, pH) a replica
REPLICAS = ((1.6, 0.3, 4.0), (0.0, 0.5, 5.0), (1.0, 0.7, 6.0))
R = len(REPLICAS)
STEPS = 8


def _engine(tsys, box, **cfg):
    return tsys.make_engine(EngineConfig(**cfg), kspace_fn=make_kspace_fn(
        make_ewald_params(box, 0.35, accuracy=1e-5, device="cpu")))


@pytest.fixture(scope="module")
def case():
    jsys = jax_solvated_acid(**SYSTEM)
    tsys = solvated_acid(device="cpu", **SYSTEM)
    box = np.asarray(jsys.state.box)
    jeng = jsys.make_engine(JConfig(**NVE), kspace_fn=jax_kspace_fn(
        jax_ewald_params(box, 0.35, accuracy=1e-5)))
    jst = jsys.state
    jstates = jrep.stack_replicas([jst.replace(
        v=jst.v * sc, lam=jnp.asarray([lam], jnp.float32),
        pH=jnp.asarray(ph, jnp.float32), key=jax.random.PRNGKey(r))
        for r, (sc, lam, ph) in enumerate(REPLICAS)])
    key = jax.random.PRNGKey(42)

    @jax.jit
    def jax_block(states, key):
        nbr = jeng.build_neighbors(states.x[0], states.box[0])
        nbrs = jax.tree.map(
            lambda a: jnp.broadcast_to(a[None], (R,) + a.shape), nbr)
        block = jrep.make_rex_runner(jeng, STEPS)
        return nbrs, block(states, nbrs, key, 0)

    jnbrs, jout = jax_block(jstates, key)
    u = np.array(jax.random.uniform(jax.random.split(key)[1], (R,)))
    # the port starts from the JAX states and lists
    tbatch = replica.stack_replicas([
        convert.system_state({k: v[r] for k, v in fields_dict(jstates)
                              .items() if k != "key"}, device="cpu")
        for r in range(R)])
    tnbrs = replica.stack_replicas([
        convert.neighbor_list({k: v[r] for k, v in fields_dict(jnbrs)
                               .items()}, device="cpu") for r in range(R)])
    # the energy scale of the NVE replica's forces
    frc = _engine(tsys, box, **NVE).compute_forces(
        tbatch.x, tbatch.lam, tbatch.box, tbatch.pH, tnbrs)
    return dict(tsys=tsys, box=box, jout=jout, u=torch.as_tensor(u),
                tbatch=tbatch, tnbrs=tnbrs,
                scale=energy_scale(replica.unstack_replicas(frc)[1]))


@pytest.fixture(scope="module")
def nve(case):
    """The port's batched NVE run of the replicas from JAX's lists."""
    eng = _engine(case["tsys"], case["box"], **NVE)
    return eng.make_run(STEPS)(case["tbatch"], case["tnbrs"])


def _counting(monkeypatch, runs, builds):
    """Engine.make_run wrapped so each run call records its batch size,
    and the engine's build_neighbor_list so each build records its."""
    make_run = Engine.make_run
    build = engine_mod.build_neighbor_list

    def counted(eng, n_steps):
        run = make_run(eng, n_steps)

        def run_counted(state, nbr, generators=None):
            runs.append(state.x.shape[0] if state.x.ndim == 3 else None)
            return run(state, nbr, generators)
        return run_counted

    def build_counted(x, *args):
        builds.append(x.shape[0] if x.ndim == 3 else None)
        return build(x, *args)

    monkeypatch.setattr(Engine, "make_run", counted)
    monkeypatch.setattr(engine_mod, "build_neighbor_list", build_counted)


def test_batched_nve_run_matches_jax_vmap(case, nve):
    got, nbrs, obs = nve
    jst, jnbrs, _, _, jlast = case["jout"]
    assert obs.temp.shape == (R, STEPS) and obs.lam.shape == (R, STEPS, 1)
    assert nbrs.overflow.shape == (R,) and not bool(nbrs.overflow.any())
    # replicas 0 and 2 rebuilt at the second block's start, 1 did not: in
    # both packages
    x0 = case["tbatch"].x
    kept = [torch.equal(nbrs.x_ref[r], x0[r]) for r in range(R)]
    assert kept == [False, True, False]
    assert [np.array_equal(np.asarray(jnbrs.x_ref[r]), x0[r].numpy())
            for r in range(R)] == kept
    assert torch.equal(nbrs.idx[1], case["tnbrs"].idx[1])
    # the rebuilt lists' reference positions are the step-4 positions
    np.testing.assert_allclose(nbrs.x_ref.numpy(), np.asarray(jnbrs.x_ref),
                               atol=1e-4)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(jst.x), atol=1e-4)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(jst.v), atol=2e-5)
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(jst.lam),
                               atol=1e-6)
    assert float(torch.abs(obs.lam[:, -1] - obs.lam[:, 0]).max()) > 1e-5
    np.testing.assert_allclose(obs.h_conserved[:, -1].numpy(),
                               np.asarray(jlast.h_conserved), rtol=0,
                               atol=1e-6 * case["scale"])
    assert int(got.step[0]) == got.step_host == STEPS


def test_rex_runner_one_batched_run_a_block(case, nve, monkeypatch):
    runs, builds = [], []
    _counting(monkeypatch, runs, builds)
    eng = _engine(case["tsys"], case["box"], **NVE)
    block = replica.make_rex_runner(eng, STEPS)
    gen = torch.Generator().manual_seed(0)
    states, nbrs, gen2, acc, last = block(case["tbatch"], case["tnbrs"],
                                          gen, 0, u=case["u"])
    # one run call for all R, one build a rebuild_every block
    assert runs == [R] and builds == [R] * (STEPS // NVE["rebuild_every"])
    assert gen2 is gen and len(block.generators) == R
    jst, jnbrs, _, jacc, jlast = case["jout"]
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(states.pH.numpy(), np.asarray(jst.pH))
    assert sorted(states.pH.tolist()) == [4.0, 5.0, 6.0]
    assert last.temp.shape == (R,)
    # the block is the batched run followed by the swap
    ref, ref_nbrs, obs = nve
    ref, ref_acc = replica.swap_phs(ref, None, eng.bias, 0, u=case["u"])
    assert torch.equal(acc, ref_acc)
    for name in ("x", "v", "lam", "pH", "ext_work"):
        assert torch.equal(getattr(states, name), getattr(ref, name)), name
    assert torch.equal(nbrs.idx, ref_nbrs.idx)
    assert torch.equal(last.h_conserved, obs.h_conserved[:, -1])


def test_batched_langevin_follows_looped_runs(case):
    eng = _engine(case["tsys"], case["box"], **LANGEVIN)
    run = eng.make_run(4)

    def gens():
        return replica.replica_generators([100 + r for r in range(R)],
                                          "cpu")

    got, nbrs, obs = run(case["tbatch"], case["tnbrs"], gens())
    assert obs.temp.shape == (R, 4)
    for r, g in enumerate(gens()):
        one = replica.unstack_replicas(case["tbatch"])[r]
        want, wnbr, wobs = run(one, replica.unstack_replicas(
            case["tnbrs"])[r], g)
        for name in ("x", "v", "lam", "v_lam", "ext_work"):
            assert torch.equal(getattr(got, name)[r], getattr(want, name)), \
                (r, name)
        assert torch.equal(nbrs.idx[r], wnbr.idx)
        for name in ("h_conserved", "temp", "lam"):
            assert torch.equal(getattr(obs, name)[r], getattr(wobs, name)), \
                (r, name)
    # each replica drew its own noise and the thermostats did work
    assert not torch.equal(obs.lam[0], obs.lam[1])
    assert (got.ext_work != case["tbatch"].ext_work).all()


def test_titrate_rex_runs_one_batch_a_block(tmp_path, monkeypatch):
    runs, builds = [], []
    _counting(monkeypatch, runs, builds)
    cfg = dict(system=dict(builder="solvated_acid", n_side=3, pH=5.0,
                           pK=4.25, cutoff=4.5, coul_style="dsf", alpha=0.2,
                           rigid_water=True),
               engine=dict(LANGEVIN, rebuild_every=5),
               run=dict(tiled=False, steps_per_swap=10, n_swaps=3))
    path = tmp_path / "rex.json"
    path.write_text(json.dumps(cfg))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["titrate", str(path), "--device", "cpu",
                  "--ph", "4.0,5.0,6.0"])
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["pH"] == [4.0, 5.0, 6.0]
    assert np.all(np.isfinite(res["deprotonated_fraction"]))
    # one run call a block for the three replicas; one list build for
    # the batch at the start, then one a rebuild_every block
    assert runs == [3] * 3
    assert builds == [3] * (1 + 3 * 2)
