"""The batched run against the looped one, and the campaign layer's
batched calls, on the port alone.

- A Langevin run (atoms and λ, in-run metadynamics deposits) of a batch
  of R = 3 distinct replicas of the dilute grid-4³ acid box
  (test_torch_batch_ops.replicas) with one torch.Generator a replica
  follows R single runs fed generators with the same seeds: replica r
  draws its noise from its own generator in the order its single run
  draws it, so the trajectories can differ only by the order of the
  batch's sums. Measured on the CPU: positions, λ, h_conserved (~950
  kcal/mol) and the tables bitwise equal; the bars leave room for sums
  in another order: positions 1e-5 Å, λ 1e-6, h_conserved rtol 1e-6,
  the tables bitwise.
- make_rex_runner_tiled runs each block as one batched make_run call
  (counted), and equals that call followed by the swap.
- The CLI's titrate --method metad (the port's, on the CPU) runs each
  chunk of all walkers as one batched call (counted).
"""
import contextlib
import dataclasses
import io
import json

import numpy as np
import torch

from constant_ph_tpu_torch import cli, metad
from constant_ph_tpu_torch.engine import EngineConfig
from constant_ph_tpu_torch.parallel import replica
from constant_ph_tpu_torch.tiled.engine import TiledEngine

from test_torch_batch_ops import R, replicas
from test_torch_layout import jax_tiled, port_of

# one torch thread per xdist worker, as the other port tests
torch.set_num_threads(1)

LANGEVIN = dict(dt=1.0, thermostat="langevin", T=300.0, gamma=0.01,
                lambda_thermostat="langevin", rebuild_every=4, seed=9)
MP = dict(nbins=121, sigma=0.05, h0=0.4, gamma=10.0, stride=4)


def _batch():
    _, jts, jst = jax_tiled("dsf", 0.2)
    tts, tst = port_of(jts, jst)
    tb = replicas(jst, tst, seed=10)[1]
    mp = metad.MetadParams(**MP)
    V, dV = metad.init_tables(tb.lam.shape[-1], mp, device="cpu")
    return tts, dataclasses.replace(
        tb, metad_v=V.expand((R,) + V.shape).clone(),
        metad_dv=dV.expand((R,) + dV.shape).clone()), mp


def _gens():
    return replica.replica_generators([100 + r for r in range(R)], "cpu")


def _counting(monkeypatch, calls):
    """TiledEngine.make_run wrapped so each run call records its batch
    size."""
    make_run = TiledEngine.make_run

    def counted(eng, n_steps, detailed_flags=False):
        run = make_run(eng, n_steps, detailed_flags)

        def run_counted(st, generators=None):
            calls.append(st.pH.shape[0] if st.pH.ndim else None)
            return run(st, generators)
        return run_counted
    monkeypatch.setattr(TiledEngine, "make_run", counted)


def test_batched_langevin_run_follows_looped_run():
    tts, tb, mp = _batch()
    eng = TiledEngine(tts, EngineConfig(**LANGEVIN), metad=mp)
    run = eng.make_run(8)
    got, ov, obs = run(tb, _gens())
    assert ov.shape == (R,) and obs.temp.shape == (R, 8)
    for r, (st, g) in enumerate(zip(replica.unstack_replicas(tb), _gens())):
        want, ov_r, o_r = run(st, g)
        assert bool(ov[r]) == bool(ov_r)
        np.testing.assert_allclose(got.wx[r].numpy(), want.wx.numpy(),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.sx[r].numpy(), want.sx.numpy(),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(obs.lam[r].numpy(), o_r.lam.numpy(),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(obs.h_conserved[r].numpy(),
                                   o_r.h_conserved.numpy(), rtol=1e-6)
        assert torch.equal(got.metad_v[r], want.metad_v)
    # the replicas drew their own noise: their trajectories differ
    assert not torch.equal(obs.lam[0], obs.lam[1])
    assert (got.ext_work != tb.ext_work).all()


def test_rex_runner_tiled_runs_one_batch_a_block(monkeypatch):
    tts, tb, mp = _batch()
    calls = []
    _counting(monkeypatch, calls)
    eng = TiledEngine(tts, EngineConfig(**LANGEVIN), metad=mp,
                      metad_frozen=True)
    block = replica.make_rex_runner_tiled(eng, 4, generators=_gens())
    swap = torch.Generator().manual_seed(11)
    out, _, acc, last = block(tb, swap, 0)
    out, _, acc, last = block(out, swap, 1)
    assert calls == [R, R]
    assert last.temp.shape == (R,) and acc.shape == (R,)
    assert sorted(out.pH.tolist()) == sorted(tb.pH.tolist())
    # a block is the batched run followed by the swap
    calls.clear()
    ref, _, obs = eng.make_run(4)(tb, _gens())
    ref, _ = replica.swap_phs(ref, torch.Generator().manual_seed(11),
                              eng.bias, 0)
    got = replica.make_rex_runner_tiled(eng, 4, generators=_gens())(
        tb, torch.Generator().manual_seed(11), 0)[0]
    assert calls == [R, R]
    for name in ("wx", "lam", "pH", "ext_work"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


def test_titrate_metad_runs_one_batch_a_chunk(tmp_path, monkeypatch):
    calls = []
    _counting(monkeypatch, calls)
    cfg = dict(system=dict(builder="solvated_acid", n_side=3, pH=5.0,
                           pK=4.25, cutoff=4.5, coul_style="dsf", alpha=0.2,
                           rigid_water=True),
               engine=dict(dt=1.0, thermostat="langevin", T=300.0,
                           gamma=0.01, lambda_thermostat="langevin",
                           rebuild_every=1),
               run=dict(steps=150, minimize_steps=10),
               metad=dict(nbins=61, sigma=0.05, h0=0.5, gamma=8.0))
    path = tmp_path / "metad.json"
    path.write_text(json.dumps(cfg))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["titrate", str(path), "--ph", "3.0,4.5,6.0", "--method",
                  "metad", "--device", "cpu"])
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    # chunks of 50 · rebuild_every = 50 steps: three, each one call of the
    # three walkers together
    assert res["steps"] == 150 and calls == [3, 3, 3]
    frac = np.asarray(res["per_site"])
    assert frac.shape == (3, 1) and np.isfinite(frac).all()
