"""Shared-walker λ-metadynamics titration on the tiled engine, as the
production campaign driver runs it with more than one walker a pH rung:
all walkers in one batch against frozen bias tables,
``steps_per_block`` steps a block, then each rung's hills (every
walker's λ at each stride, walkers interleaved in time) merged into the
rung's table with ``metad.deposit_many`` and handed back to its walkers.
Walkers start in the basin their pH favours, against zeroed tables. No
host read inside a block."""
from __future__ import annotations

import dataclasses

import torch

from cph_bench import prepare


class Run:
    def __init__(self, ctx):
        from constant_ph_tpu_torch import metad
        from constant_ph_tpu_torch.parallel import replica
        from constant_ph_tpu_torch.tiled.engine import TiledEngine

        self.ctx = ctx
        mix, cfg = ctx.mix, ctx.config
        ts, st, pme = prepare.relaxed(ctx)
        ts = prepare.with_dG_ref(ts, cfg["dG_ref"])
        self.mp = metad.MetadParams(**mix["metad"])
        self.cfg = prepare.engine_config(cfg["engine"], ctx.seed)
        self.engine = TiledEngine(ts, self.cfg, kspace_ep=pme, metad=self.mp,
                                  metad_frozen=True)
        self.deposit_many = metad.deposit_many
        S = ts.spec.n_sites
        self.G, self.wpp, self.S = len(mix["phs"]), mix["walkers_per_ph"], S
        V0, dV0 = metad.init_tables(S, self.mp, device=ctx.device)
        lo, hi = mix["lam_basins"]
        pK = ts.spec.pK
        reps, self.gens = prepare.replicas(
            st, prepare.ladder(mix),
            lambda ph: torch.where(pK > ph, lo, hi), ctx.seed, ctx.device)
        reps = [dataclasses.replace(r, metad_v=V0.clone(),
                                    metad_dv=dV0.clone()) for r in reps]
        self.batch = replica.stack_replicas(reps)
        self.R = len(reps)
        self.steps_per_block = int(mix["steps_per_block"])
        self.dt_fs = self.cfg.dt
        self.run = self.engine.make_run(self.steps_per_block)
        # every merge's hills (G, K·wpp, S), in order, for the reference
        self.hills = []
        self.reset()

    def reset(self):
        self.blocks = 0
        self.failed = torch.zeros(self.R, dtype=torch.int32,
                                  device=self.batch.pH.device)

    def block(self):
        G, wpp, S, mp = self.G, self.wpp, self.S, self.mp
        self.batch, overflow, obs = self.run(self.batch, self.gens)
        lam_tr = obs.lam[:, mp.stride - 1::mp.stride]            # (R, K, S)
        K = lam_tr.shape[1]
        seq = lam_tr.reshape(G, wpp, K, S).transpose(1, 2).reshape(
            G, K * wpp, S)
        V = self.batch.metad_v.reshape(G, wpp, S, mp.nbins)[:, 0]
        dV = self.batch.metad_dv.reshape(G, wpp, S, mp.nbins)[:, 0]
        new = [self.deposit_many(V[g], dV[g], seq[g], mp) for g in range(G)]
        self.batch = dataclasses.replace(
            self.batch,
            metad_v=torch.stack([v for v, _ in new]).repeat_interleave(
                wpp, dim=0),
            metad_dv=torch.stack([d for _, d in new]).repeat_interleave(
                wpp, dim=0))
        self.hills.append(seq)
        self.obs_last = dataclasses.replace(obs, **{
            f.name: getattr(obs, f.name)[:, -1]
            for f in dataclasses.fields(obs)})
        self.failed += prepare.failed_mask(self.batch, overflow)
        self.blocks += 1

    def health(self):
        return self.R * self.blocks, int(self.failed.sum())

    def judged(self):
        return prepare.judged_tiled(
            self.ctx, self.engine, self.batch, self.gens, self.obs_last,
            metad=prepare.metad_judged(self.mp, self.hills, self.wpp,
                                       self.batch.metad_v))


def make(ctx):
    return Run(ctx)
