"""pH replica exchange on the tiled engine: every replica of the mix's pH
ladder in one batch, ``steps_per_block`` steps a block through
``parallel.replica.make_rex_runner_tiled`` and one even/odd pH-swap sweep
after each block (parity alternating). No host read inside a block."""
from __future__ import annotations

import torch

from cph_bench import prepare


class Run:
    def __init__(self, ctx):
        from constant_ph_tpu_torch.parallel import replica
        from constant_ph_tpu_torch.tiled.engine import TiledEngine

        self.ctx = ctx
        mix, cfg = ctx.mix, ctx.config
        ts, st, pme = prepare.relaxed(ctx)
        ts = prepare.with_dG_ref(ts, cfg["dG_ref"])
        self.cfg = prepare.engine_config(cfg["engine"], ctx.seed)
        self.engine = TiledEngine(ts, self.cfg, kspace_ep=pme)
        phs = prepare.ladder(mix)
        lam0 = float(mix["lam_start"])
        reps, self.gens = prepare.replicas(
            st, phs, lambda ph: torch.full_like(st.lam, lam0), ctx.seed,
            ctx.device)
        self.batch = replica.stack_replicas(reps)
        self.phs = torch.tensor(sorted(phs), dtype=st.pH.dtype,
                                device=st.pH.device)
        self.R = len(phs)
        self.steps_per_block = int(mix["steps_per_block"])
        self.dt_fs = self.cfg.dt
        self.rex = replica.make_rex_runner_tiled(
            self.engine, self.steps_per_block, with_stats=True,
            generators=self.gens)
        self.swap_gen = torch.Generator(device=ctx.device).manual_seed(
            prepare.derive(ctx.seed, 1))
        self.parity = 0
        self.reset()

    def reset(self):
        """Start counting the window's replica-blocks."""
        self.blocks = 0
        self.failed = torch.zeros(self.R, dtype=torch.int32,
                                  device=self.batch.pH.device)

    def block(self):
        # the block's observables are of the pHs before its swap
        self.obs_pH = self.batch.pH
        self.batch, _, _, overflow, stats = self.rex(
            self.batch, self.swap_gen, self.parity)
        self.parity ^= 1
        self.obs_last = stats["obs_last"]
        lost = torch.any(torch.sort(self.batch.pH).values != self.phs)
        self.failed += prepare.failed_mask(self.batch, overflow | lost)
        self.blocks += 1

    def health(self):
        return self.R * self.blocks, int(self.failed.sum())

    def judged(self):
        return prepare.judged_tiled(self.ctx, self.engine, self.batch,
                                    self.gens, self.obs_last,
                                    obs_pH=self.obs_pH)


def make(ctx):
    return Run(ctx)
