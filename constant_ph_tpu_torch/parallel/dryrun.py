"""The multi-rank dry run (the port of the JAX package's
``__graft_entry__.dryrun_multichip``, __graft_entry__.py:43-233): the full
constant-pH step over ``world`` ranks of torch.distributed, at tiny shapes
on the production code paths. Three legs, as in the JAX package:

1. replica exchange: R = world replicas of a small solvated acid at pH
   4.0 + 0.5 r on the reference engine, one replica a rank
   (parallel.replica.split_replicas), one make_rex_runner block of 2 steps
   with the swap over ranks;
2. spatial decomposition: a dilute 4³-cell box on x-slabs over 4 ranks
   (2, or none, when the ranks do not divide by 4), a 2-step NVE run of
   TiledEngine(spatial=group);
3. campaign physics: PME, kspace_every 2, a frozen metadynamics bias, one
   walker a rank, a 4-step run, and the cross-rank group merge of every
   walker's hills (metad.make_mesh_group_merge), which must land.

    python -m constant_ph_tpu_torch.parallel.dryrun 2 --device cpu

``dryrun_multichip(world, device)`` spawns ``world`` processes
(torch.multiprocessing), each on ``device`` ("cuda": rank r on card
r mod count; gloo through host buffers when the ranks share a card, nccl
when each has its own), and raises if any of them fails. A CUDA request
without CUDA raises; nothing falls back to the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from constant_ph_tpu_torch import metad as metad_mod, resolve_device
from constant_ph_tpu_torch.engine import EngineConfig
from constant_ph_tpu_torch.ops.pme import make_pme_params
from constant_ph_tpu_torch.parallel import comm, replica, spatial
from constant_ph_tpu_torch.systems.water import solvated_acid
from constant_ph_tpu_torch.tiled.engine import TiledEngine
from constant_ph_tpu_torch.tiled.layout import (
    retile_auto,
    split_system,
    to_tiled,
)


def _rex_leg(n, r, dev):
    sys_ = solvated_acid(n_side=3, rigid_water=True, lambda_coupled=True,
                         cutoff=4.0, coul_style="dsf", alpha=0.2, pH=5.0,
                         device=dev)
    eng = sys_.make_engine(EngineConfig(
        dt=1.0, thermostat="langevin", T=300.0, gamma=0.002,
        lambda_thermostat="langevin", rebuild_every=2))
    base = sys_.state
    batch = replica.stack_replicas([
        dataclasses.replace(base, pH=torch.full_like(base.pH, 4.0 + 0.5 * k))
        for k in range(n)])
    nbrs = eng.build_neighbors(batch.x, batch.box)
    mine = replica.split_replicas(batch, None)
    nbrs = replica.split_replicas(nbrs, None)
    block = replica.make_rex_runner(eng, md_steps_per_swap=2, group=None)
    states, _, _, accepted, obs = block(
        mine, nbrs, torch.Generator(device=dev).manual_seed(0), 0)
    assert states.x.shape[0] == 1
    assert bool(torch.all(torch.isfinite(obs.h_conserved)))
    return dict(pH=states.pH, accepted=accepted, h=obs.h_conserved)


def _spatial_leg(n, r, dev):
    n_sp = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    if n_sp == 1:
        return None
    grp = spatial.make_spatial_mesh(n_sp)
    if r >= n_sp:                     # a rank outside the slab group
        return None
    # dilute box: big enough for a 4³ cell grid, few atoms (a dry run);
    # retiled to its occupancy, which changes no physics
    sys_sp = solvated_acid(n_side=8, spacing=6.4, rigid_water=True,
                           lambda_coupled=True, cutoff=8.0, skin=2.0,
                           coul_style="dsf", alpha=0.2, device=dev)
    ts = split_system(sys_sp, device=dev)
    assert ts.params.grid[0] % n_sp == 0
    tst = to_tiled(ts, sys_sp.state)
    ts, tst = retile_auto(ts, tst, int(tst.wvalid.sum(-1).max()))
    tst = spatial.shard_tiled_state(tst, grp, ts.params)
    eng = TiledEngine(ts, EngineConfig(dt=0.5, thermostat="nve",
                                       lambda_thermostat="none",
                                       rebuild_every=2), spatial=grp)
    st2, overflow, obs = eng.make_run(2)(tst)
    assert bool(torch.all(torch.isfinite(obs.e_pot)))
    assert not bool(overflow)
    return dict(e_pot=obs.e_pot, sx=st2.sx)


def _campaign_leg(n, r, dev):
    sys_m = solvated_acid(n_side=8, rigid_water=True, lambda_coupled=True,
                          cutoff=6.0, skin=1.5, coul_style="cut", alpha=0.35,
                          pH=5.0, device=dev)
    ts = split_system(sys_m, skin=1.5, device=dev)
    tst = to_tiled(ts, sys_m.state)
    pp = make_pme_params(sys_m.state.box.cpu().numpy(), ts.params.grid, 0.35,
                         skin=1.5, spacing=1.2, p=4, device=dev)
    mp = metad_mod.MetadParams(nbins=61, sigma=0.05, h0=0.3, gamma=20.0,
                               stride=4)
    V0, dV0 = metad_mod.init_tables(ts.spec.n_sites, mp, device=dev)
    batch = replica.stack_replicas([
        dataclasses.replace(tst, pH=torch.full_like(tst.pH, 4.0 + 0.25 * k),
                            metad_v=V0, metad_dv=dV0) for k in range(n)])
    mine = replica.split_replicas(batch, None)
    eng = TiledEngine(
        ts, EngineConfig(dt=1.0, thermostat="langevin", T=300.0, gamma=0.01,
                         lambda_thermostat="langevin", rebuild_every=2,
                         kspace_every=2),
        kspace_ep=pp, metad=mp, metad_frozen=True)
    gens = replica.replica_generators([100 + r], dev)
    b2, overflow, obs = eng.make_run(4)(mine, gens)
    assert bool(torch.all(torch.isfinite(obs.e_pot)))
    # one shared-bias walker group spanning every rank: each rank's hills
    # gathered into the (1, W, K, S) sequence, merged by one all-reduce
    seq = comm.all_gather(obs.lam[:, mp.stride - 1::mp.stride, :])
    seq = seq.reshape((1, -1) + seq.shape[-2:])            # (1, W, K, S)
    merge = metad_mod.make_mesh_group_merge(None, mp)
    Vm, dVm = merge(b2.metad_v[:1], b2.metad_dv[:1], seq)
    assert bool(torch.all(torch.isfinite(Vm)))
    landed = float(torch.abs(Vm - b2.metad_v[:1]).max())
    assert landed > 0.0, "no hill landed"                  # hills landed
    return dict(V=Vm, landed=landed)


def _rank_main(r, n, device):
    dev = device
    if torch.device(device).type == "cuda":
        dev = torch.device("cuda", r % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dict(rex=_rex_leg(n, r, dev), spatial=_spatial_leg(n, r, dev),
                campaign=_campaign_leg(n, r, dev))


def dryrun_multichip(world: int, device="cuda", init_dir=None):
    """Run the three legs over ``world`` spawned ranks on ``device`` and
    return each rank's readings (numpy). Raises if any rank fails."""
    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        backend = "nccl"                        # one card a rank
    return comm.run_ranks(_rank_main, world, (str(dev),), backend=backend,
                          init_dir=init_dir)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("world", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = dryrun_multichip(args.world, args.device)
    print(f"dryrun OK: {args.world} ranks, hills landed "
          f"{[o['campaign']['landed'] for o in out]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
