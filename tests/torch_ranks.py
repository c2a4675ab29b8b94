"""What the port's multi-rank tests run in each rank (spawned by
parallel.comm.run_ranks over gloo, one torch thread a rank). This module
imports the port, torch and numpy only: a spawned rank imports nothing of
the JAX package. The parent process computes the JAX reference values
and hands them over as numpy arrays; the systems are built here by the
port's builders, which give the JAX package's systems bit for bit
(tests/test_torch_layout.py::test_builder_matches_jax).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from constant_ph_tpu_torch import metad
from constant_ph_tpu_torch.engine import EngineConfig
from constant_ph_tpu_torch.ops.pme import make_pme_params, pme_recip_tiled
from constant_ph_tpu_torch.parallel import comm, replica, spatial
from constant_ph_tpu_torch.systems.water import solvated_acid
from constant_ph_tpu_torch.tiled.engine import TiledEngine
from constant_ph_tpu_torch.tiled.layout import retile, split_system, to_tiled

# tests/test_spatial.py:22-24: a dilute box on a 4³ cell grid
DILUTE = dict(n_side=8, spacing=6.4, rigid_water=True, lambda_coupled=True,
              cutoff=8.0, skin=2.0, coul_style="dsf", alpha=0.2, seed=6)
# tests/test_spatial.py:80-82 at production density (3.1 Å): n_side 16,
# grid 4³, is already the smallest box whose cell grid's x divides by 2
# (a cell takes rc + skin + 2 Å = 12 Å)
DENSE = dict(DILUTE, n_side=16, spacing=3.1, seed=7)
SYSTEMS = {"dilute": DILUTE, "dense": DENSE}
NVE = dict(dt=1.0, thermostat="nve", lambda_thermostat="none",
           rebuild_every=5)
LANGEVIN = dict(dt=1.0, thermostat="langevin", T=300.0, gamma=0.01,
                lambda_thermostat="langevin", rebuild_every=5, seed=3)
PME_MESH = dict(spacing=1.5, p=6)


def tiled_box(kind, W=None):
    """The port's TiledSystem and TiledState of SYSTEMS[kind] on the CPU,
    retiled to W slots a cell where given (the JAX package's retile gives
    the same tiles)."""
    sys_ = solvated_acid(device="cpu", **SYSTEMS[kind])
    ts = split_system(sys_, device="cpu")
    st = to_tiled(ts, sys_.state)
    if W is not None:
        ts, st = retile(ts, st, W)
    return ts, st


def _stats():
    return {k: dict(v) for k, v in comm.STATS.items()}


def slab_forces(r, n, kind, W):
    """One force evaluation of TiledEngine(spatial=…) on this rank's
    slab."""
    ts, st = tiled_box(kind, W)
    grp = spatial.make_spatial_mesh(n)
    eng = TiledEngine(ts, EngineConfig(**NVE), spatial=grp)
    mine = spatial.shard_tiled_state(st, grp, ts.params)
    comm.reset_stats()
    frc = eng.compute_forces(mine)
    return dict(fw=frc.fw, fs=frc.fs, e_lj=frc.e_lj, e_coul=frc.e_coul,
                dUdlam=frc.dUdlam, stats=_stats())


def slab_run(r, n, kind, W, cfg, steps):
    """A make_run of ``steps`` on this rank's slab: the observables, the
    replicated solute and λ, the rank's tiles and the call counts."""
    ts, st = tiled_box(kind, W)
    grp = spatial.make_spatial_mesh(n)
    eng = TiledEngine(ts, EngineConfig(**cfg), spatial=grp)
    mine = spatial.shard_tiled_state(st, grp, ts.params)
    comm.reset_stats()
    st2, overflow, obs = eng.make_run(steps)(mine)
    return dict(e_pot=obs.e_pot, ke=obs.ke, h=obs.h_conserved, lam=st2.lam,
                v_lam=st2.v_lam, sx=st2.sx, sv=st2.sv, wx=st2.wx,
                overflow=overflow, stats=_stats())


def pme_box(W):
    ts, st = tiled_box("dilute", W)
    pp = make_pme_params(st.box.numpy(), ts.params.grid, 0.3, skin=2.0,
                         device="cpu", **PME_MESH)
    qs = TiledEngine(ts, EngineConfig(**NVE)).charges_solute(st.lam)
    return ts, st, pp, qs * ts.solute.smask


def _pme_inputs(ts, st):
    gx, gy, gz = ts.params.grid
    A = 3 * ts.params.W
    G = st.wx.shape[1]
    wq = (TiledEngine(ts, EngineConfig(**NVE)).wq_pat
          * torch.repeat_interleave(st.wvalid, 3, dim=-1))
    return (st.wx.reshape(3, G // (gy * gz), gy, gz, A),
            wq.reshape(G // (gy * gz), gy, gz, A))


def pme_whole(W):
    """pme_recip_tiled on the whole grid (the single-process call)."""
    ts, st, pp, qs = pme_box(W)
    wxg, wq = _pme_inputs(ts, st)
    return pme_recip_tiled(wxg, wq, st.sx, qs, pp)[:4]


def pme_slab(r, n, W):
    """pme_recip_tiled on this rank's slab, the mesh summed over ranks."""
    ts, st, pp, qs = pme_box(W)
    sl = spatial.slab_of(None, ts.params)
    mine = spatial.shard_tiled_state(st, None, ts.params)
    wxg, wq = _pme_inputs(ts, mine)
    return pme_recip_tiled(wxg, wq, st.sx, qs, pp, slab=sl)[:4]


def merge(r, n, V, dV, seq, p_fields, groups):
    """make_mesh_group_merge (groups) or make_mesh_walker_merge over the
    default group, on tables and snapshots every rank holds alike."""
    p = metad.MetadParams(**p_fields)
    t = [torch.as_tensor(a) for a in (V, dV, seq)]
    fn = (metad.make_mesh_group_merge if groups
          else metad.make_mesh_walker_merge)(None, p)
    return fn(*t)


REX_PHS = (4.0, 4.5, 5.0, 5.5)


def ref_rex_batch(R):
    """R replicas of a small solvated acid on the reference engine at
    REX_PHS, their lists, and the engine."""
    sys_ = solvated_acid(n_side=3, rigid_water=True, lambda_coupled=True,
                         cutoff=4.0, coul_style="dsf", alpha=0.2, pH=5.0,
                         device="cpu")
    eng = sys_.make_engine(EngineConfig(
        dt=1.0, thermostat="langevin", T=300.0, gamma=0.002,
        lambda_thermostat="langevin", rebuild_every=2, seed=5))
    base = sys_.state
    batch = replica.stack_replicas([dataclasses.replace(
        base, pH=torch.full_like(base.pH, REX_PHS[k]),
        lam=torch.full_like(base.lam, 0.3 + 0.15 * k)) for k in range(R)])
    return eng, batch, eng.build_neighbors(batch.x, batch.box)


def tiled_rex_batch(R):
    """R replicas of the dilute box (retiled to 16 slots) at REX_PHS on
    the tiled engine (K1's plain version on the CPU)."""
    ts, st = tiled_box("dilute", 16)
    eng = TiledEngine(ts, EngineConfig(**dict(LANGEVIN, seed=5,
                                              rebuild_every=2)))
    batch = replica.stack_replicas([dataclasses.replace(
        st, pH=torch.full_like(st.pH, REX_PHS[k]),
        lam=torch.full_like(st.lam, 0.3 + 0.15 * k)) for k in range(R)])
    return eng, batch


def rex_blocks(r, n, kind, R, blocks, group=None):
    """``blocks`` REX blocks of 2 steps (parities 0, 1, …) on this rank's
    slice of R replicas over ``group`` (the whole batch without a process
    group); returns the slice's
    final λ, positions and pHs, and every rank's pHs and accepted masks
    as this rank sees them (all-gathered)."""
    gen = torch.Generator().manual_seed(11)
    if kind == "ref":
        eng, batch, nbrs = ref_rex_batch(R)
        batch = replica.split_replicas(batch, group)
        nbrs = replica.split_replicas(nbrs, group)
        block = replica.make_rex_runner(eng, 2, group=group)
    else:
        eng, batch = tiled_rex_batch(R)
        batch = replica.split_replicas(batch, group)
        block = replica.make_rex_runner_tiled(eng, 2, group=group)
    acc = []
    for b in range(blocks):
        if kind == "ref":
            batch, nbrs, gen, accepted, _ = block(batch, nbrs, gen, b % 2)
        else:
            batch, gen, accepted, _ = block(batch, gen, b % 2)
        acc.append(comm.all_gather(accepted, group).reshape(-1))
    x = batch.x if kind == "ref" else batch.wx
    return dict(lam=batch.lam, x=x, pH=batch.pH,
                all_pH=comm.all_gather(batch.pH, group).reshape(-1),
                accepted=torch.stack(acc))


def run_one_thread(fn, *args):
    """fn(*args) in this process at one torch thread (the ranks' count),
    the thread count restored after."""
    k = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return comm._to_host(fn(*args))
    finally:
        torch.set_num_threads(k)


def assert_tree_equal(a, b):
    """Bitwise equality of two numpy results (dicts walked)."""
    if isinstance(a, dict):
        for k in a:
            assert_tree_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def slab_run_whole(kind, W, cfg, steps):
    """The single-process run that slab_run is held to."""
    ts, st = tiled_box(kind, W)
    st2, overflow, obs = TiledEngine(ts, EngineConfig(**cfg)).make_run(
        steps)(st)
    return dict(e_pot=obs.e_pot, ke=obs.ke, h=obs.h_conserved, lam=st2.lam,
                sx=st2.sx, wx=st2.wx)


def slab_refusals(r, n):
    """The messages of what slabs refuse on this many ranks."""
    from constant_ph_tpu_torch.ops.ewald import make_ewald_params
    from constant_ph_tpu_torch.tiled.npt import make_pressure_fn

    ts, st = tiled_box("dilute", 16)
    out = {}

    def catch(key, fn):
        try:
            fn()
        except (ValueError, NotImplementedError) as exc:
            out[key] = str(exc)

    # a grid x the ranks do not divide
    odd = dataclasses.replace(ts.params, grid=(n + 1,) + ts.params.grid[1:])
    catch("grid", lambda: spatial.slab_of(None, odd))
    grp = spatial.make_spatial_mesh(n)
    slab_eng = TiledEngine(ts, EngineConfig(**NVE), spatial=grp)
    catch("minimize", lambda: slab_eng.make_minimize(2))
    catch("npt", lambda: make_pressure_fn(slab_eng, T=300.0))
    ep = make_ewald_params(st.box.numpy(), 0.3, device="cpu")
    catch("ewald", lambda: TiledEngine(ts, EngineConfig(**NVE),
                                       kspace_ep=ep, spatial=grp))
    return out


def merges(r, n, walker, group, uneven):
    """The walker merge and the group merge on their inputs, and the
    message of the group merge's refusal of walkers that do not split."""
    out = dict(walker=merge(r, n, *walker, False),
               group=merge(r, n, *group, True))
    try:
        merge(r, n, *uneven, True)
    except ValueError as exc:
        out["uneven"] = str(exc)
    return out


def rex_both(r, n, R, blocks):
    """rex_blocks on the reference and the tiled engine."""
    return {kind: rex_blocks(r, n, kind, R, blocks)
            for kind in ("ref", "tiled")}


def slab_runs(r, n, W, steps, lang_steps):
    """What tests/test_torch_spatial_runs.py holds on 2 ranks: an NVE and
    a Langevin run on slabs, PME on slabs, and the refusals."""
    return dict(nve=slab_run(r, n, "dilute", W, NVE, steps),
                langevin=slab_run(r, n, "dilute", W, LANGEVIN, lang_steps),
                pme=pme_slab(r, n, W), refusals=slab_refusals(r, n))
