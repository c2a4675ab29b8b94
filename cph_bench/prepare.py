"""Set-up shared by the drivers: the system from the seed, carried into
the port, split into tiles and relaxed on its own engine, as the
configuration file states; and the judged state of a tiled driver in
atom order (reference/check.py says what it holds). Only the system
under test comes from the port; the inputs are the benchmark's own
(cph_bench/inputs)."""
from __future__ import annotations

import dataclasses
import importlib
import time

import torch

# a seed's derived streams: the relaxation engine, each replica's
# generator, the swap generator
_MASK = (1 << 63) - 1


def derive(seed: int, tag: int) -> int:
    """A 63-bit seed from (seed, tag) by splitmix64's finaliser, so that
    streams of one run differ and seeds beyond 32 bits are taken whole."""
    m = (1 << 64) - 1
    x = (int(seed) * 0x9E3779B97F4A7C15 + tag + 1) & m
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m
    return (x ^ (x >> 31)) & _MASK


def inputs(config: dict, seed: int) -> dict:
    """The system of the configuration's builder, from the seed, as the
    numpy dict both the port and the reference read."""
    b = config["builder"]
    mod = importlib.import_module(f"cph_bench.inputs.{b['module']}")
    # numpy seeds take any non-negative integer; the builders add 1
    return getattr(mod, b["function"])(int(seed) & _MASK, **b["params"])


def engine_config(params: dict, seed: int):
    from constant_ph_tpu_torch.engine import EngineConfig

    return EngineConfig(**dict(params, seed=derive(seed, 0)))


def shape_of(system, ts) -> dict:
    return dict(atoms=int(system.state.x.shape[0]),
                sites=int(ts.spec.n_sites), grid=list(ts.params.grid),
                W=int(ts.params.W), Ns=int(ts.solute.q0.shape[0]))


def relaxed(ctx):
    """Build, split, relax (FIRE, then Langevin) and retile one state.
    Returns (TiledSystem, TiledState, PME params or None); records the
    shape and the seconds of each part in ctx.notes."""
    from constant_ph_tpu_torch import convert
    from constant_ph_tpu_torch.ops.pme import make_pme_params
    from constant_ph_tpu_torch.tiled.engine import TiledEngine
    from constant_ph_tpu_torch.tiled.layout import (
        retile, split_system, to_tiled)

    cfg = ctx.config
    dev = ctx.device
    sync = ctx.sync
    t0 = time.perf_counter()
    d = inputs(cfg, ctx.seed)
    system = convert.system(d, dev)
    ts = split_system(system, device=dev, **cfg["split"])
    st = to_tiled(ts, system.state)
    ctx.inputs = d
    shape = shape_of(system, ts)
    want = cfg.get("shape")
    if want is not None and any(shape[k] != v for k, v in want.items()):
        raise RuntimeError(f"built {shape}, the configuration states {want}")
    pme = None
    if cfg.get("pme"):
        pc = cfg["pme"]
        pme = make_pme_params(system.state.box.cpu().numpy(),
                              ts.params.grid, pc["alpha"],
                              spacing=pc["spacing"], p=pc["p"],
                              skin=cfg["split"]["skin"], device=dev)
        if list(pme.mesh) != list(pc["mesh"]):
            raise RuntimeError(f"PME mesh {pme.mesh}, the configuration "
                               f"states {pc['mesh']}")
    sync()
    ctx.notes["build_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rx = cfg["relax"]
    eng = TiledEngine(ts, engine_config(rx["engine"], ctx.seed),
                      kspace_ep=pme)
    if rx["fire_steps"]:
        st, _ = eng.make_minimize(rx["fire_steps"])(st)
    st, overflow, obs = eng.make_run(rx["steps"])(st)
    occ = int(st.wvalid.sum(dim=1).max())
    # the production tiles hold the configuration's W, so that every seed
    # runs the same shapes, unless the fullest cell would keep fewer than
    # ``margin`` slots free (then W grows, and the notes say so)
    W = max(rx.get("W", 0), -(-(occ + rx["margin"]) // 4) * 4)
    ts, st = retile(ts, st, W)
    sync()
    ctx.notes["relax_s"] = time.perf_counter() - t0
    ctx.notes["relax"] = dict(
        fire_steps=rx["fire_steps"], steps=rx["steps"],
        overflow=bool(overflow), T_last=float(obs.temp[-1]),
        occupancy=occ, W=int(ts.params.W),
        W_grown=int(ts.params.W) != rx.get("W"), shape=shape)
    return ts, st, pme


def with_dG_ref(ts, value):
    """The tiled system with ΔG_ref installed on every site."""
    from constant_ph_tpu_torch.titration import apply_dG_ref

    ts.spec = apply_dG_ref(ts.spec, value)
    return ts


def ladder(mix) -> list:
    """The pH of every replica: each rung's walkers side by side."""
    return [float(ph) for ph in mix["phs"]
            for _ in range(mix["walkers_per_ph"])]


def replicas(st, phs, lam_of, seed, device):
    """The batch: the relaxed state once per replica with its pH and its
    start λ (v_λ 0), and one generator a replica from the seed."""
    from constant_ph_tpu_torch.parallel import replica

    reps = [dataclasses.replace(
        st, pH=torch.full_like(st.pH, ph), lam=lam_of(ph).to(st.lam.dtype),
        v_lam=torch.zeros_like(st.v_lam)) for ph in phs]
    gens = replica.replica_generators(
        [derive(seed, 100 + r) for r in range(len(phs))], device)
    return reps, gens


def failed_mask(batch, overflow):
    """(R,) int: a replica whose block overflowed or left a non-finite
    value in its state."""
    from constant_ph_tpu_torch.parallel.replica import replica_finite

    return (overflow | ~replica_finite(batch)).to(torch.int32)



def atom_order(top, st, w, s):
    """(R, N, 3) float64: tile rows w (R, 3, G, 3W) and solute rows s (R,
    Ns, 3) of the batch st in atom order, by st's own validity and
    molecule ids (``top`` is the reference's topology of the inputs)."""
    R, dev = w.shape[0], w.device
    X = torch.zeros((R, top.n_atoms, 3), dtype=torch.float64, device=dev)
    tw = torch.as_tensor(top.tiled_waters, device=dev)
    sol = torch.as_tensor(top.solute_ids, device=dev)
    for r in range(R):
        cells, slots = torch.nonzero(st.wvalid[r] > 0.5, as_tuple=True)
        mol = st.wid[r][cells, slots].long()
        for a in range(3):
            X[r, tw[mol, a]] = w[r][:, cells, 3 * slots + a].T.to(
                torch.float64)
        X[r, sol] = s[r][:len(sol)].to(torch.float64)
    return X


def judged_tiled(ctx, engine, batch, gens, obs_last, obs_pH=None,
                 metad=None):
    """The judged state of a TiledEngine batch at the window's end, in
    atom order: the state, the program's force evaluation of it
    (``compute_forces``, which every step of the window calls), the
    energy its last step recorded, and one more step of it
    (``TiledEngine.step``) from there."""
    from cph_bench.reference.forces import topology

    cfg = engine.cfg
    top = topology(ctx.inputs, ctx.device)
    with torch.no_grad():
        frc = engine.compute_forces(batch)
    f = atom_order(top, batch, frc.fw, frc.fs)
    f_lam = frc.f_lam.to(torch.float64)
    del frc
    with torch.no_grad():
        frc0 = engine.compute_forces(batch, kspace_impulse=True,
                                     phi_recip_prev=batch.phi_recip_s)
        st1, _ = engine.step(batch, frc0, gens)
    del frc0
    # the k-space force enters ×kspace_every on a boundary step, not at
    # all between
    k = cfg.kspace_every if batch.step_host % cfg.kspace_every == 0 else 0
    return dict(
        x=atom_order(top, batch, batch.wx, batch.sx),
        v=atom_order(top, batch, batch.wv, batch.sv),
        box=batch.box.to(torch.float64), lam=batch.lam.to(torch.float64),
        pH=batch.pH.to(torch.float64), f=f, f_lam=f_lam,
        e_pot=obs_last.e_pot.to(torch.float64),
        e_has_kspace=obs_last.h_valid.to(torch.bool),
        obs_pH=(batch.pH if obs_pH is None else obs_pH).to(torch.float64),
        x1=atom_order(top, st1, st1.wx, st1.sx), kspace_factor=k,
        step=dict(dt=cfg.dt, gamma=cfg.gamma, T=cfg.T), metad=metad)


def metad_judged(mp, hills, walkers_per_ph, tables):
    """The bias part of a judged state: the parameters, every merge's
    hills (G, K, S) in order, and each replica's table (R, S, nbins)."""
    return dict(params=dict(lo=mp.lo, hi=mp.hi, nbins=mp.nbins,
                            sigma=mp.sigma, h0=mp.h0, gamma=mp.gamma,
                            T=mp.T),
                hills=list(hills), walkers_per_ph=int(walkers_per_ph),
                v=tables.to(torch.float64))
