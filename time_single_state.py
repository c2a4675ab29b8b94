"""Time the port's single-state paths on the card, as chip_smoke.py drives
them, at shallow depth:

- ``pme``: the tiled engine on the PME main path (24,001 atoms,
  kspace_every 2, dt 2 fs, K1), after a short FIRE and Langevin relaxation
  and a retile to occupancy;
- ``hewl``: configs/hewl_like.json (20,241 atoms, W 208, K1 in passes) with
  its engine settings, after the same kind of relaxation;
- ``reference``: the reference engine with factorized Ewald on the PME
  path's relaxed state, after FIRE.

Each path is warmed up, then timed over whole blocks: ms per step is host
wall time over the measured steps with the device synchronised before and
after. One more block runs under torch.profiler (profiling.profile_block
of the checkout): the device's busy ms and its operations per step.

``--kernels`` times K1 (csrc/ww_pair.cu) and K2 (csrc/ww_tally.cu) on the
PME path's relaxed tiles instead (retiled to occupancy + chip_smoke's
PROD_MARGIN; device time from a CUDA graph of 50 calls,
profiling.graph_ms), then measures the NVE energy drift of that state
through K1: ``--nve-steps`` steps of velocity Verlet at dt 2 fs,
kspace_every 2, λ moving without a thermostat, from the state with its
velocities; h_conserved on the k-space boundary rows (h_valid), its
least-squares slope (kcal/mol per ns) and its spread. ``--plain-drift``
runs the same steps again with the water-water block through
tiled.forces.water_water_fast_plain (on the card).

    python time_single_state.py [--root DIR] [--label NAME] [--out FILE]
        [--kernels [--nve-steps 480] [--plain-drift]]

``--root`` imports ``constant_ph_tpu_torch`` and ``chip_smoke`` (for the
paths' settings) from checkout DIR (default: this one), so two checkouts
can be compared on one card in one call: run them A, B, B, A, each in a
process of its own. Prints one JSON line (and writes it to ``--out``).
Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

# λ at dt 2 fs as chip_smoke.py's production blocks run it (the JAX
# package's production campaign driver's λ thermostat and walls)
LAMBDA_2FS = dict(lambda_gamma=0.05, lam_min=-0.12, lam_max=1.12)


def _timed(run, st, n_blocks, block):
    """(state, host ms per step) over n_blocks calls."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_blocks):
        st = run(st)
    torch.cuda.synchronize()
    return st, (time.perf_counter() - t0) / (n_blocks * block) * 1e3


def _measured(run, st, n_warm, n_meas, block):
    """Warm-up, timed and profiled blocks: (state, readings)."""
    from constant_ph_tpu_torch.profiling import profile_block

    st, _ = _timed(run, st, n_warm, block)
    st, ms = _timed(run, st, n_meas, block)
    st, bp = profile_block(lambda s: (run(s),), st, block)
    return st, dict(ms_per_step=ms, steps=n_meas * block,
                    device_busy_ms_per_step=bp.busy_ms_per_step,
                    device_ops_per_step=bp.ops_per_step)


def relaxed_pme(cs, dev, margin, n_side=20, n_min=200, n_eq=400):
    """The PME path's system after FIRE and Langevin at dt 0.5 fs,
    retiled to its occupancy + ``margin``: (system, ts, st, pme)."""
    from constant_ph_tpu_torch.engine import EngineConfig
    from constant_ph_tpu_torch.ops.pme import make_pme_params
    from constant_ph_tpu_torch.systems.water import solvated_acid
    from constant_ph_tpu_torch.tiled.engine import TiledEngine
    from constant_ph_tpu_torch.tiled.layout import (
        retile, split_system, to_tiled)

    sys_ = solvated_acid(n_side=n_side, rigid_water=True,
                         lambda_coupled=True, hmr=3.0, pH=5.0, device=dev,
                         **cs.PAIR["pme"])
    ts = split_system(sys_, skin=0.8, tile_safety=1.72, device=dev)
    st = to_tiled(ts, sys_.state)
    pme = make_pme_params(sys_.state.box.cpu().numpy(), ts.params.grid,
                          cs.PAIR["pme"]["alpha"], skin=0.8, device=dev,
                          **cs.PME_MESH)
    cfg_eq = EngineConfig(dt=0.5, thermostat="langevin", T=300.0,
                          gamma=0.01, lambda_thermostat="langevin",
                          rebuild_every=8, force_cap=50.0, seed=1)
    eng_eq = TiledEngine(ts, cfg_eq, kspace_ep=pme)
    st, _ = eng_eq.make_minimize(n_min)(st)
    st = eng_eq.make_run(n_eq)(st)[0]
    occ = int(st.wvalid.sum(dim=1).max())
    ts, st = retile(ts, st, -(-(occ + margin) // 4) * 4)
    return sys_, ts, st, pme


def pme_path(cs, dev, n_warm=2, n_meas=10):
    import torch

    from constant_ph_tpu_torch.engine import EngineConfig
    from constant_ph_tpu_torch.tiled.engine import TiledEngine

    sys_, ts, st, pme = relaxed_pme(cs, dev, 4)
    block = 12
    cfg = EngineConfig(dt=2.0, thermostat="langevin", T=300.0, gamma=0.002,
                       lambda_thermostat="langevin", rebuild_every=block,
                       kspace_every=2, seed=2, **LAMBDA_2FS)
    run = TiledEngine(ts, cfg, kspace_ep=pme).make_run(block)
    st, res = _measured(lambda s: run(s)[0], st, n_warm, n_meas, block)
    if not bool(torch.isfinite(st.wx).all()):
        raise RuntimeError("pme: non-finite positions")
    return dict(res, W=ts.params.W), (sys_, ts, st)


def hewl_path(cs, dev, n_min=100, n_eq=200, n_warm=1, n_meas=4):
    import torch

    from constant_ph_tpu_torch.engine import EngineConfig
    from constant_ph_tpu_torch.lambda_dyn import BiasParams
    from constant_ph_tpu_torch.systems.protein import solvated_polypeptide
    from constant_ph_tpu_torch.tiled.engine import TiledEngine
    from constant_ph_tpu_torch.tiled.layout import split_system, to_tiled

    with open(cs.HEWL_CONFIG) as fh:
        conf = json.load(fh)
    build = dict(conf["system"])
    build.pop("builder")
    sys_ = solvated_polypeptide(device=dev, **build)
    ecfg = EngineConfig(**conf["engine"])
    bias = BiasParams()
    ts = split_system(sys_, device=dev)
    st = to_tiled(ts, sys_.state)
    block = ecfg.rebuild_every
    st, _ = TiledEngine(ts, ecfg, bias=bias).make_minimize(n_min)(st)
    cfg_eq = EngineConfig(rebuild_every=block, **cs.HEWL_EQ)
    st = TiledEngine(ts, cfg_eq, bias=bias).make_run(n_eq)(st)[0]
    run = TiledEngine(ts, ecfg, bias=bias).make_run(block)
    st, res = _measured(lambda s: run(s)[0], st, n_warm, n_meas, block)
    if not bool(torch.isfinite(st.wx).all()):
        raise RuntimeError("hewl: non-finite positions")
    return dict(res, W=ts.params.W)


def reference_path(cs, system, ts, st, n_fire=100, n_warm=2, n_meas=5):
    import torch

    from constant_ph_tpu_torch.engine import EngineConfig
    from constant_ph_tpu_torch.minimize import fire_minimize
    from constant_ph_tpu_torch.ops.ewald import (
        make_ewald_params, make_kspace_fn)

    sys_ = cs.in_atom_order(system, ts, st)
    ep = make_ewald_params(sys_.state.box.cpu().numpy(),
                           cs.REF_EWALD["alpha"],
                           accuracy=cs.REF_EWALD["accuracy"],
                           device=sys_.state.box.device)
    cfg = EngineConfig(gamma=cs.REF_GAMMA, seed=4, **cs.REF_LANGEVIN)
    eng = sys_.make_engine(cfg, kspace_fn=make_kspace_fn(ep))
    state, _ = fire_minimize(eng, sys_.state, n_fire)
    run = eng.make_run(cs.REF_BLOCK)

    def blk(carry):
        s, nbr, _ = run(*carry)
        return s, nbr

    carry = (state, eng.build_neighbors(state.x, state.box))
    carry, res = _measured(blk, carry, n_warm, n_meas, cs.REF_BLOCK)
    if not bool(torch.isfinite(carry[0].x).all()):
        raise RuntimeError("reference: non-finite positions")
    return res


def _drift(run, st, n_steps, block):
    """(h_conserved on the k-space boundary rows, their steps) over
    n_steps of ``run`` (one call a block)."""
    import torch

    hs, steps = [], []
    for _ in range(-(-n_steps // block)):
        st, _, obs = run(st)
        hs.append(obs.h_conserved[obs.h_valid])
        steps.append(obs.h_valid.nonzero().reshape(-1) + len(steps) * block)
    torch.cuda.synchronize()
    return (torch.cat(hs).double().cpu().numpy(),
            torch.cat(steps).double().cpu().numpy())


def kernels(cs, dev, nve_steps, plain_drift):
    """K1 and K2 device times on the PME path's relaxed tiles, and the
    NVE drift of that state through K1 (and K1's plain version)."""
    import numpy as np
    import torch

    from constant_ph_tpu_torch.engine import EngineConfig
    from constant_ph_tpu_torch.profiling import graph_ms
    from constant_ph_tpu_torch.tiled import cuda_ww, forces
    from constant_ph_tpu_torch.tiled.engine import TiledEngine

    _, ts, st, pme = relaxed_pme(cs, dev, cs.PROD_MARGIN)
    p = ts.params
    wxg = st.wx.reshape((3,) + p.grid + (3 * p.W,)).contiguous()
    wt = forces.pack_water_tiles(wxg, st.wvalid.reshape(p.grid + (p.W,)),
                                 ts.water, p)
    kw = dict(style=ts.coul_style, alpha=ts.alpha, rc=ts.cutoff)
    res = dict(W=p.W, G=p.G,
               k1_ms=graph_ms(lambda: forces.water_water_fast(
                   wxg, ts.water, p, st.box, **kw), 50),
               k2_ms=graph_ms(lambda: cuda_ww.water_water_tally_cuda(
                   wt, st.box, ts.water, p, **kw), 50),
               pairs_needed=int(forces.water_pairs_in_cutoff(
                   wxg, p, st.box, ts.cutoff)))
    if not nve_steps:
        return res
    cfg = EngineConfig(dt=2.0, thermostat="nve", lambda_thermostat="none",
                       rebuild_every=12, kspace_every=2, **LAMBDA_2FS)
    runs = [("k1", forces.water_water_fast)]
    if plain_drift:
        runs.append(("plain", forces.water_water_fast_plain))
    kernel = forces.water_water_fast
    try:
        for name, ww in runs:
            forces.water_water_fast = ww
            run = TiledEngine(ts, cfg, kspace_ep=pme).make_run(
                cfg.rebuild_every)
            t0 = time.perf_counter()
            h, t = _drift(run, st, nve_steps, cfg.rebuild_every)
            slope = float(np.polyfit(t * cfg.dt * 1e-6, h, 1)[0])
            res[f"nve_{name}"] = dict(
                steps=nve_steps, rows=int(h.size), h_first=float(h[0]),
                h_last=float(h[-1]), slope_kcal_per_ns=slope,
                spread=float(h.max() - h.min()),
                seconds=time.perf_counter() - t0)
    finally:
        forces.water_water_fast = kernel
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--nve-steps", type=int, default=480)
    ap.add_argument("--plain-drift", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_single_state: needs a GPU", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    out = os.path.abspath(args.out) if args.out else None
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    import constant_ph_tpu_torch as pkg
    from constant_ph_tpu_torch.tiled import cuda_ww

    if not os.path.abspath(pkg.__file__).startswith(root):
        raise RuntimeError(f"imported {pkg.__file__}, not from {root}")
    cuda_ww.build()
    dev = "cuda"
    t0 = time.perf_counter()
    res = dict(label=args.label, root=root,
               device=torch.cuda.get_device_name(0))
    if args.kernels:
        res["kernels"] = kernels(cs, dev, args.nve_steps, args.plain_drift)
    else:
        res["pme"], (system, ts, st) = pme_path(cs, dev)
        res["reference"] = reference_path(cs, system, ts, st)
        res["hewl"] = hewl_path(cs, dev)
    res["seconds"] = time.perf_counter() - t0
    line = json.dumps(res)
    print(line, flush=True)
    if out:
        with open(out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
