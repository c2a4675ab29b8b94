"""Command-line driver (port of constant_ph_tpu/cli.py).

    python -m constant_ph_tpu_torch run sim.json             # on the GPU
    python -m constant_ph_tpu_torch run sim.json --device cpu
    python -m constant_ph_tpu_torch titrate sim.json --ph 2,3,4,5,6,7
    python -m constant_ph_tpu_torch calibrate sim.json [--method metad]

Every command takes ``--device`` (default ``cuda``; asking for CUDA on a
machine without it raises). The config is the JAX CLI's, and the output
too: ``#`` progress lines on stderr, and the summary as one JSON object
on the last line of stdout, with the same keys.

Config keys (all optional beyond `system`):
  system:   {builder: solvated_acid|water_box|solvated_polypeptide|lj_fluid
             |lammps_data, <builder kwargs>}
  engine:   EngineConfig fields (dt, thermostat, T, gamma, tau,
            lambda_nevery, lambda_thermostat, lambda_gamma, rebuild_every,
            force_cap, kspace_every, kspace_live_box, seed)
  bias:     BiasParams fields (w, s, k, a, b, r, m, d, switch_slope)
  kspace:   {style: ewald|pme, alpha, accuracy, spacing, p} (factorized
            Ewald, or smooth PME on the tiled path)
  metad:    {nbins, sigma, h0, gamma} (λ-metadynamics for `titrate
            --method metad` / `calibrate --method metad`)
  dg_ref:   scalar kcal/mol, or {base: scalar, class_offsets: {"<pK>":
            offset, ...}}: installed on every λ site at build time
  run:      {steps, minimize_steps, equilibrate_steps, tiled: bool,
             checkpoint: path, restart: path, observe_every,
             output: path.jsonl|path.csv, trajectory: path.dcd,
             traj_every: N (tiled path), pressure: atm, barostat_dlnv,
             steps_per_swap, n_swaps (titrate)}

Departures from the JAX CLI:
- The reference (non-tiled) engine gets the Ewald reciprocal space of a
  `kspace: {style: ewald}` config in `run` and `titrate`; the JAX CLI
  builds the parameters and then runs on the screened real space alone.
- Noise comes from one torch.Generator (engine.seed), saved in the
  port's checkpoints: a restart from a port checkpoint continues the
  noise; one from a JAX checkpoint (no generator state) draws it afresh,
  and says so on stderr.
- `titrate --method metad` runs its walkers one after another, each with
  its own generator (``_run_walkers``), where JAX vmaps them.
- A DCD frame carries the box of its chunk's end (the JAX CLI writes the
  built box, which an NPT run leaves behind); `run.pressure` on the
  reference engine is refused (the JAX CLI ignores it).
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import sys
import time

import numpy as np
import torch

from constant_ph_tpu_torch import resolve_device


def _load_config(path):
    text = open(path).read()
    if path.endswith((".yaml", ".yml")):
        try:
            import yaml
            return yaml.safe_load(text)
        except ImportError:
            raise SystemExit("pyyaml not available — use a .json config")
    return json.loads(text)


_BUILDERS = {
    "solvated_acid": "constant_ph_tpu_torch.systems.water:solvated_acid",
    "water_box": "constant_ph_tpu_torch.systems.water:water_box",
    "solvated_polypeptide":
        "constant_ph_tpu_torch.systems.protein:solvated_polypeptide",
    "lj_fluid": "constant_ph_tpu_torch.systems.lj:lj_fluid",
    # LAMMPS data file + λ-site JSON sidecar
    "lammps_data": "constant_ph_tpu_torch.systems.lammps_data:system_from_deck",
}


def _build_system(spec: dict, device="cuda"):
    """The System of a config's ``system`` block, built on ``device``."""
    name = spec.pop("builder")
    mod, fn = _BUILDERS[name].split(":")
    builder = getattr(importlib.import_module(mod), fn)
    return builder(device=device, **spec)


def _apply_dg_ref(cfg: dict, system):
    """Install a config-supplied ΔG_ref on the system's LambdaSpec: a
    scalar (one constant, kcal/mol) or {base, class_offsets: {"<pK>":
    offset}} (per-pK-class constants), at build time, so every command
    sees the same landscape."""
    if "dg_ref" not in cfg:
        return system
    from constant_ph_tpu_torch import titration

    val = cfg["dg_ref"]
    if isinstance(val, dict):
        offs = {float(k): float(v)
                for k, v in (val.get("class_offsets") or {}).items()}
        system.spec = titration.apply_dG_ref_per_class(
            system.spec, float(val["base"]), offs)
    else:
        system.spec = titration.apply_dG_ref(system.spec, float(val))
    return system


def _make_engines(cfg: dict, system):
    """(EngineConfig, BiasParams, k-space): EwaldParams for style ewald,
    a deferred ("pme", spec) for style pme (its mesh follows the tile
    grid, known only after split_system; see _resolve_kspace), or None."""
    from constant_ph_tpu_torch.engine import EngineConfig
    from constant_ph_tpu_torch.lambda_dyn import BiasParams

    ecfg = EngineConfig(**cfg.get("engine", {}))
    bias = BiasParams(**cfg.get("bias", {}))
    kspace_ep = None
    if "kspace" in cfg:
        ks = cfg["kspace"]
        if ks.get("style", "ewald") == "pme":
            kspace_ep = ("pme", dict(ks))
        else:
            from constant_ph_tpu_torch.ops.ewald import make_ewald_params

            kspace_ep = make_ewald_params(
                system.state.box.cpu().numpy(), ks["alpha"],
                accuracy=ks.get("accuracy", 1e-4),
                device=system.state.box.device)
    return ecfg, bias, kspace_ep


def _is_pme(kspace_ep) -> bool:
    return (isinstance(kspace_ep, tuple) and bool(kspace_ep)
            and kspace_ep[0] == "pme")


def _resolve_kspace(kspace_ep, box, ts):
    """Turn a deferred ("pme", spec) into PMEParams on the tile grid
    (defaults: spacing 1.5, p 6); anything else passes through."""
    if not _is_pme(kspace_ep):
        return kspace_ep
    from constant_ph_tpu_torch.ops.pme import make_pme_params

    ks = kspace_ep[1]
    return make_pme_params(
        box.cpu().numpy(), ts.params.grid, ks["alpha"],
        spacing=ks.get("spacing", 1.5), p=ks.get("p", 6),
        skin=ts.params.skin, device=ts.device)


def _reference_kspace_fn(kspace_ep):
    """The reference engine's k-space hook for a config's kspace: Ewald's
    reciprocal space, or None; PME is refused (tiled engine only)."""
    if _is_pme(kspace_ep):
        raise SystemExit(
            "kspace style 'pme' requires the tiled engine "
            "(run.tiled: true + rigid water); use style 'ewald' here")
    if kspace_ep is None:
        return None
    from constant_ph_tpu_torch.ops.ewald import make_kspace_fn

    return make_kspace_fn(kspace_ep)


def _setup(args):
    """(config, device, system, EngineConfig, BiasParams, k-space) of a
    command."""
    cfg = _load_config(args.config)
    dev = resolve_device(args.device)
    system = _apply_dg_ref(cfg, _build_system(dict(cfg["system"]), dev))
    return (cfg, dev, system) + _make_engines(cfg, system)


def _restart(path, dev, generator):
    """The state of a checkpoint; the generator's state is restored from
    a port checkpoint, and left at its seed for a JAX one."""
    from constant_ph_tpu_torch import checkpoint

    try:
        state = checkpoint.load(path, dev, generator=generator)
    except KeyError:
        state = checkpoint.load(path, dev)
        print(f"# {path} holds no generator state (a JAX checkpoint): "
              "the noise restarts from engine.seed", file=sys.stderr)
    print(f"# restarted from {path} at step {int(state.step)}",
          file=sys.stderr)
    return state


def cmd_run(args):
    cfg, dev, system, ecfg, bias, kspace_ep = _setup(args)
    run_cfg = cfg.get("run", {})
    tiled = run_cfg.get("tiled", True)
    t0 = time.time()
    gen = torch.Generator(device=dev).manual_seed(ecfg.seed)
    state = system.state
    if run_cfg.get("restart"):
        state = _restart(run_cfg["restart"], dev, gen)

    n_steps = int(run_cfg.get("steps", 1000))
    observe_every = int(run_cfg.get("observe_every", 10))
    n_min = int(run_cfg.get("minimize_steps", 200))

    if tiled and system.constraints is not None:
        from constant_ph_tpu_torch.tiled.elastic import elastic_run
        from constant_ph_tpu_torch.tiled.engine import TiledEngine
        from constant_ph_tpu_torch.tiled.layout import (
            retile_auto, split_system, to_canonical, to_tiled,
        )

        ts = split_system(system, device=dev)
        tst = to_tiled(ts, state)
        kspace_ep = _resolve_kspace(kspace_ep, system.state.box, ts)
        eng = TiledEngine(ts, ecfg, bias=bias, kspace_ep=kspace_ep)
        if n_min:
            tst, e = eng.make_minimize(n_min)(tst)
            print(f"# minimized to E={float(e[-1]):.1f}", file=sys.stderr)
        # optional equilibration, then a retile to the measured occupancy
        # (read on the host between phases)
        eq_steps = int(run_cfg.get("equilibrate_steps", 0))
        if eq_steps:
            tst, _, _ = eng.make_run(eq_steps)(tst, gen)
            occ = int(tst.wvalid.sum(dim=1).max())
            ts, tst = retile_auto(ts, tst, occ)
            print(f"# equilibrated {eq_steps} steps, retiled occ {occ} -> "
                  f"W {ts.params.W}", file=sys.stderr)

        traj = run_cfg.get("trajectory")
        every = int(run_cfg.get("traj_every", max(observe_every, 100)))
        if traj and every % ecfg.rebuild_every:
            every = -(-every // ecfg.rebuild_every) * ecfg.rebuild_every
            print(f"# traj_every rounded up to {every} (must be a multiple "
                  f"of rebuild_every={ecfg.rebuild_every})", file=sys.stderr)
        chunk = every if traj else min(n_steps, 2000)
        dw = None
        if traj:
            from constant_ph_tpu_torch.trajectory import DCDWriter

            dw = DCDWriter(traj, int(system.state.x.shape[0]),
                           dt_fs=ecfg.dt)

        def on_chunk(done, ts_c, tst_c, obs_c):
            if dw is not None:
                dw.write_frame(to_canonical(ts_c, tst_c).x, tst_c.box)

        kw = dict(chunk=chunk, bias=bias, kspace_ep=kspace_ep,
                  on_chunk=on_chunk, generator=gen)
        pressure = run_cfg.get("pressure")
        if pressure is not None:
            # NpT: an MC volume move after each chunk (tiled/npt.py); with
            # k-space only as PME on the live box
            if kspace_ep is not None and not ecfg.kspace_live_box:
                raise ValueError(
                    "run.pressure (NPT) with a kspace style needs "
                    '{"kspace": {"style": "pme", ...}, "engine": '
                    '{"kspace_live_box": true}} — baked-box reciprocal '
                    "params would be evaluated stale after volume moves")
            from constant_ph_tpu_torch.tiled.npt import npt_elastic_run

            ts, tst, obs, info, npt_stats = npt_elastic_run(
                ts, tst, ecfg, n_steps, pressure_atm=float(pressure),
                max_dlnV=float(run_cfg.get("barostat_dlnv", 2e-3)), **kw)
            vol = npt_stats["volume"]
            print(f"# NPT: {npt_stats['accepted']}/"
                  f"{npt_stats['proposed']} volume moves accepted, "
                  f"V {vol[0]:.0f} -> {vol[-1]:.0f} A^3", file=sys.stderr)
        else:
            ts, tst, obs, info = elastic_run(ts, tst, ecfg, n_steps, **kw)
        if dw is not None:
            dw.close()
            print(f"# trajectory -> {traj}", file=sys.stderr)
        state = to_canonical(ts, tst)
        if info.n_retiles:
            print(f"# retiled {info.n_retiles}x (final W {info.final_W})",
                  file=sys.stderr)
        if info.n_dangerous_blocks:
            print(f"# WARNING: {info.n_dangerous_blocks} dangerous-build "
                  f"blocks (water drift past skin between rebins)",
                  file=sys.stderr)
    else:
        from constant_ph_tpu_torch.minimize import fire_minimize

        if run_cfg.get("pressure") is not None:
            raise SystemExit("run.pressure (NPT) requires the tiled engine "
                             "(run.tiled: true + rigid water)")
        eng = system.make_engine(ecfg, bias=bias,
                                 kspace_fn=_reference_kspace_fn(kspace_ep))
        if n_min:
            state, _ = fire_minimize(eng, state, n_steps=n_min)
        state, _, obs = eng.run(state, n_steps, generator=gen)

    if run_cfg.get("checkpoint"):
        from constant_ph_tpu_torch import checkpoint

        checkpoint.save(run_cfg["checkpoint"], state, generator=gen)
        print(f"# checkpoint -> {run_cfg['checkpoint']}", file=sys.stderr)

    from constant_ph_tpu_torch import observables as obsmod

    out = run_cfg.get("output")
    if out:
        with open(out, "w") as fh:
            if out.endswith(".csv"):
                obsmod.write_csv(obs, fh, every=observe_every)
            else:
                obsmod.write_jsonl(obs, fh, every=observe_every)
        print(f"# observables -> {out}", file=sys.stderr)

    lam = obs.lam.cpu().numpy()
    summary = {
        "steps": n_steps,
        "wall_s": round(time.time() - t0, 2),
        "e_pot": float(obs.e_pot[-1]),
        "temp": float(obs.temp[-100:].mean()),
    }
    if lam.size:
        summary["protonation_fraction"] = (
            obsmod.protonation_fraction(lam).tolist())
        summary["lambda_final"] = lam[-1].tolist()
    print(json.dumps(summary))


def cmd_titrate(args):
    """pH sweep: replica exchange (default) or λ-metadynamics walkers."""
    if getattr(args, "method", "rex") == "metad":
        return _titrate_metad(args)

    from constant_ph_tpu_torch.observables import hh_curve
    from constant_ph_tpu_torch.parallel.replica import (
        make_rex_runner, stack_replicas,
    )

    cfg, dev, system, ecfg, bias, kspace_ep = _setup(args)
    pHs = [float(p) for p in args.ph.split(",")]
    eng = system.make_engine(ecfg, bias=bias,
                             kspace_fn=_reference_kspace_fn(kspace_ep))
    st0 = system.state
    batched = stack_replicas([
        dataclasses.replace(st0, pH=torch.tensor(ph, dtype=st0.pH.dtype,
                                                 device=dev))
        for ph in pHs])
    # one list build for the batch; each replica keeps its own list
    nbrs = eng.build_neighbors(batched.x, batched.box)

    steps_per_swap = int(cfg.get("run", {}).get("steps_per_swap", 100))
    n_swaps = int(cfg.get("run", {}).get("n_swaps", 20))
    # the replicas run as one batch, one run call a block; replica r's
    # Langevin noise comes from its own generator (seeded from engine.seed
    # and r); this one draws the swap uniforms
    block = make_rex_runner(eng, steps_per_swap)
    gen = torch.Generator(device=dev).manual_seed(ecfg.seed)
    frac = torch.zeros(len(pHs), device=dev)
    acc = torch.zeros((), device=dev)
    for s in range(n_swaps):
        batched, nbrs, gen, accepted, obs = block(batched, nbrs, gen, s % 2)
        frac += torch.mean((obs.lam > 0.5).to(torch.float32), dim=-1)
        acc += torch.mean(accepted.to(torch.float32))
    out = {
        "pH": pHs,
        "deprotonated_fraction": (frac / n_swaps).tolist(),
        "hh_reference": hh_curve(
            float(system.spec.pK[0]), np.asarray(pHs)).tolist(),
        "swap_acceptance": float(acc) / n_swaps,
    }
    print(json.dumps(out))


def _titrate_metad(args):
    """One well-tempered λ-metadynamics walker per pH on the tiled engine:
    the bias profile gives per-site deprotonated fractions (tail-time
    average over the second half of the chunks)."""
    from constant_ph_tpu_torch import metad
    from constant_ph_tpu_torch.observables import hh_curve
    from constant_ph_tpu_torch.parallel.replica import (
        _fold_in, replica_generators, stack_replicas,
    )
    from constant_ph_tpu_torch.tiled.engine import TiledEngine
    from constant_ph_tpu_torch.tiled.layout import split_system, to_tiled

    cfg, dev, system, ecfg, bias, kspace_ep = _setup(args)
    pHs = [float(p) for p in args.ph.split(",")]
    ts = split_system(system, device=dev)
    tst = to_tiled(ts, system.state)
    kspace_ep = _resolve_kspace(kspace_ep, system.state.box, ts)
    mp = metad.MetadParams(
        stride=max(1, int(round(50.0 / ecfg.dt))),
        **cfg.get("metad", {}))
    eng = TiledEngine(ts, ecfg, bias=bias, kspace_ep=kspace_ep, metad=mp)
    S = ts.spec.n_sites
    V0, dV0 = metad.init_tables(S, mp, device=dev)
    # the metad engine needs the state to carry tables of matching shape
    # before its first force evaluation
    tst = dataclasses.replace(tst, metad_v=V0, metad_dv=dV0)
    tst, _ = eng.make_minimize(
        int(cfg.get("run", {}).get("minimize_steps", 200)))(tst)
    # the walkers are one batch: a chunk of all of them is one run call
    walkers = stack_replicas([dataclasses.replace(
        tst, pH=torch.tensor(p, dtype=tst.pH.dtype, device=dev),
        metad_v=V0, metad_dv=dV0) for p in pHs])
    gens = replica_generators(
        [_fold_in(ecfg.seed, 100 + i) for i in range(len(pHs))], dev)

    n_steps = int(cfg.get("run", {}).get("steps", 20_000))
    chunk = 50 * ecfg.rebuild_every
    n_chunks = max(1, n_steps // chunk)
    run = eng.make_run(chunk)
    frac_sum = torch.zeros((len(pHs), S), device=dev)
    n_tail = 0
    for c in range(n_chunks):
        walkers = run(walkers, gens)[0]
        if c >= n_chunks // 2:              # tail-time-averaged estimator
            frac_sum += metad.deprotonated_fraction(
                walkers.metad_v.reshape(len(pHs) * S, mp.nbins),
                mp).reshape(len(pHs), S)
            n_tail += 1
    frac = (frac_sum / max(n_tail, 1)).cpu().numpy()
    out = {
        "method": "metad",
        "pH": pHs,
        "deprotonated_fraction": frac[:, 0].tolist(),
        "per_site": frac.tolist(),
        "hh_reference": hh_curve(
            float(system.spec.pK[0]), np.asarray(pHs)).tolist(),
        "steps": n_chunks * chunk,
    }
    print(json.dumps(out))


def cmd_calibrate(args):
    """ΔG_ref calibration: TI over frozen-λ windows for site 0 (default),
    or per-site λ-metadynamics (--method metad)."""
    from constant_ph_tpu_torch import titration
    from constant_ph_tpu_torch.tiled.engine import TiledEngine
    from constant_ph_tpu_torch.tiled.layout import split_system, to_tiled

    cfg, dev, system, ecfg, bias, kspace_ep = _setup(args)
    ts = split_system(system, device=dev)
    tst = to_tiled(ts, system.state)
    kspace_ep = _resolve_kspace(kspace_ep, system.state.box, ts)
    eng = TiledEngine(ts, ecfg, bias=bias, kspace_ep=kspace_ep)
    tst, _ = eng.make_minimize(300)(tst)
    tst, _, _ = eng.make_run(int(args.equil))(tst)
    if getattr(args, "method", "ti") == "metad":
        from constant_ph_tpu_torch import metad

        mp = None
        if "metad" in cfg:
            mp = metad.MetadParams(
                stride=max(1, int(round(50.0 / ecfg.dt))),
                **cfg["metad"])
        dg = titration.calibrate_dG_ref_metad(
            ts, tst, ecfg, bias=bias, kspace_ep=kspace_ep,
            metad_params=mp, n_steps=int(args.samples))
        print(json.dumps({"dG_ref_per_site": [float(d) for d in dg],
                          "method": "metad"}))
        return
    dG, (nodes, prof) = titration.calibrate_dG_ref_tiled(
        ts, tst, ecfg, bias=bias, kspace_ep=kspace_ep,
        equil_steps=int(args.window_equil), sample_steps=int(args.samples),
        return_profile=True)
    print(json.dumps({
        "dG_ref": dG,
        "lambda_nodes": nodes.tolist(),
        "dUdlam_profile": [float(p) for p in prof],
    }))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="constant_ph_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add(name, fn, **kw):
        p = sub.add_parser(name, **kw)
        p.add_argument("config")
        p.add_argument("--device", default="cuda",
                       help="torch device (default cuda; cpu runs the "
                            "kernels' plain versions)")
        p.set_defaults(fn=fn)
        return p

    add("run", cmd_run, help="run an MD simulation from a config")
    p_t = add("titrate", cmd_titrate, help="pH titration sweep")
    p_t.add_argument("--ph", required=True, help="comma-separated pH values")
    p_t.add_argument("--method", choices=["rex", "metad"], default="rex",
                     help="replica exchange (reference engine) or "
                          "λ-metadynamics walkers (tiled engine, full-Δq)")
    p_c = add("calibrate", cmd_calibrate,
              help="dG_ref calibration (TI site 0 / metad all)")
    p_c.add_argument("--equil", default=2000)
    p_c.add_argument("--window-equil", default=1000)
    p_c.add_argument("--samples", default=5000)
    p_c.add_argument("--method", choices=["ti", "metad"], default="ti")
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
