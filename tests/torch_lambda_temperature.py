"""The λ temperature of the tiled engine's production blocks in the JAX
package and in the port, on the CPU, from one equilibrated state.

chip_smoke.py's DSF and PME paths run production at dt 2 fs. This script
runs the same solvated acid (bench.py's build, cut to ``--n-side``) through
both packages at those settings and prints, for each package and seed, the
mean atom temperature and the mean, median and largest instantaneous λ
temperature T_lam of the one site, and the range of λ. ``--lambda bench``
keeps bench.py's λ settings (the EngineConfig defaults: λ Langevin γ 0.005
/fs, walls -0.5 and 1.5); ``--lambda production`` takes those of the JAX
package's production campaign driver (γ 0.05 /fs, walls -0.12 and 1.12,
examples/titration_metad_multisite.py:318-320), as chip_smoke.py does.

    python tests/torch_lambda_temperature.py --kind pme --lambda bench

Both packages start from the JAX package's state after 200 FIRE steps and
400 Langevin steps at dt 0.5 fs. The JAX runs draw their noise from
PRNGKey(100 + k), the port's from EngineConfig(seed=1 + k), k < --seeds:
the packages are compared by their statistics, not step by step. A
3,001-atom box (n_side 10) takes ~1-2 minutes a JAX run and ~15 a port run
on two CPU cores.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

PAIR = {"dsf": dict(cutoff=8.0, skin=0.8, coul_style="dsf", alpha=0.2),
        "pme": dict(cutoff=8.0, skin=0.8, coul_style="cut", alpha=0.30)}
LAMBDA = {"bench": {},
          "production": dict(lambda_gamma=0.05, lam_min=-0.12,
                             lam_max=1.12)}


def _stats(obs):
    import numpy as np

    tl = np.asarray(obs.temp_lam, np.float64).reshape(-1)
    lam = np.asarray(obs.lam, np.float64).reshape(-1)
    return dict(T_mean=float(np.mean(np.asarray(obs.temp))),
                T_lam_mean=float(tl.mean()), T_lam_median=float(
                    np.median(tl)), T_lam_max=float(tl.max()),
                lam_min=float(lam.min()), lam_max=float(lam.max()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kind", choices=sorted(PAIR), default="pme")
    ap.add_argument("--lambda", dest="lam", choices=sorted(LAMBDA),
                    default="bench")
    ap.add_argument("--n-side", type=int, default=10)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--dt", type=float, default=2.0)
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args(argv)

    import jax
    import numpy as np
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(args.threads)
    from constant_ph_tpu.engine import EngineConfig as JConfig
    from constant_ph_tpu.ops import pme as jpme
    from constant_ph_tpu.systems.water import solvated_acid
    from constant_ph_tpu.tiled import layout as jlayout
    from constant_ph_tpu.tiled.engine import TiledEngine as JEngine
    from constant_ph_tpu_torch import convert
    from constant_ph_tpu_torch.engine import EngineConfig
    from constant_ph_tpu_torch.tiled.engine import TiledEngine
    from test_torch_layout import fields_dict, port_of

    sys_ = solvated_acid(n_side=args.n_side, rigid_water=True,
                         lambda_coupled=True, hmr=3.0, pH=5.0,
                         **PAIR[args.kind])
    ts = jlayout.split_system(sys_, skin=0.8, tile_safety=1.72)
    st = jlayout.to_tiled(ts, sys_.state)
    pp = None
    if args.kind == "pme":
        pp = jpme.make_pme_params(np.asarray(sys_.state.box),
                                  ts.params.grid, PAIR["pme"]["alpha"],
                                  skin=0.8, spacing=1.5, p=6)
    eq = JEngine(ts, JConfig(dt=0.5, thermostat="langevin", T=300.0,
                             gamma=0.01, lambda_thermostat="langevin",
                             rebuild_every=8, force_cap=50.0), kspace_ep=pp)
    st, _ = jax.jit(eq.make_minimize(200))(st)
    st, _, _ = jax.jit(eq.make_run(400))(st)
    cfg = dict(dt=args.dt, thermostat="langevin", T=300.0, gamma=0.002,
               lambda_thermostat="langevin", rebuild_every=12,
               kspace_every=2 if pp is not None else 1, **LAMBDA[args.lam])
    head = dict(kind=args.kind, lam=args.lam, n_side=args.n_side,
                steps=args.steps, dt=args.dt,
                atoms=int(sys_.state.x.shape[0]))
    run = jax.jit(JEngine(ts, JConfig(**cfg), kspace_ep=pp)
                  .make_run(args.steps))
    for k in range(args.seeds):
        t0 = time.perf_counter()
        _, _, obs = jax.block_until_ready(
            run(st.replace(key=jax.random.PRNGKey(100 + k))))
        print(json.dumps(dict(head, package="jax", seed=100 + k,
                              seconds=time.perf_counter() - t0,
                              **_stats(obs))), flush=True)
    tts, tst = port_of(ts, st)
    tpp = (convert.pme_params(fields_dict(pp), device="cpu")
           if pp is not None else None)
    for k in range(args.seeds):
        t0 = time.perf_counter()
        eng = TiledEngine(tts, EngineConfig(**cfg, seed=1 + k),
                          kspace_ep=tpp)
        _, _, obs = eng.make_run(args.steps)(tst)
        print(json.dumps(dict(head, package="port", seed=1 + k,
                              seconds=time.perf_counter() - t0,
                              **_stats(obs))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
