"""The control of ``correct``: the reference computed in TF32 put in the
program's place. The window runs the program as usual, so that the
states judged are the window's own; at its end the outputs that judge()
reads of the program (forces, λ forces, the recorded energy, the next
step's positions, the bias tables) are the TF32 reference's instead,
and the run's own comparison (reference/check.py ``judge``) decides.
Its ``correct`` has to come out false.

    python3 cph_bench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 10

prints one line a seed: the control's readings beside their limits. The
benchmark's own runs never run this."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Control:
    """A driver's run with the TF32 reference in the program's place at
    the end: block(), reset() and the counts are the run's own."""

    def __init__(self, ctx, run):
        self.ctx, self.run = ctx, run

    def __getattr__(self, name):
        return getattr(self.run, name)

    def judged(self):
        import torch

        from cph_bench import prepare
        from cph_bench.reference import check
        from cph_bench.reference import forces as rf
        from cph_bench.reference import metad as rm

        ctx = self.ctx
        J = self.run.judged()
        top = rf.topology(ctx.inputs, ctx.device)
        low = rf.Precision("tf32")
        kw = dict(T=J["step"]["T"], dG_ref=float(ctx.config["dG_ref"]),
                  pme=check.pme_of(ctx.config), prec=low,
                  rows=ctx.reference_rows)
        md = J["metad"]
        if md is not None:
            mp = check.metad_params(md)
            hills = rf.tf32_round(torch.cat(md["hills"], dim=1))
            k_last = md["hills"][-1].shape[1]

            def tables(h):
                return tuple(rf.tf32_round(t).to(torch.float64)
                             for t in rm.tables(h, h.shape[-1], mp,
                                                ctx.device))

            now = [tables(hills[g]) for g in range(hills.shape[0])]
            before = [tables(hills[g, :-k_last])
                      for g in range(hills.shape[0])]
        gen = torch.Generator(device=ctx.device).manual_seed(
            prepare.derive(ctx.seed, 7))
        for r in range(J["x"].shape[0]):
            X, box, lam = J["x"][r], J["box"][r], J["lam"][r]
            pH, obs_pH = float(J["pH"][r]), float(J["obs_pH"][r])
            g = None if md is None else r // md["walkers_per_ph"]
            ev = rf.evaluate(X, box, lam, pH, top,
                             metad=None if md is None else (mp,) + now[g],
                             **kw)
            J["f"][r] = ev.f_short + ev.f_recip
            J["f_lam"][r] = ev.f_lam
            ev_e = ev
            if md is not None or obs_pH != pH:
                ev_e = rf.evaluate(
                    X, box, lam, obs_pH, top,
                    metad=None if md is None else (mp,) + before[g], **kw)
            J["e_pot"][r] = ev_e.e_pot - (
                0.0 if bool(J["e_has_kspace"][r]) else ev_e.e_kspace)
            J["x1"][r] = _step(top, X, J["v"][r],
                               ev.f_short + J["kspace_factor"] * ev.f_recip,
                               J["step"], gen)
            if md is not None:
                md["v"][r] = now[g][0]
        return J


def _step(top, X, V, F, step, gen):
    """One BAOAB step of every rigid body (a water, a free solute atom)
    as a whole, rounded to TF32: the centre of mass moves by the
    deterministic part plus Langevin noise of the step's deviation, and
    the body's atoms with it (so the constraints hold)."""
    import torch

    from cph_bench.inputs import common as c
    from cph_bench.reference import check
    from cph_bench.reference import forces as rf

    dt = step["dt"]
    c1 = math.exp(-step["gamma"] * dt)
    kT = c.BOLTZ * step["T"]
    waters, free = check._bodies(top)
    X1 = X.clone()
    for ids in (torch.as_tensor(waters, device=X.device),
                torch.as_tensor(free, device=X.device)[:, None]):
        if not ids.numel():
            continue
        m = top.mass[ids]
        M = m.sum(-1, keepdim=True)
        v_b = ((V[ids] * m[..., None]).sum(1) / M
               + 0.5 * dt * F[ids].sum(1) / (M * c.MVV2E))
        dev = 0.5 * dt * torch.sqrt((1.0 - c1 * c1) * kT / (M * c.MVV2E))
        noise = torch.randn(v_b.shape, generator=gen, dtype=v_b.dtype,
                            device=v_b.device)
        move = 0.5 * dt * (1.0 + c1) * v_b + dev * noise
        X1[ids] = X[ids] + move[:, None, :]
    return rf.tf32_round(X1).to(torch.float64)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".cph_cache",
                                                  "triton")
    sys.path.insert(0, ROOT)

    import torch

    from cph_bench import harness

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("cph_bench: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(min(2, torch.get_num_threads()))
    t0 = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        result, checks = harness.run_cell(cell, seed, args.seconds, False,
                                          "cuda", t0, wrap=Control)
        print(json.dumps(dict(seed=seed, correct=result["correct"],
                              failed=result["failed"],
                              attempted=result["attempted"],
                              control=result["checks"],
                              notes=result["notes"])), flush=True)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
