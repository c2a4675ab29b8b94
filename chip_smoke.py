#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (constant_ph_tpu_torch).

    python3 chip_smoke.py [--profile]

Run from the root of the repository on a machine with one NVIDIA GPU
(Hopper, sm_90a) and nvcc. It fails, printing no result, when CUDA is not
available or the port's package is not beside it.

1. Kernel phase: builds csrc/ww_pair.cu (K1) and csrc/ww_tally.cu (K2),
   one nvcc each, started together, and holds each CUDA kernel against its
   plain PyTorch version (tiled.forces.water_water_fast_plain,
   water_water_tally_plain) on a small dilute box in both Coulomb styles.
2. DSF path (the ``entry()`` configuration): solvated_acid (n_side=20,
   DSF rc=8 Å, α=0.2, HMR 3, pH 5) → split_system(skin=0.8,
   tile_safety=1.72) → 400 FIRE steps → 800 Langevin equilibration steps
   → retile to the measured occupancy → 2 warm-up and 10 measured
   sync-free production blocks (dt 2 fs, λ Langevin, rebuild_every 12).
3. PME main path (the ``bench.py`` default) at the same 24,001 atoms:
   'cut' Coulomb α=0.30 rc=8 Å, PME mesh spacing 1.5, p=6 (48³);
   400 FIRE + 800 equilibration steps at kspace_every=1, retile, then 2
   warm-up and 20 measured 12-step production blocks at kspace_every=2
   (impulse MTS), sync-free. PME must run on boundary steps only, and the
   card's pme_recip_tiled is held against the same call on the CPU.
4. Tally path on the PME production tiles: blocks with
   TiledEngine(use_pallas_ww=True) (K2 on every force evaluation), the
   compute_Hs sum rule, and K2 against K1 through compute_forces.

Every path zeroes the kernels' launch counters just before it runs and
reads them just after; each kernel of a path must have launched once per
force evaluation. The kernels are timed against their plain versions and
their bounds at the PME production tiles.

``--profile`` adds one PME production block under torch.profiler (device
busy time by kernel and the device's idle share).

Output: human-readable lines, then one JSON line {"kernels": [...]}, the
card's name and power limit as nvidia-smi reports them, and last
{"ok": true, "device": {...}}. Any failed check raises (non-zero exit).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet): FP32 outside the tensor
# cores and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# FP32 operations per atom pair in ww_pair.cu's pair loop, an FMA counted
# as 2: 76 for the screened Coulomb term and the force update, plus 14 for
# LJ on the O-O ninth of the pairs
FLOPS_PER_PAIR = 76 + 14 / 9
# ... in ww_tally.cu's pair loop, an FMA as 2 and rint, division, sqrt and
# exp as 1 each: 12 min image, 5 r², 3 weight and clamp, 2 for 1/r² and r,
# 18 erfc and gaussian, 4 u and w, 2 cutoff masks, 13 charge product,
# force and φ sums, 3 differences, 4 masks, plus 11 for LJ on the O-O
# ninth of the pairs (the kernel masks it on every pair; the function
# needs it on those only); the DSF shifts add 6
FLOPS_PER_PAIR_TALLY = {"cut": 66 + 11 / 9, "dsf": 72 + 11 / 9}
# agreement of kernel and plain version, both float32 sums: energies
# within rtol 1e-5 plus atol 1e-4 kcal/mol (the tolerance
# tests/test_pallas_ww.py holds the JAX package's two water-water paths
# to; the atol covers totals that are small differences of large ± terms),
# forces (and K2's φ) scaled by max(1, |max|) within 1e-5. K1 sums in
# another order than its plain version (full stencil vs half stencil with
# roll-back): its force differences reached 1.03e-5 of max|f| (7.4e-4 of
# 72 kcal/mol/Å) at the equilibrated 24,001-atom tiles, float32 rounding
# of sums of ~±100 terms, so K1's force bar is 3e-5. K2 and its plain
# version both sum the full stencil from the i side (measured ≤ 1.8e-6)
TOL_E_REL = 1e-5
TOL_E_ABS = 1e-4
TOL_F_SCALED = 1e-5
TOL_F_SCALED_K1 = 3e-5
# PME on the card against the same call on the CPU, both float32 with
# different FFTs and sum orders: energy rtol 1e-5; forces and φ within
# 5e-4 of their max. Float32 PME is itself 1.1-1.4e-4 of max from
# float64 (the truncated-power B-splines cancel terms of ~1e3 down to ≤ 1;
# tests/test_torch_pme.py::test_pme_float32_against_float64), and the
# card-CPU difference measured 1.95e-4 at the production tiles; a
# wrong mesh, FFT or spline term gives errors of order 1. TF32 is
# checked off directly
TOL_PME_E_REL = 1e-5
TOL_PME_SCALED = 5e-4
# K2 against K1 through compute_forces at 'cut' α 0.30: K1 screens with
# a degree-10 Chebyshev fit of erfc and K2 with the Abramowitz–Stegun
# polynomial, and they sum in other orders. On the H100 at the PME
# production tiles (this script, three runs) they differed by 1.2e-5 –
# 1.33e-5 relative in e_coul and e_pot and by 1.05e-5 – 1.68e-5 of max
# in forces, so the forces fail the 1e-5 bar tests/test_tiled.py sets at
# DSF α 0.2. The bars are ~2-4× the largest readings
TOL_K2_K1_E_REL = 5e-5
TOL_K2_K1_F_SCALED = 3e-5


def log(msg):
    print(msg, flush=True)


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def _bound(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def ww_bound_ms(G, A):
    """Least time for one water-water evaluation: the larger of the bytes
    it must move (wx in, f out) over HBM bandwidth and its FP32 work over
    the FP32 peak. Work counts each unordered pair once, as the function
    needs: 13 neighbour tiles of A×A pairs plus half the self tile."""
    return _bound(2 * 3 * G * A * 4 + 3 * 4 + 2 * 4,
                  G * A * A * 13.5 * FLOPS_PER_PAIR)


def tally_bound_ms(G, A, style):
    """The same for the full-tally kernel: the 6 used rows of the packed
    tiles in, the 6 computed output rows out (the last two rows of each
    are padding), and each unordered pair once at its FLOP count."""
    return _bound(2 * 6 * G * A * 4 + 3 * 4,
                  G * A * A * 13.5 * FLOPS_PER_PAIR_TALLY[style])


def zero_counts():
    from constant_ph_tpu_torch.tiled import cuda_ww

    cuda_ww.water_water_cuda.launches = 0
    cuda_ww.water_water_tally_cuda.launches = 0


def read_counts():
    from constant_ph_tpu_torch.tiled import cuda_ww

    return {"ww_pair": cuda_ww.water_water_cuda.launches,
            "ww_tally": cuda_ww.water_water_tally_cuda.launches}


def e_close(got, ref):
    return abs(got - ref) <= TOL_E_ABS + TOL_E_REL * abs(ref)


def cuda_ms(fn, n):
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def check_ww(ts, st, label, timing=True):
    """Kernel vs plain version on one tile set; returns the numbers."""
    import torch

    from constant_ph_tpu_torch.tiled import forces

    p = ts.params
    gx, gy, gz = p.grid
    wxg = st.wx.reshape(3, gx, gy, gz, 3 * p.W)
    kw = dict(style=ts.coul_style, alpha=ts.alpha, rc=ts.cutoff)

    def kernel():
        return forces.water_water_fast(wxg, ts.water, p, st.box, **kw)

    def plain():
        return forces.water_water_fast_plain(wxg, ts.water, p, st.box, **kw)

    got = kernel()
    ref = plain()
    torch.cuda.synchronize()
    for t in (*got, *ref):
        if not torch.isfinite(t).all():
            raise RuntimeError(f"{label}: non-finite water-water output")
    if got[2].shape != wxg.shape:
        raise RuntimeError(f"{label}: force shape {tuple(got[2].shape)}")
    e_rel = max(abs(float(got[i]) - float(ref[i]))
                / max(abs(float(ref[i])), 1e-30) for i in (0, 1))
    e_ok = all(e_close(float(got[i]), float(ref[i])) for i in (0, 1))
    scale = max(1.0, float(torch.abs(ref[2]).max()))
    f_abs = float(torch.abs(got[2] - ref[2]).max())
    res = dict(label=label, G=p.G, A=3 * p.W, style=ts.coul_style,
               e_lj=float(got[0]), e_lj_plain=float(ref[0]),
               e_coul=float(got[1]), e_coul_plain=float(ref[1]),
               e_rel_err=e_rel, f_abs_err=f_abs, f_scaled_err=f_abs / scale)
    if timing:
        res["ms"] = cuda_ms(kernel, 50)
        res["plain_ms"] = cuda_ms(plain, 5)
        res["bound_ms"], res["bound_by"] = ww_bound_ms(p.G, 3 * p.W)
    log(f"[kernel] ww_pair {json.dumps(res)}")
    if not e_ok or f_abs / scale > TOL_F_SCALED_K1:
        raise RuntimeError(f"{label}: CUDA kernel disagrees with its plain "
                           f"version (energy rel {e_rel:.3g}, force scaled "
                           f"{f_abs / scale:.3g})")
    return res


def check_tally(ts, st, label, timing=True):
    """K2 against its plain version on one tile set; returns the numbers.
    Energies are the sums of the eatom rows; forces and φ are compared
    within TOL_F_SCALED of their max."""
    import torch

    from constant_ph_tpu_torch.tiled import cuda_ww, forces

    p = ts.params
    gx, gy, gz = p.grid
    wt = forces.pack_water_tiles(st.wx.reshape(3, gx, gy, gz, 3 * p.W),
                                 st.wvalid.reshape(gx, gy, gz, p.W),
                                 ts.water, p)
    kw = dict(style=ts.coul_style, alpha=ts.alpha, rc=ts.cutoff)

    def kernel():
        return cuda_ww.water_water_tally_cuda(wt, st.box, ts.water, p, **kw)

    def plain():
        return forces.water_water_tally_plain(wt, st.box, ts.water, p, **kw)

    got = kernel()
    ref = plain()
    torch.cuda.synchronize()
    if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        raise RuntimeError(f"{label}: non-finite full-tally output")
    if got.shape != wt.shape or got[..., 6:, :].any():
        raise RuntimeError(f"{label}: bad full-tally output layout")
    e = [float(torch.sum(got[..., r, :])) for r in (3, 4)]
    e_ref = [float(torch.sum(ref[..., r, :])) for r in (3, 4)]
    e_rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(e, e_ref))
    errs = {}
    for name, rows in (("f", slice(0, 3)), ("eatom", slice(3, 5)),
                       ("phi", slice(5, 6))):
        d = float(torch.abs(got[..., rows, :] - ref[..., rows, :]).max())
        errs[name] = (d, d / max(1.0, float(torch.abs(ref[..., rows, :])
                                            .max())))
    res = dict(label=label, G=p.G, A=3 * p.W, style=ts.coul_style,
               e_lj=e[0], e_lj_plain=e_ref[0], e_coul=e[1],
               e_coul_plain=e_ref[1], e_rel_err=e_rel,
               f_abs_err=errs["f"][0], f_scaled_err=errs["f"][1],
               phi_abs_err=errs["phi"][0], phi_scaled_err=errs["phi"][1],
               eatom_scaled_err=errs["eatom"][1])
    if timing:
        res["ms"] = cuda_ms(kernel, 50)
        res["plain_ms"] = cuda_ms(plain, 5)
        res["bound_ms"], res["bound_by"] = tally_bound_ms(p.G, 3 * p.W,
                                                          ts.coul_style)
    log(f"[kernel] ww_tally {json.dumps(res)}")
    if (not all(e_close(a, b) for a, b in zip(e, e_ref))
            or max(v[1] for v in errs.values()) > TOL_F_SCALED):
        raise RuntimeError(f"{label}: CUDA full-tally kernel disagrees with "
                           f"its plain version ({res})")
    return res


def kernel_phase(dev):
    """Build the kernel, then check it on a small dilute box (both Coulomb
    styles)."""
    from constant_ph_tpu_torch.systems.water import solvated_acid
    from constant_ph_tpu_torch.tiled import cuda_ww
    from constant_ph_tpu_torch.tiled.layout import split_system, to_tiled

    t0 = time.perf_counter()
    built = cuda_ww.build()
    log(f"[build] {', '.join(os.path.relpath(v[0]) for v in built.values())}"
        f" in {time.perf_counter() - t0:.1f} s (one nvcc per source, "
        "in parallel)")
    for name, (_, msgs) in built.items():
        for line in msgs.splitlines():
            if "ptxas" in line:
                log(f"[build] {name}: {line.strip()}")
    for style, alpha in (("dsf", 0.2), ("cut", 0.35)):
        sys_ = solvated_acid(n_side=8, spacing=6.4, cutoff=8.0, seed=12,
                             coul_style=style, alpha=alpha, device=dev)
        ts = split_system(sys_, skin=2.0, tile_safety=0.2, device=dev)
        st = to_tiled(ts, sys_.state)
        check_ww(ts, st, f"dilute-{style}", timing=False)
        check_tally(ts, st, f"dilute-{style}", timing=False)


def profile_block(run_block, st, ms_step, block):
    """torch.profiler over one production block: device busy time by
    kernel, kernel launches per step, and the device's idle share against
    the unprofiled step time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st, _, _ = run_block(st)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    # device-side rows (kernels, copies); where the profiler lists none,
    # each CPU op's self device time counts its own kernels once
    rows = [(e.self_device_time_total, e.count, e.key) for e in ka
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not rows:
        rows = [(e.self_device_time_total, e.count, e.key) for e in ka
                if e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3 / block
    log(f"[profile] device busy {busy_ms:.3f} ms/step of {ms_step:.3f}: "
        f"idle share {1.0 - busy_ms / ms_step:.4f}; "
        f"{sum(r[1] for r in rows) / block:.0f} device ops/step")
    for us, n, key in rows[:12]:
        log(f"[profile] {us / 1e3 / block:9.4f} ms/step {n / block:6.1f}/step "
            f"{key[:90]}")
    return st


PAIR = {"dsf": dict(cutoff=8.0, coul_style="dsf", alpha=0.2),
        "pme": dict(cutoff=8.0, coul_style="cut", alpha=0.30)}
PME_MESH = dict(spacing=1.5, p=6)


def md_path(dev, kind, n_side=20, n_min=400, n_eq=800, n_meas=20,
            profile=False):
    """One MD path through the port's entry points at the bench size:
    build → minimise → equilibrate (kspace_every 1) → retile → warm-up and
    measured production blocks (kspace_every 2 with PME). The launch
    counters are zeroed just before the run and read just after; every
    force evaluation must have gone through K1. Smaller sizes only serve
    a rehearsal on the CPU. Returns the run's objects and numbers."""
    import torch

    from constant_ph_tpu_torch import units
    from constant_ph_tpu_torch.engine import EngineConfig
    from constant_ph_tpu_torch.ops.pme import make_pme_params
    from constant_ph_tpu_torch.systems.water import solvated_acid
    from constant_ph_tpu_torch.tiled.engine import TiledEngine
    from constant_ph_tpu_torch.tiled.layout import (
        retile, split_system, to_tiled)

    t0 = time.perf_counter()
    sys_ = solvated_acid(n_side=n_side, rigid_water=True, lambda_coupled=True,
                         hmr=3.0, pH=5.0, device=dev, **PAIR[kind])
    ts = split_system(sys_, skin=0.8, tile_safety=1.72, device=dev)
    st = to_tiled(ts, sys_.state)
    n_atoms = int(sys_.state.x.shape[0])
    if n_side == 20 and n_atoms != 24001:
        raise RuntimeError(f"expected 24,001 atoms, built {n_atoms}")
    pme = None
    if kind == "pme":
        pme = make_pme_params(sys_.state.box.cpu().numpy(), ts.params.grid,
                              PAIR[kind]["alpha"], skin=0.8, device=dev,
                              **PME_MESH)
    log(f"[{kind} build] {n_atoms} atoms, grid {ts.params.grid}, W "
        f"{ts.params.W}" + (f", PME mesh {pme.mesh} (m {pme.m}, h {pme.h})"
                            if pme else "")
        + f" in {time.perf_counter() - t0:.1f} s")
    checks = [check_ww(ts, st, f"{kind}-build-tiles", timing=False)]

    # -- the path: counts zeroed just before, read just after --------------
    eq_block, block, n_warm = 8, 12, 2
    zero_counts()
    cfg_eq = EngineConfig(dt=0.5, thermostat="langevin", T=300.0,
                          gamma=0.01, lambda_thermostat="langevin",
                          rebuild_every=eq_block, force_cap=50.0, seed=1)
    eng_eq = TiledEngine(ts, cfg_eq, kspace_ep=pme)
    t0 = time.perf_counter()
    st, e_hist = eng_eq.make_minimize(n_min)(st)
    torch.cuda.synchronize()
    log(f"[{kind} minimize] {n_min} steps: E {float(e_hist[0]):.1f} -> "
        f"{float(e_hist[-1]):.1f} kcal/mol in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    st, ov_eq, obs = eng_eq.make_run(n_eq)(st)
    torch.cuda.synchronize()
    log(f"[{kind} equilibrate] {n_eq} steps: T {float(obs.temp[-1]):.1f} K, "
        f"overflow {bool(ov_eq)} in {time.perf_counter() - t0:.1f} s")
    occ_max = int(st.wvalid.sum(dim=1).max())
    W_prod = -(-(occ_max + 4) // 4) * 4
    ts, st = retile(ts, st, W_prod)
    log(f"[{kind} retile] occ_max {occ_max} -> W {ts.params.W} "
        f"(A = {3 * ts.params.W})")

    cfg = EngineConfig(dt=2.0, thermostat="langevin", T=300.0, gamma=0.002,
                       lambda_thermostat="langevin", rebuild_every=block,
                       kspace_every=2 if pme else 1, seed=2)
    eng = TiledEngine(ts, cfg, kspace_ep=pme)
    run_block = eng.make_run(block)
    for _ in range(n_warm):
        st, ov, obs = run_block(st)
    torch.cuda.synchronize()
    ov_any = torch.zeros((), dtype=torch.bool, device=st.wx.device)
    rows = []
    # the run loop must never wait for the device: any synchronising
    # call (.item(), a pageable host copy, ...) inside a block raises here
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    for _ in range(n_meas):
        st, ov, obs = run_block(st)
        ov_any = ov_any | ov
        rows.append(obs)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    # -------------------------------------------------------------------

    n_steps = n_meas * block
    ms_step = wall / n_steps * 1e3
    ns_day = cfg.dt / units.FS_PER_NS * 86400.0 / (ms_step * 1e-3)
    temp = torch.cat([o.temp for o in rows])
    lam = torch.cat([o.lam for o in rows])
    h = torch.cat([o.h_conserved for o in rows])
    e_k = torch.cat([o.e_kspace.reshape(-1) for o in rows])
    h_valid = torch.cat([o.h_valid.reshape(-1) for o in rows])
    result = dict(
        ms_per_step=ms_step, ns_per_day=ns_day, steps=n_steps,
        T_mean=float(temp.mean()), T_min=float(temp.min()),
        T_max=float(temp.max()), lam_final=float(lam[-1, 0]),
        overflow=bool(ov_any | ov_eq), h_conserved_finite=bool(
            torch.isfinite(h).all()), W=ts.params.W,
        kspace_rows=int((e_k != 0).sum()), h_valid_rows=int(h_valid.sum()),
        memory=eng.memory_usage()["total"])
    log(f"[{kind} production] {json.dumps(result)}")
    expected = (-(-n_min // eq_block) * eq_block       # one per FIRE step
                + -(-n_eq // eq_block) * (eq_block + 1)
                + (n_warm + n_meas) * (block + 1))      # block start + steps
    log(f"[{kind} launches] {json.dumps(counts)}, force evaluations "
        f"{expected}")
    if counts != {"ww_pair": expected, "ww_tally": 0}:
        raise RuntimeError(f"the {kind} path did not run every force "
                           "evaluation through the CUDA kernel K1")
    if result["overflow"] or not result["h_conserved_finite"]:
        raise RuntimeError(f"{kind} production overflowed or went non-finite")
    if not 250.0 < result["T_mean"] < 350.0:
        raise RuntimeError(f"{kind} production temperature "
                           f"{result['T_mean']} K")
    # PME on boundary steps only: e_kspace is non-zero exactly on the
    # h_valid rows (every other step at kspace_every 2); none without PME
    want_k = h_valid if pme is not None else torch.zeros_like(h_valid)
    if not torch.equal(e_k != 0, want_k) or (
            pme is not None and result["h_valid_rows"] != n_steps // 2):
        raise RuntimeError(f"{kind}: k-space ran on other steps than the "
                           "MTS boundaries")
    if profile:
        st = profile_block(run_block, st, ms_step, block)
    return dict(ts=ts, st=st, pme=pme, cfg=cfg, counts=counts,
                result=result, checks=checks)


def check_pme_on_cpu(ts, st, pme):
    """The card's pme_recip_tiled against the same call on a CPU copy of
    the production tiles (guards against TF32 and FFT differences), and
    its time on the card."""
    import torch

    from constant_ph_tpu_torch.ops.pme import make_pme_params, pme_recip_tiled

    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise RuntimeError("TF32 is on: PME needs full float32 matmuls")
    p = ts.params
    gx, gy, gz = p.grid
    A = 3 * p.W
    q_pat = torch.as_tensor(
        [ts.water.q_pattern[k % 3] for k in range(A)], dtype=torch.float32)
    vm = torch.repeat_interleave(st.wvalid.cpu(), 3, dim=-1)
    args_cpu = (st.wx.cpu().reshape(3, gx, gy, gz, A),
                (q_pat[None, :] * vm).reshape(gx, gy, gz, A),
                st.sx.cpu(), (ts.solute.q0 * ts.solute.smask).cpu())
    args_gpu = tuple(a.to(st.wx.device) for a in args_cpu)
    pme_cpu = make_pme_params(pme.box.cpu().numpy(), pme.grid, pme.alpha,
                              skin=0.8, device="cpu", **PME_MESH)

    def card():
        return pme_recip_tiled(*args_gpu, pme, need_water_phi=True)

    got = card()
    ref = pme_recip_tiled(*args_cpu, pme_cpu, need_water_phi=True)
    torch.cuda.synchronize()
    res = dict(e=float(got[0]), e_cpu=float(ref[0]),
               e_rel_err=abs(float(got[0]) - float(ref[0]))
               / abs(float(ref[0])))
    for name, g, r in zip(("fw", "fs", "phi_s", "phi_w"), got[1:], ref[1:]):
        d = float(torch.abs(g.cpu() - r).max())
        res[f"{name}_scaled_err"] = d / max(1.0, float(torch.abs(r).max()))
    res["ms"] = cuda_ms(card, 20)
    log(f"[pme] card vs CPU {json.dumps(res)}")
    if res["e_rel_err"] > TOL_PME_E_REL or max(
            v for k, v in res.items() if k.endswith("scaled_err")
    ) > TOL_PME_SCALED:
        raise RuntimeError(f"PME on the card disagrees with the CPU ({res})")
    return res


def tally_path(ts, st, pme, cfg, n_blocks=4):
    """The PME production tiles through TiledEngine(use_pallas_ww=True):
    sync-free blocks with K2 on every force evaluation (counts zeroed just
    before, read just after), then the compute_Hs sum rule and K2 against
    K1 through compute_forces."""
    import torch

    from constant_ph_tpu_torch.tiled.engine import TiledEngine

    eng_t = TiledEngine(ts, cfg, kspace_ep=pme, use_pallas_ww=True)
    run_block = eng_t.make_run(cfg.rebuild_every)
    zero_counts()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    rows, ov_any = [], None
    for _ in range(n_blocks):
        st, ov, obs = run_block(st)
        ov_any = ov if ov_any is None else ov_any | ov
        rows.append(obs)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    expected = n_blocks * (cfg.rebuild_every + 1)
    temp = torch.cat([o.temp for o in rows])
    res = dict(ms_per_step=wall / (n_blocks * cfg.rebuild_every) * 1e3,
               T_mean=float(temp.mean()), overflow=bool(ov_any),
               finite=bool(torch.isfinite(
                   torch.cat([o.h_conserved for o in rows])).all()))
    log(f"[tally production] {json.dumps(res)}")
    log(f"[tally launches] {json.dumps(counts)}, force evaluations "
        f"{expected}")
    if counts != {"ww_pair": 0, "ww_tally": expected}:
        raise RuntimeError("the tally path did not run every force "
                           "evaluation through the CUDA kernel K2")
    if res["overflow"] or not res["finite"] or not (
            250.0 < res["T_mean"] < 350.0):
        raise RuntimeError(f"tally path run failed its checks ({res})")

    # compute_Hs: the per-atom tallies add up to the energy
    frc = eng_t.compute_forces(st, need_tally=True)
    HA, HB = eng_t.compute_Hs(st, frc)
    want = float(frc.e_lj + frc.e_coul + frc.e_bonded + frc.e_kspace
                 - eng_t.e_corr)
    hs = dict(HA=float(HA), HB=float(HB), e_sum=want,
              rel_err=abs(float(HA) - want) / abs(want))
    # K2 against K1 through compute_forces on the same state
    f2 = eng_t.compute_forces(st)
    f1 = TiledEngine(ts, cfg, kspace_ep=pme).compute_forces(st)
    for name in ("e_lj", "e_coul", "e_pot"):
        a, b = float(getattr(f2, name)), float(getattr(f1, name))
        hs[f"{name}_rel_k2_k1"] = abs(a - b) / abs(b)
    scale = max(float(torch.abs(f1.fw).max()), float(torch.abs(f1.fs).max()))
    hs["f_scaled_k2_k1"] = max(float(torch.abs(f2.fw - f1.fw).max()),
                               float(torch.abs(f2.fs - f1.fs).max())) / scale
    log(f"[tally compute_Hs] {json.dumps(hs)}")
    if hs["rel_err"] > 1e-3:
        raise RuntimeError(f"compute_Hs sum rule fails ({hs})")
    if (max(hs[f"{n}_rel_k2_k1"] for n in ("e_lj", "e_coul", "e_pot"))
            > TOL_K2_K1_E_REL or hs["f_scaled_k2_k1"] > TOL_K2_K1_F_SCALED):
        raise RuntimeError(f"K2 and K1 paths disagree ({hs})")
    return st, counts, res, hs


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs a GPU",
              file=sys.stderr)
        return 1
    import constant_ph_tpu_torch  # noqa: F401  (fails outside the repo)

    dev = "cuda"
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    kernel_phase(dev)
    # the DSF path keeps the bench's relaxation (shorter ones leave the
    # box above 400 K) and measures half the blocks
    dsf = md_path(dev, "dsf", n_meas=10)
    dsf["checks"].append(check_ww(dsf["ts"], dsf["st"], "dsf-production-tiles"))
    pme = md_path(dev, "pme", profile="--profile" in sys.argv[1:])
    ts, st = pme["ts"], pme["st"]
    check_pme_on_cpu(ts, st, pme["pme"])
    st, t_counts, _, _ = tally_path(ts, st, pme["pme"], pme["cfg"])
    k1 = check_ww(ts, st, "pme-production-tiles")
    k2 = check_tally(ts, st, "pme-production-tiles")
    k1_errs = [c["f_abs_err"] for c in dsf["checks"] + pme["checks"] + [k1]]
    kernels = [
        dict(name="ww_pair", route="cuda",
             source="constant_ph_tpu_torch/csrc/ww_pair.cu",
             replaces="constant_ph_tpu/tiled/pallas_ww.py:240",
             launches=pme["counts"]["ww_pair"],
             max_abs_err=max(k1_errs),                   # kcal/mol/Å
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None),
        dict(name="ww_tally", route="cuda",
             source="constant_ph_tpu_torch/csrc/ww_tally.cu",
             replaces="constant_ph_tpu/tiled/pallas_ww.py:88",
             launches=t_counts["ww_tally"],
             max_abs_err=max(k2["f_abs_err"], k2["phi_abs_err"]),
             ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None)]
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(gpu_name_and_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
