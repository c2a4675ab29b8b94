#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (constant_ph_tpu_torch).

    python3 chip_smoke.py [--profile]

Run from the root of the repository on a machine with one NVIDIA GPU
(Hopper, sm_90a) and nvcc. It fails, printing no result, when CUDA is not
available or the port's package is not beside it.

1. Kernel phase: builds csrc/ww_pair.cu with nvcc and holds the CUDA
   water-water kernel against its plain PyTorch version
   (tiled.forces.water_water_fast_plain) on the card: on a small dilute
   box in both Coulomb styles, and on the 24,001-atom system's tiles.
2. Main path: the DSF slice through the port's entry points at the
   bench size — solvated_acid(n_side=20, DSF rc=8 Å, α=0.2, HMR 3, pH 5)
   → split_system(skin=0.8, tile_safety=1.72) → to_tiled on the GPU →
   make_minimize → a Langevin equilibration → retile to the measured
   occupancy → timed Langevin production blocks (dt 2 fs, λ Langevin,
   rebuild_every 12). The kernel's launch counter is zeroed just before
   and read just after, and must equal the number of force evaluations.
3. The kernel against its plain version again at the production tiles,
   with its time, the plain version's time and its bound.

``--profile`` adds one production block under torch.profiler (device busy
time by kernel and the device's idle share).

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
# agreement of kernel and plain version, both float32 sums taken in
# different orders (the kernel's full stencil vs the plain half stencil):
# energies within rtol 1e-5 plus atol 1e-4 kcal/mol (the tolerance
# tests/test_pallas_ww.py holds the JAX package's two water-water paths
# to; the atol covers totals that are small differences of large ± terms),
# forces scaled by max(1, |f|max) within 1e-5
TOL_E_REL = 1e-5
TOL_E_ABS = 1e-4
TOL_F_SCALED = 1e-5


def log(msg):
    print(msg, flush=True)


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def ww_bound_ms(G, A):
    """Least time for one water-water evaluation: the larger of the bytes
    it must move (wx in, f out) over HBM bandwidth and its FP32 work over
    the FP32 peak. Work counts each unordered pair once, as the function
    needs: 13 neighbour tiles of A×A pairs plus half the self tile."""
    nbytes = 2 * 3 * G * A * 4 + 3 * 4 + 2 * 4
    pairs = G * A * A * 13.5
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = pairs * FLOPS_PER_PAIR / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


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
    e_ok = all(abs(float(got[i]) - float(ref[i]))
               <= TOL_E_ABS + TOL_E_REL * abs(float(ref[i])) for i in (0, 1))
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
    log(f"[kernel] {json.dumps(res)}")
    if not e_ok or f_abs / scale > TOL_F_SCALED:
        raise RuntimeError(f"{label}: CUDA kernel disagrees with its plain "
                           f"version (energy rel {e_rel:.3g}, force scaled "
                           f"{f_abs / scale:.3g})")
    return res


def kernel_phase(dev):
    """Build the kernel, then check it on a small dilute box (both Coulomb
    styles)."""
    from constant_ph_tpu_torch.systems.water import solvated_acid
    from constant_ph_tpu_torch.tiled import cuda_ww
    from constant_ph_tpu_torch.tiled.layout import split_system, to_tiled

    t0 = time.perf_counter()
    path, msgs = cuda_ww.build()
    log(f"[build] {os.path.relpath(path)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in msgs.splitlines():
        if "ptxas" in line:
            log(f"[build] {line.strip()}")
    for style, alpha in (("dsf", 0.2), ("cut", 0.35)):
        sys_ = solvated_acid(n_side=8, spacing=6.4, cutoff=8.0, seed=12,
                             coul_style=style, alpha=alpha, device=dev)
        ts = split_system(sys_, skin=2.0, tile_safety=0.2, device=dev)
        check_ww(ts, to_tiled(ts, sys_.state), f"dilute-{style}",
                 timing=False)


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


def main_path(dev, n_side=20, n_min=400, n_eq=800, n_meas=20,
              profile=False):
    """The DSF main path at the bench size (smaller sizes only serve a
    rehearsal on the CPU with the plain version counted as the kernel).
    With ``profile``, one more production block runs under torch.profiler
    after the launch count is read."""
    import torch

    from constant_ph_tpu_torch import units
    from constant_ph_tpu_torch.engine import EngineConfig
    from constant_ph_tpu_torch.systems.water import solvated_acid
    from constant_ph_tpu_torch.tiled import cuda_ww
    from constant_ph_tpu_torch.tiled.engine import TiledEngine
    from constant_ph_tpu_torch.tiled.layout import (
        retile, split_system, to_tiled)

    t0 = time.perf_counter()
    sys_ = solvated_acid(n_side=n_side, rigid_water=True, lambda_coupled=True,
                         cutoff=8.0, coul_style="dsf", alpha=0.2, hmr=3.0,
                         pH=5.0, device=dev)
    ts = split_system(sys_, skin=0.8, tile_safety=1.72, device=dev)
    st = to_tiled(ts, sys_.state)
    n_atoms = int(sys_.state.x.shape[0])
    if n_side == 20 and n_atoms != 24001:
        raise RuntimeError(f"expected 24,001 atoms, built {n_atoms}")
    log(f"[build] {n_atoms} atoms, grid {ts.params.grid}, W {ts.params.W} "
        f"in {time.perf_counter() - t0:.1f} s")
    checks = [check_ww(ts, st, "build-tiles")]

    # -- the main path: counts zeroed just before, read just after --------
    eq_block, block, n_warm = 8, 12, 2
    cuda_ww.water_water_cuda.launches = 0
    cfg_eq = EngineConfig(dt=0.5, thermostat="langevin", T=300.0,
                          gamma=0.01, lambda_thermostat="langevin",
                          rebuild_every=eq_block, force_cap=50.0, seed=1)
    eng_eq = TiledEngine(ts, cfg_eq)
    t0 = time.perf_counter()
    st, e_hist = eng_eq.make_minimize(n_min)(st)
    torch.cuda.synchronize()
    log(f"[minimize] {n_min} steps: E {float(e_hist[0]):.1f} -> "
        f"{float(e_hist[-1]):.1f} kcal/mol in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    st, ov_eq, obs = eng_eq.make_run(n_eq)(st)
    torch.cuda.synchronize()
    log(f"[equilibrate] {n_eq} steps: T {float(obs.temp[-1]):.1f} K, "
        f"overflow {bool(ov_eq)} in {time.perf_counter() - t0:.1f} s")
    occ_max = int(st.wvalid.sum(dim=1).max())
    W_prod = -(-(occ_max + 4) // 4) * 4
    ts, st = retile(ts, st, W_prod)
    log(f"[retile] occ_max {occ_max} -> W {ts.params.W} "
        f"(A = {3 * ts.params.W})")

    cfg = EngineConfig(dt=2.0, thermostat="langevin", T=300.0, gamma=0.002,
                       lambda_thermostat="langevin", rebuild_every=block,
                       seed=2)
    eng = TiledEngine(ts, cfg)
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
    launches = cuda_ww.water_water_cuda.launches
    # -------------------------------------------------------------------

    n_steps = n_meas * block
    ms_step = wall / n_steps * 1e3
    ns_day = cfg.dt / units.FS_PER_NS * 86400.0 / (ms_step * 1e-3)
    temp = torch.cat([o.temp for o in rows])
    lam = torch.cat([o.lam for o in rows])
    h = torch.cat([o.h_conserved for o in rows])
    result = dict(
        ms_per_step=ms_step, ns_per_day=ns_day, steps=n_steps,
        T_mean=float(temp.mean()), T_min=float(temp.min()),
        T_max=float(temp.max()), lam_final=float(lam[-1, 0]),
        overflow=bool(ov_any | ov_eq), h_conserved_finite=bool(
            torch.isfinite(h).all()), W=ts.params.W,
        memory=eng.memory_usage()["total"])
    log(f"[production] {json.dumps(result)}")
    expected = (n_min                                   # one per FIRE step
                + -(-n_eq // eq_block) * (eq_block + 1)
                + (n_warm + n_meas) * (block + 1))      # block start + steps
    log(f"[launches] ww_pair {launches}, force evaluations {expected}")
    if launches != expected:
        raise RuntimeError("the main path did not run every force "
                           "evaluation through the CUDA kernel")
    if result["overflow"] or not result["h_conserved_finite"]:
        raise RuntimeError("production run overflowed or went non-finite")
    if not 250.0 < result["T_mean"] < 350.0:
        raise RuntimeError(f"production temperature {result['T_mean']} K")
    if profile:
        st = profile_block(run_block, st, ms_step, block)
    checks.append(check_ww(ts, st, "production-tiles"))
    return launches, checks


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
    launches, checks = main_path(dev, profile="--profile" in sys.argv[1:])
    prod = checks[-1]
    kernels = [dict(
        name="ww_pair", route="cuda",
        source="constant_ph_tpu_torch/csrc/ww_pair.cu",
        replaces="constant_ph_tpu/tiled/pallas_ww.py:240",
        launches=launches,
        max_abs_err=max(c["f_abs_err"] for c in checks),   # kcal/mol/Å
        ms=prod["ms"], plain_ms=prod["plain_ms"], bound_ms=prod["bound_ms"],
        bound_by=prod["bound_by"], library_ms=None)]
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(gpu_name_and_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
