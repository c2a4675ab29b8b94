#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (constant_ph_tpu_torch).

    python3 chip_smoke.py [--profile]

Run from the root of the repository on a machine with one NVIDIA GPU
(Hopper, sm_90a) and nvcc. It fails, printing no result, when CUDA is not
available or the port's package is not beside it.

1. Kernel phase: builds csrc/ww_pair.cu (K1) and csrc/ww_tally.cu (K2),
   one nvcc each, started together, and holds each CUDA kernel against its
   plain PyTorch version (tiled.forces.water_water_fast_plain,
   water_water_tally_plain) on a small dilute box in both Coulomb styles,
   and both on the hard tile set of tiled/hard_tiles.py (stretched
   molecules, every box face straddled, pairs at rc ± 0.005 Å, a full and
   a parked cell; K2's tiles packed with their own validity) in DSF α
   0.2, 'cut' α 0.30 and unscreened 'cut'. Every check of either kernel
   launches it twice and requires bitwise-equal outputs; every K2 check
   also requires that K2 evaluated at least twice the atom pairs inside
   rc (each is computed from both of its atoms).
2. DSF path (the ``entry()`` configuration): solvated_acid (n_side=20,
   DSF rc=8 Å, α=0.2, HMR 3, pH 5) → split_system(skin=0.8,
   tile_safety=1.72) → 400 FIRE steps → 800 Langevin equilibration steps
   → retile to the measured occupancy → 2 warm-up and 5 measured
   sync-free production blocks (dt 2 fs, λ Langevin, rebuild_every 12).
3. PME main path (the ``bench.py`` default) at the same 24,001 atoms:
   'cut' Coulomb α=0.30 rc=8 Å, PME mesh spacing 1.5, p=6 (48³);
   400 FIRE + 800 equilibration steps at kspace_every=1, retile, then 2
   warm-up and 10 measured 12-step production blocks at kspace_every=2
   (impulse MTS), sync-free. PME must run on boundary steps only, and the
   card's pme_recip_tiled is held against the same call on the CPU.
4. Tally path on the PME production tiles: blocks with
   TiledEngine(use_pallas_ww=True) (K2 on every force evaluation), the
   compute_Hs sum rule, K2 against K1 through compute_forces, and the
   float64 breakdown of their force difference (each kernel against its
   plain version run in float64, and the two float64 plain versions
   against each other).
5. Campaign phase: the λ-metadynamics titration campaign of
   examples/titration_metad_multisite.py at its full width
   (solvated_polypeptide, 27,300 atoms, 20 sites, 8 buffer waters a site,
   DSF α 0.2, rc 8 Å; grid 6³, W 80 at build, 600 solute atoms) at cut
   depth: 400 FIRE + 800 Langevin steps, retile to occupancy + 12, TI
   calibration at site 0 (7 nodes × (12 + 24) steps, finite), ΔG_ref
   −39.37 installed, then 3 pH rungs × 2 walkers with MetadParams(nbins
   241, σ 0.05, h0 0.4, γ 30, stride 48): (a) 2 chunks of 48 steps against
   a frozen bias with each rung's hills merged by deposit_many, (b) a
   48-step chunk with in-run deposits on a walker per rung, (c) one
   replica-exchange block with a swap, (d) a poisoned replica flagged by
   replica_healthy and rolled back bit for bit, (e) the estimators. Gates:
   K1 launches equal force evaluations, every hill landed (table mass),
   same-rung tables equal, ext_work moved by ΣΔV, the pH multiset kept, no
   overflow, finite h_conserved, T in 250–350 K, fractions in [0, 1], and
   no synchronisation inside the run blocks. Measured: ms per
   walker-step, K1 on the campaign tiles (time, bound, pairs), the
   water×solute and solute×solute blocks at Ns 600 (time, memory), and
   one campaign block under torch.profiler.

Every path zeroes the kernels' launch counters just before it runs and
reads them just after; each kernel of a path must have launched once per
force evaluation. The kernels are timed (device time, from a CUDA graph
of 50 calls) against their plain versions and their bounds at the PME
production tiles, and again with those tiles retiled to W 56 (A 168).
Each kernel's bound counts the atom pairs those tiles need
(tiled.forces.water_pairs_in_cutoff for K1,
water_pairs_in_cutoff_tally for K2); the whole-stencil figure is printed
beside it as stencil_bound_ms.

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
# ninth of the pairs (the LJ masks zero it on the others); the DSF
# shifts add 6
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
# version both sum the full stencil from the i side, in other orders
# (measured ≤ 1.6e-6 of max)
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


def ww_bound_ms(G, A, pairs):
    """Least time for one water-water evaluation: the larger of the bytes
    it must move (wx in, f out) over HBM bandwidth and its FP32 work over
    the FP32 peak. Work counts the pairs these tiles need: each unordered
    atom pair inside rc once (tiled.forces.water_pairs_in_cutoff)."""
    return _bound(2 * 3 * G * A * 4 + 3 * 4 + 2 * 4, pairs * FLOPS_PER_PAIR)


def ww_stencil_bound_ms(G, A):
    """The same with the work of the whole half stencil, 13 neighbour
    tiles of A×A pairs plus half the self tile, in or out of the cutoff
    (the bound of the first two slices, kept for comparison)."""
    return _bound(2 * 3 * G * A * 4 + 3 * 4 + 2 * 4,
                  G * A * A * 13.5 * FLOPS_PER_PAIR)[0]


def _tally_bytes(G, A):
    # the 6 used rows of the packed tiles in, the 6 computed output rows
    # out (the last two rows of each are padding), and the box
    return 2 * 6 * G * A * 4 + 3 * 4


def tally_bound_ms(G, A, style, pairs):
    """The same for the full-tally kernel: each unordered atom pair
    inside rc once at its FLOP count
    (tiled.forces.water_pairs_in_cutoff_tally)."""
    return _bound(_tally_bytes(G, A), pairs * FLOPS_PER_PAIR_TALLY[style])


def tally_stencil_bound_ms(G, A, style):
    """The same with the work of the whole stencil, G·A²·13.5 unordered
    pairs in or out of the cutoff (the bound of a kernel without a cull,
    kept for comparison)."""
    return _bound(_tally_bytes(G, A),
                  G * A * A * 13.5 * FLOPS_PER_PAIR_TALLY[style])[0]


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


def graph_ms(fn, n):
    """Device time of one call of fn: n calls captured in one CUDA graph
    and the graph replayed between two events, so the host's time to
    launch each call (the Python wrapper) is not counted."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


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
    """K1 against its plain version on a TiledSystem's tiles."""
    p = ts.params
    return check_ww_tiles(st.wx.reshape((3,) + p.grid + (3 * p.W,)),
                          ts.water, p, st.box, label, style=ts.coul_style,
                          alpha=ts.alpha, rc=ts.cutoff, timing=timing)


def check_ww_tiles(wxg, wm, p, box, label, *, style, alpha, rc,
                   timing=False):
    """K1 against its plain version on one tile set: energies and forces
    within the bars, and two launches bitwise equal. With ``timing``, the
    kernel's and the plain version's times, the pairs these tiles need and
    the bounds. Returns the numbers."""
    import torch

    from constant_ph_tpu_torch.tiled import cuda_ww, forces

    kw = dict(style=style, alpha=alpha, rc=rc)

    def kernel():
        return forces.water_water_fast(wxg, wm, p, box, **kw)

    def plain():
        return forces.water_water_fast_plain(wxg, wm, p, box, **kw)

    got = kernel()
    evaluated = int(cuda_ww.water_water_cuda.pairs_evaluated)
    again = kernel()
    ref = plain()
    torch.cuda.synchronize()
    for t in (*got, *ref):
        if not torch.isfinite(t).all():
            raise RuntimeError(f"{label}: non-finite water-water output")
    if got[2].shape != wxg.shape:
        raise RuntimeError(f"{label}: force shape {tuple(got[2].shape)}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise RuntimeError(f"{label}: two launches of K1 differ")
    e_rel = max(abs(float(got[i]) - float(ref[i]))
                / max(abs(float(ref[i])), 1e-30) for i in (0, 1))
    e_ok = all(e_close(float(got[i]), float(ref[i])) for i in (0, 1))
    scale = max(1.0, float(torch.abs(ref[2]).max()))
    f_abs = float(torch.abs(got[2] - ref[2]).max())
    G, A = p.G, 3 * p.W
    res = dict(label=label, G=G, A=A, style=style, alpha=alpha,
               e_lj=float(got[0]), e_lj_plain=float(ref[0]),
               e_coul=float(got[1]), e_coul_plain=float(ref[1]),
               e_rel_err=e_rel, f_abs_err=f_abs, f_scaled_err=f_abs / scale,
               bitwise_repeat=True, pairs_evaluated=evaluated)
    if timing:
        needed = int(forces.water_pairs_in_cutoff(wxg, p, box, rc))
        res["ms"] = graph_ms(kernel, 50)
        res["plain_ms"] = cuda_ms(plain, 5)
        res["pairs_needed"] = needed
        res["bound_ms"], res["bound_by"] = ww_bound_ms(G, A, needed)
        res["stencil_bound_ms"] = ww_stencil_bound_ms(G, A)
    log(f"[kernel] ww_pair {json.dumps(res)}")
    if not e_ok or f_abs / scale > TOL_F_SCALED_K1:
        raise RuntimeError(f"{label}: CUDA kernel disagrees with its plain "
                           f"version (energy rel {e_rel:.3g}, force scaled "
                           f"{f_abs / scale:.3g})")
    return res


def check_tally(ts, st, label, timing=True):
    """K2 against its plain version on a TiledSystem's tiles."""
    from constant_ph_tpu_torch.tiled import forces

    p = ts.params
    gx, gy, gz = p.grid
    wt = forces.pack_water_tiles(st.wx.reshape(3, gx, gy, gz, 3 * p.W),
                                 st.wvalid.reshape(gx, gy, gz, p.W),
                                 ts.water, p)
    return check_tally_tiles(wt, st.box, ts.water, p, label,
                             style=ts.coul_style, alpha=ts.alpha,
                             rc=ts.cutoff, timing=timing)


def check_tally_tiles(wt, box, wm, p, label, *, style, alpha, rc,
                      timing=False):
    """K2 against its plain version on one set of packed tiles: energies
    (sums of the eatom rows) within the bars, forces, eatom and φ within
    TOL_F_SCALED of their max, zero padding rows, two launches bitwise
    equal, and at least twice the atom pairs inside rc evaluated. With
    ``timing``, the kernel's and the plain version's times and the
    bounds. Returns the numbers."""
    import torch

    from constant_ph_tpu_torch.tiled import cuda_ww, forces

    kw = dict(style=style, alpha=alpha, rc=rc)

    def kernel():
        return cuda_ww.water_water_tally_cuda(wt, box, wm, p, **kw)

    def plain():
        return forces.water_water_tally_plain(wt, box, wm, p, **kw)

    got = kernel()
    evaluated = int(cuda_ww.water_water_tally_cuda.pairs_evaluated)
    again = kernel()
    ref = plain()
    needed = int(forces.water_pairs_in_cutoff_tally(wt, box, p, rc))
    torch.cuda.synchronize()
    if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        raise RuntimeError(f"{label}: non-finite full-tally output")
    if got.shape != wt.shape or got[..., 6:, :].any():
        raise RuntimeError(f"{label}: bad full-tally output layout")
    if not torch.equal(got, again):
        raise RuntimeError(f"{label}: two launches of K2 differ")
    e = [float(torch.sum(got[..., r, :])) for r in (3, 4)]
    e_ref = [float(torch.sum(ref[..., r, :])) for r in (3, 4)]
    e_rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(e, e_ref))
    errs = {}
    for name, rows in (("f", slice(0, 3)), ("eatom", slice(3, 5)),
                       ("phi", slice(5, 6))):
        d = float(torch.abs(got[..., rows, :] - ref[..., rows, :]).max())
        errs[name] = (d, d / max(1.0, float(torch.abs(ref[..., rows, :])
                                            .max())))
    G, A = p.G, 3 * p.W
    res = dict(label=label, G=G, A=A, style=style, alpha=alpha,
               e_lj=e[0], e_lj_plain=e_ref[0], e_coul=e[1],
               e_coul_plain=e_ref[1], e_rel_err=e_rel,
               f_abs_err=errs["f"][0], f_scaled_err=errs["f"][1],
               phi_abs_err=errs["phi"][0], phi_scaled_err=errs["phi"][1],
               eatom_scaled_err=errs["eatom"][1], bitwise_repeat=True,
               pairs_needed=needed, pairs_evaluated=evaluated)
    if timing:
        res["ms"] = graph_ms(kernel, 50)
        res["plain_ms"] = cuda_ms(plain, 5)
        res["bound_ms"], res["bound_by"] = tally_bound_ms(G, A, style,
                                                          needed)
        res["stencil_bound_ms"] = tally_stencil_bound_ms(G, A, style)
    log(f"[kernel] ww_tally {json.dumps(res)}")
    if (not all(e_close(a, b) for a, b in zip(e, e_ref))
            or max(v[1] for v in errs.values()) > TOL_F_SCALED):
        raise RuntimeError(f"{label}: CUDA full-tally kernel disagrees with "
                           f"its plain version ({res})")
    # every pair inside rc is evaluated from both of its atoms
    if evaluated < 2 * needed:
        raise RuntimeError(f"{label}: K2 evaluated {evaluated} atom pairs, "
                           f"fewer than twice the {needed} inside rc")
    return res


def kernel_phase(dev):
    """Build the kernels, then check each on a small dilute box (both
    Coulomb styles) and on the hard tile set (tiled/hard_tiles.py)."""
    import torch

    from constant_ph_tpu_torch.systems.water import solvated_acid
    from constant_ph_tpu_torch.tiled import cuda_ww, forces
    from constant_ph_tpu_torch.tiled.hard_tiles import (
        COULOMB, hard_water_tiles)
    from constant_ph_tpu_torch.tiled.layout import (
        TileParams, WaterModel, split_system, to_tiled)

    t0 = time.perf_counter()
    built = cuda_ww.build()
    log(f"[build] {', '.join(os.path.relpath(v[0]) for v in built.values())}"
        f" in {time.perf_counter() - t0:.1f} s (one nvcc per source, "
        "in parallel)")
    for name, (_, msgs) in built.items():
        for line in msgs.splitlines():
            if "ptxas" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    for style, alpha in (("dsf", 0.2), ("cut", 0.35)):
        sys_ = solvated_acid(n_side=8, spacing=6.4, cutoff=8.0, seed=12,
                             coul_style=style, alpha=alpha, device=dev)
        ts = split_system(sys_, skin=2.0, tile_safety=0.2, device=dev)
        st = to_tiled(ts, sys_.state)
        check_ww(ts, st, f"dilute-{style}", timing=False)
        check_tally(ts, st, f"dilute-{style}", timing=False)
    hard = hard_water_tiles()
    p = TileParams(**hard["params"])
    wxg = torch.as_tensor(hard["wx"], device=dev).reshape(
        (3,) + p.grid + (3 * p.W,))
    box = torch.as_tensor(hard["box"], device=dev)
    wm = WaterModel(**hard["water"])
    # K2's tiles carry the hard tiles' own validity (0 on parked slots)
    wt = forces.pack_water_tiles(
        wxg, torch.as_tensor(hard["wvalid"], device=dev).reshape(
            p.grid + (p.W,)), wm, p)
    for style, alpha in COULOMB:
        label = f"hard-{style}-{alpha}"
        check_ww_tiles(wxg, wm, p, box, label, style=style, alpha=alpha,
                       rc=p.cutoff)
        check_tally_tiles(wt, box, wm, p, label, style=style, alpha=alpha,
                          rc=p.cutoff)


def profile_block(run_block, st, ms_step, block, label="profile"):
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
    log(f"[{label}] device busy {busy_ms:.3f} ms/step of {ms_step:.3f}: "
        f"idle share {1.0 - busy_ms / ms_step:.4f}; "
        f"{sum(r[1] for r in rows) / block:.0f} device ops/step")
    # the top rows, and the port's own kernels wherever they rank
    for i, (us, n, key) in enumerate(rows):
        if i < 12 or any(k in key for k in ("ww_pair", "ww_tally",
                                            "energy_sum")):
            log(f"[{label}] {us / 1e3 / block:9.4f} ms/step "
                f"{n / block:6.1f}/step {key[:90]}")
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
    before, read just after), then the compute_Hs sum rule, K2 against
    K1 through compute_forces, and which of them carries the difference
    (each kernel against its plain version in float64, and the float64
    plain versions against each other)."""
    import torch

    from constant_ph_tpu_torch.tiled import cuda_ww, forces
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
    # the water-water forces alone, on the same state and scale: each
    # kernel against its plain version run in float64, and the two
    # float64 plain versions against each other (the A–S erfc against
    # the Chebyshev fit, a difference of the functions themselves)
    p = ts.params
    gx, gy, gz = p.grid
    kw = dict(style=ts.coul_style, alpha=ts.alpha, rc=ts.cutoff)
    wxg = st.wx.reshape(3, gx, gy, gz, 3 * p.W)
    wt = forces.pack_water_tiles(wxg, st.wvalid.reshape(gx, gy, gz, p.W),
                                 ts.water, p)
    box64 = st.box.double()

    def tally_f(out):
        return torch.movedim(out[..., :3, :], -2, 0).double()

    k2 = tally_f(cuda_ww.water_water_tally_cuda(wt, st.box, ts.water, p,
                                                **kw))
    k2_64 = tally_f(forces.water_water_tally_plain(wt.double(), box64,
                                                   ts.water, p, **kw))
    k1 = cuda_ww.water_water_cuda(wxg, ts.water, p, st.box, **kw)[2].double()
    k1_64 = forces.water_water_fast_plain(wxg.double(), ts.water, p, box64,
                                          **kw)[2]
    f64 = {name: float(torch.abs(a - b).max()) / scale for name, a, b in (
        ("k2_vs_plain64", k2, k2_64), ("k1_vs_plain64", k1, k1_64),
        ("plain64_k2_vs_k1", k2_64, k1_64), ("k2_vs_k1", k2, k1))}
    hs["ww_f_scaled"] = f64
    log(f"[tally float64] water-water forces / max|f| {json.dumps(f64)}")
    if hs["rel_err"] > 1e-3:
        raise RuntimeError(f"compute_Hs sum rule fails ({hs})")
    if (max(hs[f"{n}_rel_k2_k1"] for n in ("e_lj", "e_coul", "e_pot"))
            > TOL_K2_K1_E_REL or hs["f_scaled_k2_k1"] > TOL_K2_K1_F_SCALED):
        raise RuntimeError(f"K2 and K1 paths disagree ({hs})")
    return st, counts, res, hs


# the production campaign of examples/titration_metad_multisite.py: its
# build and split (:203-213), the hill protocol and ΔG_ref the committed
# r5s3 checkpoint ran at, its pH rungs cut to 3 with 2 walkers each
CAMPAIGN_BUILD = dict(n_residues=40, sites_every=2, box_len=66.0,
                      water_spacing=3.1, cutoff=8.0, skin=0.8,
                      coul_style="dsf", alpha=0.2, pH=5.0, dq_scale=1.0,
                      n_buffer_waters=8)
CAMPAIGN_SPLIT = dict(skin=0.8, tile_safety=1.72)
CAMPAIGN_SHAPE = dict(atoms=27300, sites=20, grid=[6, 6, 6], W=80, Ns=600)
CAMPAIGN_METAD = dict(nbins=241, sigma=0.05, h0=0.4, gamma=30.0, stride=48,
                      T=300.0)
CAMPAIGN_DG_REF = -39.37
CAMPAIGN_PHS = (3.0, 5.0, 7.0)
CAMPAIGN_WPP = 2
# steps a chunk (one hill a walker at stride 48) and the TI depth a node
# (equilibration, sampling)
CAMPAIGN_CHUNK = 48
CAMPAIGN_TI = (12, 24)


def _hill_mass(lam, mp):
    """Σ over hills of h0·Σ_grid exp(−(λ_grid − λ)²/2σ²)·dx per site (the
    table mass each hill would add at full height), float64 on the
    host. lam: (K, S)."""
    import numpy as np

    grid = mp.grid().double().numpy()
    x = grid[None, None, :] - lam.double().cpu().numpy()[:, :, None]
    return mp.h0 * np.exp(-x * x / (2 * mp.sigma ** 2)).sum(axis=(0, 2)) \
        * mp.dx


def _table_mass(V, mp):
    return V.double().sum(dim=-1).cpu().numpy() * mp.dx


def campaign_path(dev, build=CAMPAIGN_BUILD, shape=CAMPAIGN_SHAPE, n_min=400,
                  n_eq=800):
    """The λ-metadynamics titration campaign through the port's entry
    points, at the production campaign's width and a cut depth: build →
    relax → retile (occupancy + 12) → TI calibration at site 0 (7 nodes,
    small depth) → ΔG_ref −39.37 installed → (a) 3 pH rungs × 2 walkers
    against a frozen bias, 2 chunks, each rung's hills merged with
    deposit_many; (b) one chunk with in-run deposits on a walker per rung;
    (c) one replica-exchange block; (d) a poisoned replica flagged and
    rolled back; (e) the estimators. Counts are zeroed just before the
    path and read just after; the run blocks never synchronise. The
    relaxation is the DSF and PME paths' (a 200 + 96-step one left the
    production box above the T gate). Smaller ``build`` / depths only
    serve a rehearsal on the CPU. Returns the numbers."""
    import dataclasses
    import math

    import numpy as np
    import torch

    from constant_ph_tpu_torch import metad, titration
    from constant_ph_tpu_torch.engine import EngineConfig
    from constant_ph_tpu_torch.lambda_dyn import BiasParams
    from constant_ph_tpu_torch.parallel import replica
    from constant_ph_tpu_torch.systems.protein import solvated_polypeptide
    from constant_ph_tpu_torch.tiled import forces
    from constant_ph_tpu_torch.tiled.engine import TiledEngine
    from constant_ph_tpu_torch.tiled.layout import (
        retile, split_system, to_tiled)

    t_phase = t0 = time.perf_counter()
    sys_ = solvated_polypeptide(device=dev, **build)
    ts = split_system(sys_, device=dev, **CAMPAIGN_SPLIT)
    st = to_tiled(ts, sys_.state)
    got = dict(atoms=int(sys_.state.x.shape[0]), sites=ts.spec.n_sites,
               grid=list(ts.params.grid), W=ts.params.W,
               Ns=int(ts.solute.q0.shape[0]))
    log(f"[campaign build] {json.dumps(got)} in "
        f"{time.perf_counter() - t0:.1f} s")
    if shape is not None and got != shape:
        raise RuntimeError(f"campaign build {got}, expected {shape}")
    bias = BiasParams()
    mp = metad.MetadParams(**CAMPAIGN_METAD)
    eq_block, block, chunk, cal = 8, 12, CAMPAIGN_CHUNK, CAMPAIGN_TI
    runs = -(-chunk // block) * (block + 1)     # force evaluations a chunk
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)

    # -- the path: counts zeroed just before, read just after --------------
    zero_counts()
    evals = 0
    cfg_eq = EngineConfig(dt=0.5, thermostat="langevin", T=300.0,
                          gamma=0.01, lambda_thermostat="langevin",
                          rebuild_every=eq_block, force_cap=50.0, seed=21)
    eng_eq = TiledEngine(ts, cfg_eq, bias=bias)
    t0 = time.perf_counter()
    st, e_hist = eng_eq.make_minimize(n_min)(st)
    st, ov_eq, obs_eq = eng_eq.make_run(n_eq)(st)
    evals += (-(-n_min // eq_block) * eq_block
              + -(-n_eq // eq_block) * (eq_block + 1))
    sync()
    occ = int(st.wvalid.sum(dim=1).max())
    ts, st = retile(ts, st, -(-(occ + 12) // 4) * 4)
    log(f"[campaign relax] {n_min} FIRE + {n_eq} Langevin steps: E "
        f"{float(e_hist[0]):.1f} -> {float(e_hist[-1]):.1f} kcal/mol, T "
        f"{float(obs_eq.temp[-1]):.1f} K, occ_max {occ} -> W "
        f"{ts.params.W} in {time.perf_counter() - t0:.1f} s")

    cfg_cal = EngineConfig(dt=1.0, thermostat="langevin", T=300.0,
                           gamma=0.01, lambda_thermostat="langevin",
                           rebuild_every=block, seed=22)
    t0 = time.perf_counter()
    dG_cal, (nodes, means) = titration.calibrate_dG_ref_tiled(
        ts, st, cfg_cal, bias=bias, site=0, equil_steps=cal[0],
        sample_steps=cal[1], return_profile=True)
    evals += len(nodes) * (-(-cal[0] // block) + -(-cal[1] // block)) * (
        block + 1)
    log(f"[campaign calibrate] TI at site 0, {len(nodes)} nodes x "
        f"({cal[0]} + {cal[1]}) steps: dG_ref {dG_cal:.3f} kcal/mol "
        f"(<dU/dlam> {np.round(means, 2).tolist()}) in "
        f"{time.perf_counter() - t0:.1f} s; installing {CAMPAIGN_DG_REF}")
    if not math.isfinite(dG_cal):
        raise RuntimeError("campaign TI calibration is not finite")
    ts.spec = titration.apply_dG_ref(ts.spec, CAMPAIGN_DG_REF)

    # production: titration_metad_multisite.py's config; walkers start in
    # the basin HH
    # favours at their pH, against zeroed tables
    cfg = EngineConfig(dt=2.0, thermostat="langevin", T=300.0, gamma=0.002,
                       lambda_thermostat="langevin", lambda_gamma=0.05,
                       rebuild_every=block, lam_min=-0.12, lam_max=1.12,
                       seed=23)
    eng = TiledEngine(ts, cfg, bias=bias, metad=mp, metad_frozen=True)
    S, G, wpp = ts.spec.n_sites, len(CAMPAIGN_PHS), CAMPAIGN_WPP
    R = G * wpp
    pK = ts.spec.pK
    V0, dV0 = metad.init_tables(S, mp, device=st.lam.device)
    reps, seeds = [], []
    for g, ph in enumerate(CAMPAIGN_PHS):
        lam0 = torch.where(pK > ph, 0.05, 0.95).to(st.lam.dtype)
        for w in range(wpp):
            reps.append(dataclasses.replace(
                st, pH=torch.full_like(st.pH, ph), lam=lam0.clone(),
                v_lam=torch.zeros_like(st.v_lam), metad_v=V0.clone(),
                metad_dv=dV0.clone()))
            seeds.append(2000 + g * 131 + w)
    gens = replica.replica_generators(seeds, st.lam.device)
    batch = replica.stack_replicas(reps)
    run = eng.make_run(chunk)
    # (b)'s engine deposits in the run; (c)'s runner and swap generator
    eng_dep = TiledEngine(ts, cfg, bias=bias, metad=mp)
    run_block = eng_dep.make_run(block)
    rex = replica.make_rex_runner_tiled(eng, block, generators=gens)
    swap_gen = torch.Generator(device=st.lam.device).manual_seed(24)
    rows, ovs, merges = [], [], []
    sync()
    if dev == "cuda":
        torch.cuda.set_sync_debug_mode("error")
    t_prod = time.perf_counter()
    # (a) shared walkers: a chunk against the frozen bias, then each
    # rung's hills (the λ trace at the stride, walkers interleaved
    # time-major) merged into its table with deposit_many
    for _ in range(2):
        outs = [run(s, gen) for s, gen in zip(
            replica.unstack_replicas(batch), gens)]
        evals += R * runs
        batch = replica.stack_replicas([o[0] for o in outs])
        ovs += [o[1] for o in outs]
        obs = replica.stack_replicas([o[2] for o in outs])   # (R, T, …)
        rows.append(obs)
        lam_tr = obs.lam[:, mp.stride - 1::mp.stride]        # (R, K, S)
        K = lam_tr.shape[1]
        seq = lam_tr.reshape(G, wpp, K, S).transpose(1, 2).reshape(
            G, K * wpp, S)
        Vg = batch.metad_v.reshape(G, wpp, S, mp.nbins)[:, 0]
        dVg = batch.metad_dv.reshape(G, wpp, S, mp.nbins)[:, 0]
        new = [metad.deposit_many(Vg[g], dVg[g], seq[g], mp)
               for g in range(G)]
        batch = dataclasses.replace(
            batch,
            metad_v=torch.stack([v for v, _ in new]).repeat_interleave(
                wpp, dim=0),
            metad_dv=torch.stack([d for _, d in new]).repeat_interleave(
                wpp, dim=0))
        merges.append((Vg, seq, batch.metad_v))
    # (b) in-run deposits: a walker per rung, one chunk in calls of one
    # block, so each call's booked ΔV is its final ext_work minus the
    # ext_work of its last step
    dep = replica.unstack_replicas(batch)[::wpp]
    dep_gens = gens[::wpp]
    booked = []
    for _ in range(-(-chunk // block)):
        before = [(s.metad_v, s.metad_dv) for s in dep]
        outs = [run_block(s, gen) for s, gen in zip(dep, dep_gens)]
        evals += len(dep) * (block + 1)
        dep = [o[0] for o in outs]
        ovs += [o[1] for o in outs]
        rows.append(replica.stack_replicas([o[2] for o in outs]))
        booked.append([(v0, s.metad_v, s.metad_dv, s.lam,
                        s.ext_work - o[2].ext_work[-1], s.ext_work)
                       for v0, s, o in zip(before, dep, outs)])
    # (c) one replica-exchange block on the six walkers; parity 1 pairs
    # walkers of neighbouring rungs
    prev = batch
    batch, _, accepted, last = rex(batch, swap_gen, 1)
    evals += R * (block + 1)
    if dev == "cuda":
        torch.cuda.set_sync_debug_mode("default")
    sync()
    wall = time.perf_counter() - t_prod
    counts = read_counts()
    # -------------------------------------------------------------------

    walker_steps = 2 * R * chunk + G * -(-chunk // block) * block + R * block
    prod = dict(walker_steps=walker_steps,
                ms_per_walker_step=wall / walker_steps * 1e3,
                production_s=wall)
    temp = torch.cat([o.temp.reshape(-1) for o in rows])
    h = torch.cat([o.h_conserved.reshape(-1) for o in rows]
                  + [last.h_conserved])
    prod.update(T_mean=float(temp.mean()), T_min=float(temp.min()),
                T_max=float(temp.max()),
                overflow=bool(torch.stack(ovs).any() | ov_eq),
                h_conserved_finite=bool(torch.isfinite(h).all()),
                swaps_accepted=accepted.tolist(),
                peak_memory_gib=(torch.cuda.max_memory_allocated() / 2**30
                                 if dev == "cuda" else None))
    log(f"[campaign production] {json.dumps(prod)}")
    log(f"[campaign launches] {json.dumps(counts)}, force evaluations "
        f"{evals}")
    if counts != {"ww_pair": evals, "ww_tally": 0}:
        raise RuntimeError("the campaign path did not run every force "
                           "evaluation through the CUDA kernel K1")
    if prod["overflow"] or not prod["h_conserved_finite"]:
        raise RuntimeError("campaign production overflowed or went "
                           "non-finite")
    if not 250.0 < prod["T_mean"] < 350.0:
        raise RuntimeError(f"campaign temperature {prod['T_mean']} K")

    # every hill landed: each merge adds K·wpp hills per site (their mass
    # at full height within [0.8, 1] of it: the WT factor of a 2-chunk
    # fill is above 0.9), and same-rung walkers share their table
    gates = dict(merge_mass_ratio=[], inrun_hills=[], inrun_booked_err=0.0)
    for Vg, seq, V_new in merges:
        for g in range(G):
            grown = (_table_mass(V_new[g * wpp], mp) - _table_mass(Vg[g], mp))
            ratio = grown / _hill_mass(seq[g], mp)
            gates["merge_mass_ratio"].append([float(ratio.min()),
                                              float(ratio.max())])
            if not (0.8 <= ratio.min() and ratio.max() <= 1.0 + 1e-4):
                raise RuntimeError(f"rung {g}: merged tables grew by "
                                   f"{ratio} of the expected hills")
            for w in range(1, wpp):
                if not torch.equal(V_new[g * wpp + w], V_new[g * wpp]):
                    raise RuntimeError(f"rung {g}: walkers' tables differ")
    # in-run: one hill per site in exactly one block of the chunk, and
    # ext_work moved by ΣΔV(λ) of the deposit, up to the float32 rounding
    # of adding it to the thermostat's accumulated work (a few ulp of
    # |ext_work|)
    for r in range(G):
        hills = 0
        for calls in booked:
            (v0, dv0), v1, dv1, lam, moved, work = calls[r]
            added = _table_mass(v1, mp) - _table_mass(v0, mp)
            if float(np.abs(added).max()) > 0.0:
                hills += 1
                ratio = added / _hill_mass(lam[None], mp)
                if not (0.8 <= ratio.min() and ratio.max() <= 1.0 + 1e-4):
                    raise RuntimeError(f"in-run deposit grew the tables by "
                                       f"{ratio} of a hill")
            want = torch.sum(metad.lookup(v1, dv1, lam, mp)[0]
                             - metad.lookup(v0, dv0, lam, mp)[0])
            err = abs(float(moved) - float(want))
            gates["inrun_booked_err"] = max(gates["inrun_booked_err"], err)
            ulp = float(np.spacing(np.float32(abs(float(work)))))
            if err > 4 * ulp + 1e-5 * abs(float(want)):
                raise RuntimeError(f"in-run deposit: ext_work moved by "
                                   f"{float(moved)}, ΣΔV is {float(want)} "
                                   f"(ext_work {float(work)})")
        gates["inrun_hills"].append(hills)
        if hills != 1:
            raise RuntimeError(f"walker {r}: {hills} in-run deposits in one "
                               f"chunk of {chunk} steps at stride "
                               f"{mp.stride}")
    # the swap keeps the pH multiset
    if sorted(batch.pH.tolist()) != sorted(prev.pH.tolist()):
        raise RuntimeError("swap_phs changed the set of pH values")
    # (d) a poisoned replica is flagged alone and rolled back bit for bit
    bad = 1
    poisoned = dataclasses.replace(batch, wv=batch.wv.clone())
    poisoned.wv[bad, 0, 0, 0] = float("nan")
    healthy = replica.replica_healthy(poisoned, lam_min=-0.125,
                                      lam_max=1.125, v_lam_max=0.5)
    if healthy.tolist() != [r != bad for r in range(R)]:
        raise RuntimeError(f"replica_healthy flagged {healthy.tolist()}, "
                           f"not replica {bad} alone")
    seed_before = [gen.initial_seed() for gen in gens]
    rolled = replica.rollback_replicas(poisoned, prev, healthy, salt=3,
                                       generators=gens)
    for f in dataclasses.fields(rolled):
        a = getattr(rolled, f.name)
        if not isinstance(a, torch.Tensor):
            continue
        for r in range(R):
            want = getattr(prev if r == bad else poisoned, f.name)[r]
            if not torch.equal(a[r], want):
                raise RuntimeError(f"rollback: replica {r} field {f.name}")
    if [gen.initial_seed() != s0 for gen, s0 in zip(gens, seed_before)] != [
            r == bad for r in range(R)]:
        raise RuntimeError("rollback reseeded other generators than the "
                           "failed replica's")
    gates["rollback"] = f"replica {bad} restored bit for bit, reseeded"

    # (e) the estimators on the rungs' tables, at the installed slope
    Vg = batch.metad_v.reshape(G, wpp, S, mp.nbins)[:, 0]
    pHs = torch.tensor(CAMPAIGN_PHS, dtype=Vg.dtype, device=Vg.device)
    slope = bias.switch_slope
    est = dict(frac=torch.stack([metad.deprotonated_fraction(Vg[g], mp)
                                 for g in range(G)]),
               dF=torch.stack([metad.delta_f_sites(Vg[g], mp)
                               for g in range(G)]))
    F0 = metad.pooled_intrinsic_profile(Vg, pK, pHs, mp, switch_slope=slope)
    est["pooled_frac"] = torch.stack([
        metad.fraction_at_ph(F0, pK, ph, mp, switch_slope=slope)
        for ph in CAMPAIGN_PHS])
    F1 = metad.retilt_profile(F0, CAMPAIGN_DG_REF, dG_cal, mp,
                              switch_slope=slope)
    est["retilted_frac"] = metad.fraction_at_ph(F1, pK, 5.0, mp,
                                                switch_slope=slope)
    est["pooled_dF"] = metad.pooled_delta_f(F0, mp)
    for k, v in est.items():
        if not torch.isfinite(v).all():
            raise RuntimeError(f"estimator {k} is not finite")
        if "frac" in k and not bool(((v >= 0) & (v <= 1)).all()):
            raise RuntimeError(f"estimator {k} leaves [0, 1]")
    gates["estimators"] = {k: [float(v.min()), float(v.max())]
                           for k, v in est.items()}
    log(f"[campaign gates] {json.dumps(gates)}")

    # measurements: K1 on the campaign tiles, the solute blocks at Ns 600,
    # and one production block under the profiler
    walker = replica.unstack_replicas(batch)[0]
    res = dict(prod=prod, counts=counts, gates=gates)
    if dev == "cuda":
        res["k1"] = check_ww(ts, walker, "campaign-tiles")
        p = ts.params
        kw = dict(style=ts.coul_style, alpha=ts.alpha, rc=ts.cutoff)
        wxg = walker.wx.reshape((3,) + p.grid + (3 * p.W,))
        qs = eng.charges_solute(walker.lam)
        blocks = {}
        for name, fn in (
                ("water_solute_fast", lambda: forces.water_solute_fast(
                    wxg, walker.sx, qs, ts.solute, ts.water, p, walker.box,
                    **kw)),
                ("solute_solute", lambda: forces.solute_solute(
                    walker.sx, qs, ts.solute, walker.box, **kw))):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            blocks[name] = dict(
                ms=cuda_ms(fn, 5),
                peak_extra_gib=(torch.cuda.max_memory_allocated() - base)
                / 2**30)
        log(f"[campaign solute blocks] G {p.G}, A {3 * p.W}, Ns "
            f"{int(ts.solute.q0.shape[0])}: {json.dumps(blocks)}")
        one = eng.make_run(block)
        profile_block(lambda s: one(s, gens[0]), walker,
                      prod["ms_per_walker_step"], block,
                      label="campaign profile")
    log(f"[campaign] phase {time.perf_counter() - t_phase:.1f} s")
    return res


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs a GPU",
              file=sys.stderr)
        return 1
    # fails outside the repository
    from constant_ph_tpu_torch.tiled.layout import retile

    dev = "cuda"
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    kernel_phase(dev)
    # the DSF path keeps the bench's relaxation (shorter ones leave the
    # box above 400 K) and measures a quarter of the blocks, the PME path
    # half, so the campaign phase fits the script's time
    dsf = md_path(dev, "dsf", n_meas=5)
    dsf["checks"].append(check_ww(dsf["ts"], dsf["st"], "dsf-production-tiles"))
    pme = md_path(dev, "pme", n_meas=10, profile="--profile" in sys.argv[1:])
    ts, st = pme["ts"], pme["st"]
    check_pme_on_cpu(ts, st, pme["pme"])
    st, t_counts, _, _ = tally_path(ts, st, pme["pme"], pme["cfg"])
    k1 = check_ww(ts, st, "pme-production-tiles")
    k2 = check_tally(ts, st, "pme-production-tiles")
    # both kernels again on the production state at W 56 (A 168), the
    # width the first two slices timed them at
    ts56, st56 = retile(ts, st, max(56, ts.params.W))
    label = f"pme-production-state-A{3 * ts56.params.W}"
    check_ww(ts56, st56, label)
    check_tally(ts56, st56, label)
    camp = campaign_path(dev)
    k1c = camp["k1"]
    k1_errs = [c["f_abs_err"]
               for c in dsf["checks"] + pme["checks"] + [k1, k1c]]
    kernels = [
        dict(name="ww_pair", route="cuda",
             source="constant_ph_tpu_torch/csrc/ww_pair.cu",
             replaces="constant_ph_tpu/tiled/pallas_ww.py:240",
             launches=pme["counts"]["ww_pair"],
             max_abs_err=max(k1_errs),                   # kcal/mol/Å
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None,
             stencil_bound_ms=k1["stencil_bound_ms"],
             pairs_needed=k1["pairs_needed"],
             pairs_evaluated=k1["pairs_evaluated"],
             # the same kernel on the campaign path and its tiles
             campaign_launches=camp["counts"]["ww_pair"],
             campaign_ms=k1c["ms"], campaign_plain_ms=k1c["plain_ms"],
             campaign_bound_ms=k1c["bound_ms"],
             campaign_pairs_needed=k1c["pairs_needed"],
             campaign_pairs_evaluated=k1c["pairs_evaluated"]),
        dict(name="ww_tally", route="cuda",
             source="constant_ph_tpu_torch/csrc/ww_tally.cu",
             replaces="constant_ph_tpu/tiled/pallas_ww.py:88",
             launches=t_counts["ww_tally"],
             max_abs_err=max(k2["f_abs_err"], k2["phi_abs_err"]),
             ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None,
             stencil_bound_ms=k2["stencil_bound_ms"],
             pairs_needed=k2["pairs_needed"],
             pairs_evaluated=k2["pairs_evaluated"])]
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(gpu_name_and_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
