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
   0.2, 'cut' α 0.30 and unscreened 'cut', at their W 24 and padded with
   parked slots to W 208 and 252 (W_MAX): there each kernel stages its
   stencil in passes (K1 3, K2 9), and the live slots' outputs must equal
   the W 24 ones. Every check of either kernel launches it twice and
   requires bitwise-equal outputs; where a check forces other pass counts
   (the hard tiles, the PME and campaign production tiles, W 208), they
   must give bitwise the same outputs; every K2 check also requires that
   K2 evaluated at least twice the atom pairs inside rc (each is computed
   from both of its atoms). Past W_MAX both wrappers must refuse. Both
   kernels also take a batch of replicas as their grid's z dimension: a
   batch of two hard tile sets (seeds 0 and 1, the second in a box 0.5 %
   longer) in one launch of each, at W 24 and padded to W 208 (K1 3
   passes, K2 9), must give each set bitwise its own launch's forces,
   energies, tallies and pair counts.
2. DSF path (the ``entry()`` configuration; run after the PME path):
   solvated_acid (n_side=20, DSF rc=8 Å, α=0.2, HMR 3, pH 5) →
   split_system(skin=0.8, tile_safety=1.72) → the PME path's relaxed
   production positions and velocities (the same atoms; the builder's λ)
   → 48 Langevin re-equilibration steps in DSF (DSF_START) → retile to
   the measured occupancy + 8 free slots (PROD_MARGIN) → 2 warm-up and
   5 measured
   sync-free production blocks (dt 2 fs, rebuild_every 12, λ Langevin at
   the production driver's γ 0.05 /fs and walls ±0.12, LAMBDA_2FS).
   Gates: K1 launches equal force evaluations, no overflow, finite
   h_conserved, T in 250-350 K, the mean λ temperature T_lam_mean ≤
   T_LAM_MAX (3,000 K), no host sync in a block.
3. PME main path (the ``bench.py`` default) at the same 24,001 atoms:
   'cut' Coulomb α=0.30 rc=8 Å, PME mesh spacing 1.5, p=6 (48³);
   400 FIRE + 800 equilibration steps at kspace_every=1, retile, then 2
   warm-up and 10 measured 12-step production blocks at kspace_every=2
   (impulse MTS), sync-free. PME must run on boundary steps only, and the
   card's pme_recip_tiled is held against the same call on the CPU. K1
   on a batch of six of the path's block-end states in one launch, and
   K2 on two: bitwise each state's own launch, each within its plain
   version's bars, timed from a CUDA graph (batch_graph_ms) beside R ×
   the single bound (the pairs inside rc summed over the states).
3b. PME REX block (``pme_rex_path``, the JAX package's
   __graft_entry__.py:185-225 leg at full width): R = 4 replicas of the
   PME production state at pH 4.0–4.75 with a frozen metadynamics bias
   (one hill each), one 12-step block through make_rex_runner_tiled with
   K1 and one with use_pallas_ww=True (K2). Gates: one launch a batched
   force evaluation (13 each), no host sync, the pH multiset kept; one
   batched force evaluation on a k-space boundary and one off it (each
   replica on its own carried φ) against a CPU copy of the engine within
   5e-4 of max (e_kspace 1e-5 relative), and the off-boundary λ forces
   of each replica within 1e-5 of max of its single evaluation.
4. Tally path on the PME production tiles: blocks with
   TiledEngine(use_pallas_ww=True) (K2 on every force evaluation), the
   compute_Hs sum rule, K2 against K1 through compute_forces, and the
   float64 breakdown of their force difference (each kernel against its
   plain version run in float64, the two float64 plain versions against
   each other, and the atom pairs whose in-cutoff test differs between
   float32 and float64 with the force they carry).
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
   replica_healthy and rolled back bit for bit, (e) the estimators. The
   walkers are one batch: (a) and (c) move all six, (b) its three, with
   one run call and one K1 launch a force evaluation. Gates: K1 launches
   equal batched force evaluations, every hill landed (table mass),
   same-rung tables equal, ext_work moved by ΣΔV, the pH multiset kept, no
   overflow, finite h_conserved, T in 250–350 K, fractions in [0, 1], and
   no synchronisation inside the run blocks. Then one 12-step block of
   the six from one state, batched and looped, with generators of the
   same seeds: λ within 1e-4, positions 1e-3 Å, h_conserved 1e-4
   relative (TOL_BATCH_LOOP); and one 48-step chunk at R = 9 (the
   production driver's default, pH 3.0–7.0 in 0.5 steps), its K1
   launches, no overflow, T. Measured: ms per walker-step at R = 6 (the
   production, and the batched and looped block) and R = 9, peak GiB,
   K1 on the campaign tiles alone and on the six walkers in one launch
   (time, bound, pairs), the water×solute and solute×solute blocks at Ns
   600 (time, memory, also water×solute on the six), and a batched block
   at R = 6 and at R = 9 under torch.profiler (busy ms, device ops).
6. NPT phase on the PME production state: tiled.npt.npt_elastic_run at 1
   atm with the live-box PME, 2 chunks of 48 steps at the PME path's
   settings (dt 2 fs) with an MC volume move after each, and
   make_pressure_fn once. Gates: K1 launches
   equal force evaluations (2 a move), the box within the ±4 % drift
   guard, a move's result is the state the next chunk starts from (redone
   bit for bit), rigid water kept through a move, a finite pressure, no
   host sync in a chunk, T_lam_mean ≤ T_LAM_MAX, and the baked-box engine
   refused.
7. hewl phase: configs/hewl_like.json (solvated_polypeptide, 20,241
   atoms, 16 sites, grid 4³, W 208) as the JAX CLI's tiled run drives it:
   400 FIRE steps at W 208 (K1 in passes), 800 relaxation steps, then
   tiled.elastic.elastic_run at W 208 in 4 chunks of 60 steps (the
   config's 5,000 steps in chunks of 2,000, cut in depth) with a DCD
   frame a chunk, JSONL observables, a checkpoint (state and generator)
   after chunk 2 and chunks 3-4 run twice, in memory and from the file:
   bitwise equal. Gates as on the other paths; K1 and K2 timed at W 208
   and K1 at the occupancy + 6 retile (one pass).
8. CLI phase (``cli_path``, after the hewl phase): the port's command
   line in-process (cli.main), files in a temporary directory, depth cut
   through derived configs: (a) ``run`` on configs/hewl_like.json (20,241
   atoms, W 208, K1 in 3 passes): 100 FIRE steps, 120 steps with a DCD
   frame every 60, JSONL and a checkpoint, every chunk under
   elastic_run's check_sync (no host sync inside a chunk), then
   ``run`` from that checkpoint for 60 steps without FIRE (it must
   start at the saved step, with the saved generator); (b) the same
   system written as a LAMMPS deck and λ-site sidecar, read back by the
   native reader with native exclusions, held to the builder's system at
   the deck's digits (x, q0 1e-6, mass 1e-6 relative, the same triplets;
   e_lj, e_coul, e_bonded 1e-5 relative and forces 1e-5 of max through the
   reference engine), then ``run`` on the deck; (c) on
   configs/glu_water.json (649 atoms, grid 1³, the plain tally path;
   blocks of 2 steps) ``titrate`` rex (its replicas one batch on the
   reference engine: one run call of both a block, one list build for
   both a rebuild_every block, counted) and metad (its walkers one
   batch: one run call of both a chunk), ``calibrate`` TI, and
   ``calibrate`` metad, which must refuse as never crossed; and the
   reference engine's ``run``
   with Ewald k-space, whose first energy must be Engine +
   make_kspace_fn's. K1 launches equal force evaluations of (a) and (b);
   no kernel in (c).
9. Reference path (run between the tally path and the NPT phase, on the
   PME path's system and production state in atom order): the reference
   Engine (padded (N, K) neighbour list, K 384 on a 7³ cell grid of 128
   slots, pair_forces, factorized Ewald at α 0.30 and accuracy 1e-5:
   Mx 20, My = Mz 39): the list build's time and peak memory and one
   Ewald call's; 200 FIRE steps, then 2 warm-up and 5 measured 10-step
   Langevin blocks (dt 2 fs, γ 0.05), sync-free. Gates: no overflow,
   finite h_conserved, T in 250–350 K, no tile kernel launched.
   Readings: each block end's largest displacement against skin/2, the
   rebuilds, and the final forces from the carried list against a fresh
   build.
10. Tiled vs reference, forces in atom order: the DSF production state
   (tests/test_tiled.py:56 bars: forces 3e-5 of max, e_lj and e_coul
   rtol 2e-4, dU/dλ and f_λ rtol 5e-4 / atol 5e-3); the PME production
   state with the tiled engine on Ewald against the reference + Ewald
   (tests/test_tiled.py:152: Coulomb total rtol 3e-3; solute forces and
   each water's net force within 2e-4 of max; dU/dλ rtol 1e-3 / atol
   1e-2) and tiled PME against tiled Ewald (tests/test_tiled.py:258:
   forces 5e-4 of max, dU/dλ rtol 2e-3 / atol 1e-2, e_kspace within
   TOL_PME_EWALD_E).
11. Tiled Ewald path: the PME production state on
   TiledEngine(kspace_ep=EwaldParams, kspace_every=2), 2 warm-up and 5
   measured 12-step blocks. Gates: K1 launches equal force evaluations,
   Ewald called on MTS boundary steps only (its calls counted), no sync
   in a block; then compute_Hs with use_pallas_ww=True: K2 once, the sum
   rule within 1e-3 with k-space.
12. Reference campaign, cut depth: make_rex_runner on R = 4 replicas
   of the reference path's 24,001-atom state at pH 4.0–4.75 (the JAX
   package's __graft_entry__ replica leg at full width) as one batch:
   one 20-step block and a swap, sync-free, with one run call for all R
   and one list build for the batch a rebuild_every block (counted), no
   tile kernel, finite, no overflow, the pH multiset kept; the batch's
   list build peak memory; one 20-step run of the four batched and
   looped from one state with generators of the same seeds (λ 1e-4,
   positions 1e-3 Å, h_conserved 1e-4 relative: TOL_BATCH_LOOP) and
   each form's ms per walker-step; one batched block under
   torch.profiler (device busy ms and device ops a step); the
   ``[reference rex batch]`` line. Then calibrate_dG_ref (7 nodes ×
   (5 + 10) steps after 50 FIRE steps; finite).

13. Multi-rank phases (``ranks_phase``, after the campaign; the parent
   writes a checkpoint of the PME production state, its TiledSystem and
   engine settings and the campaign's merge inputs, and spawns ranks that
   load it and relax nothing): world 1 over nccl, then world 2 as two
   processes sharing the card over gloo (pinned host buffers).
   ``[mesh merge]``: the campaign's (G 3, S 20, nbins 241) tables and
   chunk (a)'s λ snapshots through metad.make_mesh_group_merge, against
   the serial deposit_frozen sum (V 1e-5, dV 1e-4), the tables alike on
   every rank and the hills landed. ``[rank replicas]`` (world 2): the PME
   REX leg's K1 block (R 4, pH 4.0–4.75, frozen bias) with 2 replicas a
   rank, each held to the one-process batched block within
   TOL_BATCH_LOOP, the pHs equal, one launch a force evaluation.
   ``[spatial]``: the PME production tiles (24,001 atoms, grid 6³, PME
   48³, kspace_every 2) on x-slabs (6 and 3 owned x-layers): one force
   evaluation (world 1 bitwise the single-process rows, world 2 within
   TOL_SPATIAL_F of max), a 12-step Langevin block with the same noise
   held to the single-process block (TOL_SPATIAL_RUN), λ and solute
   alike on every rank, one halo exchange (two messages at world 2) a
   force evaluation and one tile gather a block, K1's slab entry on
   every force evaluation, ms/step beside the single-process path's, and
   compute_Hs once through K2's slab entry (TOL_HS_REL); both slab
   entries against their plain versions (water_water_slab_plain and
   water_water_tally_plain with x_first) and their owned rows bitwise
   the whole grid's launch, each timed (``slab_ms``). Then FIRE, NPT and
   Ewald on slabs (``slab_paths``, run alike on slabs and in the
   parent), each from the same state and held to the single-process
   run: world 1 bitwise, world 2 at the bars below.
   ``[spatial fire]``: make_minimize of 2 blocks (energy history rtol
   2e-5, positions 1e-4 Å). ``[spatial npt]``: 2 MC moves with fixed
   uniforms on PME over the live box, every rank the same decisions and
   boxes (boxes rtol 1e-6 of the single process's), one pressure (rtol
   2e-3, atol 5 atm), and one chunk of npt_elastic_run(spatial=) with its
   move (TOL_SPATIAL_RUN). ``[spatial ewald]``: a tiled Ewald engine
   (make_ewald_params at the state's box, α 0.30, accuracy 1e-5; λ held
   at its end state, as the tiled Ewald path holds it): one
   force evaluation (forces 1e-5 of max, energies rtol 2e-5), a 12-step
   block (TOL_SPATIAL_RUN) and compute_Hs through K2's slab entry
   against the whole grid's K2 (rtol 2e-5). Each line carries the
   phase's K1/K2 launches (slab entries on every force evaluation),
   ms/step, and the collectives a step with their bytes.

With PME the uncalibrated acid's λ sits against its upper wall near
1.07, where its titratable H (no LJ) is negative and can fuse with a
water H (the λ-wall event, ROADMAP Queue 3). Two phases met that event
on the H100 with λ moving and hold λ at its nearest end state
(``held_lambda``; neither has a λ gate): the tally path (from the PME
production state, with the state's own λ and from λ 0.8 alike) and the
tiled Ewald path (from λ 0.8: its drift flag). The other phases that
continue the state (NPT, the reference engine, the spatial leg) each
start λ inside (0, 1) (``interior_lambda``: λ LAMBDA_START, v_λ 0) and
run its dynamics at LAMBDA_2FS. The PME REX leg sets its replicas' λ
(0.2-0.8) and runs their λ dynamics.

Every K1 batch check (the hard tiles, six PME block-end states, the
campaign's six walkers) requires ``pairs_other_side`` = 0: K1 takes every
pair's displacement as dx = (x_i − x_j) − s, exactly antisymmetric, so a
pair's two shares lie on one side of rc (settle_rc_pairs; pairs whose
force at rc is below SHARE_FLOOR, the DSF ones, are not judged).

Every path zeroes the kernels' launch counters just before it runs and
reads them just after; each kernel of a path must have launched once per
force evaluation. The kernels are timed (device time, from a CUDA graph
of 50 calls) against their plain versions and their bounds at the PME
production tiles, again with those tiles retiled to W 56 (A 168), on
the campaign tiles and on the hewl tiles.
Each kernel's bound counts the atom pairs those tiles need
(tiled.forces.water_pairs_in_cutoff for K1,
water_pairs_in_cutoff_tally for K2); the whole-stencil figure is printed
beside it as stencil_bound_ms.

``--profile`` adds one PME production block under torch.profiler (device
busy time by kernel and device ops a step).

Output: human-readable lines, then one JSON line {"kernels": [...]}, the
card's name and power limit as nvidia-smi reports them, and last
{"ok": true, "device": {...}}. Any failed check raises (non-zero exit).
"""
from __future__ import annotations

import json
import math
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
# the batched PME energy, card against CPU: within 8 float32 ulps of the
# PME call's own energy (e_kspace less the constant intra-water
# correction; ~4.8e5 kcal/mol at the production tiles, an ulp 0.031).
# e_kspace is the few-thousand remainder of those two terms, so a bar
# relative to it would measure their cancellation; the H100 read 3 ulps
# (0.094 kcal/mol)
TOL_PME_E_ULPS = 8
# K2 against K1 through compute_forces at 'cut' α 0.30: K1 screens with
# a degree-10 Chebyshev fit of erfc and K2 with the Abramowitz–Stegun
# polynomial, and they sum in other orders. On the H100 at the PME
# production tiles (this script, three runs) they differed by 1.2e-5 –
# 1.33e-5 relative in e_coul and e_pot and by 1.05e-5 – 1.68e-5 of max
# in forces, so the forces fail the 1e-5 bar tests/test_tiled.py sets at
# DSF α 0.2. The energy bar is ~4× the largest reading. The two functions
# themselves (their float64 plain versions) differed by 3.07e-5 of max on
# another production state of this script (on the H100: the
# Abramowitz–Stegun erfc's absolute error is a large relative one where
# erfc(αr) is small), so the force bar is that difference plus K2's own
# bar against its plain version (TOL_F_SCALED); each kernel stays held to
# its own plain version at TOL_F_SCALED(_K1)
TOL_K2_K1_E_REL = 5e-5
TOL_K2_K1_F_SCALED = 3.07e-5 + TOL_F_SCALED


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
    from constant_ph_tpu_torch import profiling

    profiling.reset_counters()


def read_counts():
    from constant_ph_tpu_torch import profiling

    c = profiling.counters()
    return {"ww_pair": c["k1_launches"], "ww_tally": c["k2_launches"]}


def read_slab_counts():
    from constant_ph_tpu_torch import profiling

    c = profiling.counters()
    return {"ww_pair": c["k1_slab_launches"],
            "ww_tally": c["k2_slab_launches"]}


def e_close(got, ref):
    return abs(got - ref) <= TOL_E_ABS + TOL_E_REL * abs(ref)


def check_ww(ts, st, label, timing=True, forced=()):
    """K1 against its plain version on a TiledSystem's tiles."""
    p = ts.params
    return check_ww_tiles(st.wx.reshape((3,) + p.grid + (3 * p.W,)),
                          ts.water, p, st.box, label, style=ts.coul_style,
                          alpha=ts.alpha, rc=ts.cutoff, timing=timing,
                          forced=forced)


def check_ww_tiles(wxg, wm, p, box, label, *, style, alpha, rc,
                   timing=False, forced=()):
    """K1 against its plain version on one tile set: energies and forces
    within the bars, and two launches bitwise equal. For each pass count
    in ``forced``, the kernel with its stencil staged in that many passes
    gives bitwise the outputs of the pass count it takes on its own. With
    ``timing``, the kernel's time (also in each forced pass count) and
    the plain version's, the pairs these tiles need and the bounds.
    Returns the numbers."""
    import torch

    from constant_ph_tpu_torch.profiling import cuda_ms, graph_ms
    from constant_ph_tpu_torch.tiled import cuda_ww, forces

    kw = dict(style=style, alpha=alpha, rc=rc)

    def kernel():
        return forces.water_water_fast(wxg, wm, p, box, **kw)

    def plain():
        return forces.water_water_fast_plain(wxg, wm, p, box, **kw)

    got = kernel()
    evaluated = int(cuda_ww.water_water_cuda.pairs_evaluated)
    passes = cuda_ww.water_water_cuda.passes
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
    for n in forced:
        alt = cuda_ww.water_water_cuda(wxg, wm, p, box, passes=n, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, alt)):
            raise RuntimeError(f"{label}: K1 in {n} passes differs from K1 "
                               f"in {passes}")
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
               bitwise_repeat=True, pairs_evaluated=evaluated, passes=passes,
               bitwise_passes=list(forced))
    if timing:
        needed = int(forces.water_pairs_in_cutoff(wxg, p, box, rc))
        res["ms"] = graph_ms(kernel, 50)
        # the same tiles in each forced pass count
        res["ms_passes"] = {n: graph_ms(
            lambda n=n: cuda_ww.water_water_cuda(wxg, wm, p, box, passes=n,
                                                 **kw), 50) for n in forced}
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


def check_ww_batch(wxs, boxes, wm, p, label, *, style, alpha, rc,
                   timing=True):
    """K1 on a batch of R distinct tile sets (wxs (3, gx, gy, gz, A) and
    boxes (3,) each) in one launch against R single launches: forces,
    energies and pair counts bitwise equal, and each replica's single
    launch within the bars of its plain version in float64, where float64
    r² sorts the pairs in or out of rc. Only the pairs within 1e-3 Å² of
    rc² may sit on the other side in K1's float32 (the 'cut' style steps
    there): each atom's share of such a pair counts wholly in or wholly
    out, as K1 chose (settle_rc_pairs). With ``timing``, the batched launch's
    device time (CUDA graph) beside a single launch's, and the batch's
    bound: R × the single bound, from the pairs inside rc summed over
    the replicas. Returns the numbers."""
    import torch

    from constant_ph_tpu_torch.profiling import graph_ms
    from constant_ph_tpu_torch.tiled import cuda_ww, forces

    kw = dict(style=style, alpha=alpha, rc=rc)
    R = len(wxs)
    wxb = torch.stack(wxs).contiguous()
    boxb = torch.stack(boxes).contiguous()

    def batched():
        return cuda_ww.water_water_cuda(wxb, wm, p, boxb, **kw)

    got = batched()
    n_b = cuda_ww.water_water_cuda.pairs_evaluated.clone()
    passes = cuda_ww.water_water_cuda.passes
    e_rel = f_scaled = f_raw = 0.0
    band_pairs, other_side, settled, by_replica = [], [], [], []
    for r in range(R):
        one = cuda_ww.water_water_cuda(wxs[r], wm, p, boxes[r], **kw)
        n_1 = cuda_ww.water_water_cuda.pairs_evaluated
        if not (all(torch.equal(a[r], b) for a, b in zip(got, one))
                and torch.equal(n_b[r:r + 1], n_1)):
            raise RuntimeError(f"{label}: K1 on the batch differs from K1 "
                               f"on replica {r} alone")
        ref = forces.water_water_fast_plain(wxs[r].double(), wm, p,
                                            boxes[r].double(), **kw)
        scale = max(1.0, float(torch.abs(ref[2]).max()))
        diff = {"f": one[2].double() - ref[2],
                "e": torch.stack([one[0].double() - ref[0],
                                  one[1].double() - ref[1]])}
        f_raw = max(f_raw, float(diff["f"].abs().max()) / scale)
        pairs = rc_band_pairs(wxs[r], p, boxes[r], wm, **kw)
        band_pairs.append(len(pairs))
        n_settled, n_split = settle_rc_pairs(diff, {"f": scale}, pairs,
                                             k1_pair_terms)
        settled.append(n_settled)
        other_side.append(n_split)
        by_replica.append(float(diff["f"].abs().max()) / scale)
        f_scaled = max(f_scaled, by_replica[-1])
        e = [float(ref[i]) for i in (0, 1)]
        if not all(e_close(e[i] + float(diff["e"][i]), e[i])
                   for i in (0, 1)):
            raise RuntimeError(f"{label}: replica {r} energies off the "
                               "plain version's")
        e_rel = max(e_rel, *(abs(float(diff["e"][i])) / abs(e[i])
                             for i in (0, 1)))
    G, A = p.G, 3 * p.W
    res = dict(label=label, R=R, G=G, A=A, style=style, passes=passes,
               bitwise_batch=True, e_rel_err=e_rel, f_scaled_err=f_scaled,
               f_scaled_err_raw=f_raw, f_scaled_err_by_replica=by_replica,
               pairs_at_rc=band_pairs, pairs_other_side=other_side,
               shares_settled=settled, pairs_evaluated=n_b.tolist())
    if timing:
        needed = [int(forces.water_pairs_in_cutoff(wxs[r], p, boxes[r], rc))
                  for r in range(R)]
        res["batch_graph_ms"] = graph_ms(batched, 50)
        res["single_graph_ms"] = graph_ms(lambda: cuda_ww.water_water_cuda(
            wxs[0], wm, p, boxes[0], **kw), 50)
        res["pairs_needed"] = needed
        res["batch_bound_ms"], res["bound_by"] = _bound(
            R * (2 * 3 * G * A * 4 + 3 * 4 + 2 * 4),
            sum(needed) * FLOPS_PER_PAIR)
    log(f"[kernel batch] ww_pair {json.dumps(res)}")
    if f_scaled > TOL_F_SCALED_K1:
        raise RuntimeError(f"{label}: K1 forces {f_scaled:.3g} of max off "
                           "the plain version's")
    # K1 takes dx = (x_i - x_j) - s: a pair's two shares see the same r²
    # bits and fall on the same side of rc
    if any(other_side):
        raise RuntimeError(f"{label}: K1 placed the two shares of "
                           f"{other_side} pairs on opposite sides of rc")
    return res


def check_tally_batch(wts, boxes, wm, p, label, *, style, alpha, rc,
                      timing=True):
    """K2 on a batch of R distinct packed tile sets (wts (gx, gy, gz, 8,
    A) each) in one launch against R single launches: outputs and pair
    counts bitwise equal, and each replica's single launch within
    TOL_F_SCALED of its plain version in float64, the pairs within 1e-3
    Å² of rc² each atom's share counted wholly in or out as K2 chose
    (settle_rc_pairs). With ``timing``, the batched launch's device time
    (CUDA graph) beside a single launch's, and the batch's bound (the
    pairs inside rc summed over the replicas). Returns the numbers."""
    import torch

    from constant_ph_tpu_torch.profiling import graph_ms
    from constant_ph_tpu_torch.tiled import cuda_ww, forces

    kw = dict(style=style, alpha=alpha, rc=rc)
    R = len(wts)
    wtb = torch.stack(wts).contiguous()
    boxb = torch.stack(boxes).contiguous()

    def batched():
        return cuda_ww.water_water_tally_cuda(wtb, boxb, wm, p, **kw)

    got = batched()
    n_b = cuda_ww.water_water_tally_cuda.pairs_evaluated.clone()
    passes = cuda_ww.water_water_tally_cuda.passes
    scaled = raw = 0.0
    band_pairs, other_side, settled = [], [], []
    groups = (("f", slice(0, 3)), ("eatom", slice(3, 5)),
              ("phi", slice(5, 6)))
    for r in range(R):
        one = cuda_ww.water_water_tally_cuda(wts[r], boxes[r], wm, p, **kw)
        if not (torch.equal(got[r], one) and torch.equal(
                n_b[r:r + 1], cuda_ww.water_water_tally_cuda.pairs_evaluated)):
            raise RuntimeError(f"{label}: K2 on the batch differs from K2 "
                               f"on replica {r} alone")
        ref = forces.water_water_tally_plain(wts[r].double(),
                                             boxes[r].double(), wm, p, **kw)
        # one tensor over all rows, so each group's view shares its index
        diff = one.double() - ref
        diffs = {g: diff for g, _ in groups}
        scales = {g: max(1.0, float(torch.abs(ref[..., rows, :]).max()))
                  for g, rows in groups}
        raw = max(raw, *(float(diff[..., rows, :].abs().max()) / scales[g]
                         for g, rows in groups))
        pairs = rc_band_pairs(wts[r][..., :3, :].movedim(-2, 0), p,
                              boxes[r], wm, **kw)
        band_pairs.append(len(pairs))
        n_settled, n_split = settle_rc_pairs(diffs, scales, pairs,
                                             k2_pair_terms)
        settled.append(n_settled)
        other_side.append(n_split)
        scaled = max(scaled, *(float(diff[..., rows, :].abs().max())
                               / scales[g] for g, rows in groups))
    G, A = p.G, 3 * p.W
    res = dict(label=label, R=R, G=G, A=A, style=style, passes=passes,
               bitwise_batch=True, scaled_err=scaled, scaled_err_raw=raw,
               pairs_at_rc=band_pairs, pairs_other_side=other_side,
               shares_settled=settled, pairs_evaluated=n_b.tolist())
    if timing:
        needed = [int(forces.water_pairs_in_cutoff_tally(wts[r], boxes[r], p,
                                                         rc))
                  for r in range(R)]
        res["batch_graph_ms"] = graph_ms(batched, 50)
        res["single_graph_ms"] = graph_ms(
            lambda: cuda_ww.water_water_tally_cuda(wts[0], boxes[0], wm, p,
                                                   **kw), 50)
        res["pairs_needed"] = needed
        res["batch_bound_ms"], res["bound_by"] = _bound(
            R * _tally_bytes(G, A),
            sum(needed) * FLOPS_PER_PAIR_TALLY[style])
    log(f"[kernel batch] ww_tally {json.dumps(res)}")
    if scaled > TOL_F_SCALED:
        raise RuntimeError(f"{label}: K2 {scaled:.3g} of max off the plain "
                           "version's")
    return res


def tile_sets(ts, states):
    """Each state's (wxg (3, gx, gy, gz, A), wt packed, box): the tiles
    the kernels take."""
    from constant_ph_tpu_torch.tiled import forces

    p = ts.params
    out = []
    for st in states:
        wxg = st.wx.reshape((3,) + p.grid + (3 * p.W,)).contiguous()
        wt = forces.pack_water_tiles(wxg, st.wvalid.reshape(p.grid + (p.W,)),
                                     ts.water, p)
        out.append((wxg, wt, st.box.contiguous()))
    return out


def check_batches(ts, states, label, k2_replicas=0):
    """K1 on the batch of ``states`` (one tile set each) against single
    launches, timed; K2 likewise on the first ``k2_replicas``."""
    sets = tile_sets(ts, states)
    kw = dict(style=ts.coul_style, alpha=ts.alpha, rc=ts.cutoff)
    res = {"k1": check_ww_batch([s[0] for s in sets], [s[2] for s in sets],
                                ts.water, ts.params, label, **kw)}
    if k2_replicas:
        sets = sets[:k2_replicas]
        res["k2"] = check_tally_batch([s[1] for s in sets],
                                      [s[2] for s in sets], ts.water,
                                      ts.params, label, **kw)
    return res


def check_tally(ts, st, label, timing=True, forced=()):
    """K2 against its plain version on a TiledSystem's tiles."""
    from constant_ph_tpu_torch.tiled import forces

    p = ts.params
    gx, gy, gz = p.grid
    wt = forces.pack_water_tiles(st.wx.reshape(3, gx, gy, gz, 3 * p.W),
                                 st.wvalid.reshape(gx, gy, gz, p.W),
                                 ts.water, p)
    return check_tally_tiles(wt, st.box, ts.water, p, label,
                             style=ts.coul_style, alpha=ts.alpha,
                             rc=ts.cutoff, timing=timing, forced=forced)


def check_tally_tiles(wt, box, wm, p, label, *, style, alpha, rc,
                      timing=False, forced=()):
    """K2 against its plain version on one set of packed tiles: energies
    (sums of the eatom rows) within the bars, forces, eatom and φ within
    TOL_F_SCALED of their max, zero padding rows, two launches bitwise
    equal, at least twice the atom pairs inside rc evaluated, and for
    each pass count in ``forced`` bitwise the outputs of the pass count
    the kernel takes on its own. With ``timing``, the kernel's time
    (also in each forced pass count) and the plain version's, and the
    bounds. Returns the numbers."""
    import torch

    from constant_ph_tpu_torch.profiling import cuda_ms, graph_ms
    from constant_ph_tpu_torch.tiled import cuda_ww, forces

    kw = dict(style=style, alpha=alpha, rc=rc)

    def kernel():
        return cuda_ww.water_water_tally_cuda(wt, box, wm, p, **kw)

    def plain():
        return forces.water_water_tally_plain(wt, box, wm, p, **kw)

    got = kernel()
    evaluated = int(cuda_ww.water_water_tally_cuda.pairs_evaluated)
    passes = cuda_ww.water_water_tally_cuda.passes
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
    for n in forced:
        alt = cuda_ww.water_water_tally_cuda(wt, box, wm, p, passes=n, **kw)
        if not torch.equal(got, alt):
            raise RuntimeError(f"{label}: K2 in {n} passes differs from K2 "
                               f"in {passes}")
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
               pairs_needed=needed, pairs_evaluated=evaluated, passes=passes,
               bitwise_passes=list(forced))
    if timing:
        res["ms"] = graph_ms(kernel, 50)
        # the same tiles in each forced pass count
        res["ms_passes"] = {n: graph_ms(
            lambda n=n: cuda_ww.water_water_tally_cuda(wt, box, wm, p,
                                                       passes=n, **kw), 50)
            for n in forced}
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
    Coulomb styles) and on the hard tile set (tiled/hard_tiles.py): at
    its W 24 (one pass, and forced to 3, 9 and 27 passes: bitwise the
    same), padded with parked slots to W 208 (passes: K1 3, K2 9; forced
    to other counts: bitwise the same; the live slots' outputs equal those
    at W 24 within float32 rounding, the parked slots' are zeros) and to
    W_MAX 252; past W_MAX each wrapper refuses, naming the limit."""
    import torch

    from constant_ph_tpu_torch.systems.water import solvated_acid
    from constant_ph_tpu_torch.tiled import cuda_ww, forces
    from constant_ph_tpu_torch.tiled.hard_tiles import (
        COULOMB, hard_water_tiles, pad_tiles)
    from constant_ph_tpu_torch.tiled.layout import (
        W_MAX, TileParams, WaterModel, split_system, to_tiled)

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

    def tiles(h):
        p = TileParams(**h["params"])
        wxg = torch.as_tensor(h["wx"], device=dev).reshape(
            (3,) + p.grid + (3 * p.W,))
        wm = WaterModel(**h["water"])
        # K2's tiles carry the hard tiles' own validity (0 on parked slots)
        wt = forces.pack_water_tiles(
            wxg, torch.as_tensor(h["wvalid"], device=dev).reshape(
                p.grid + (p.W,)), wm, p)
        return p, wxg, wm, wt, torch.as_tensor(h["box"], device=dev)

    hard = hard_water_tiles()
    p, wxg, wm, wt, box = tiles(hard)
    base = {}
    for style, alpha in COULOMB:
        label = f"hard-{style}-{alpha}"
        kw = dict(style=style, alpha=alpha, rc=p.cutoff)
        check_ww_tiles(wxg, wm, p, box, label, forced=(3, 9, 27), **kw)
        check_tally_tiles(wt, box, wm, p, label, forced=(3, 9, 27), **kw)
        base[style, alpha] = (
            cuda_ww.water_water_cuda(wxg, wm, p, box, **kw),
            cuda_ww.water_water_tally_cuda(wt, box, wm, p, **kw))
    # the same molecules at W 208 and W_MAX: K1's and K2's live slots as
    # at W 24 within float32 rounding (sums of other lengths), parked
    # slots zero
    for W in (208, W_MAX):
        pw, wxw, _, wtw, _ = tiles(pad_tiles(hard, W))
        live = torch.zeros(pw.grid + (3 * W,), dtype=torch.bool, device=dev)
        live[..., :3 * p.W] = True
        for style, alpha in COULOMB if W == 208 else COULOMB[1:2]:
            label = f"hard-W{W}-{style}-{alpha}"
            kw = dict(style=style, alpha=alpha, rc=p.cutoff)
            r1 = check_ww_tiles(wxw, wm, pw, box, label, **kw,
                                forced=(9,) if W == 208 else ())
            r2 = check_tally_tiles(wtw, box, wm, pw, label, **kw,
                                   forced=(3,) if W == 208 else ())
            if (r1["passes"], r2["passes"]) != (3, 9):
                raise RuntimeError(f"{label}: passes {r1['passes']}, "
                                   f"{r2['passes']} (want K1 3, K2 9)")
            f1 = cuda_ww.water_water_cuda(wxw, wm, pw, box, **kw)[2]
            o2 = cuda_ww.water_water_tally_cuda(wtw, box, wm, pw, **kw)
            b1, b2 = base[style, alpha]
            d1 = float(torch.abs(f1[:, live].reshape(3, -1)
                                 - b1[2].reshape(3, -1)).max())
            d2 = float(torch.abs(o2.movedim(-2, 0)[:, live]
                                 - b2.movedim(-2, 0).reshape(8, -1)).max())
            s1 = max(1.0, float(torch.abs(b1[2]).max()))
            s2 = max(1.0, float(torch.abs(b2).max()))
            log(f"[kernel] {label} vs W {p.W}: K1 f {d1 / s1:.3g}, K2 "
                f"{d2 / s2:.3g} of max; parked slots zero")
            if (d1 / s1 > 1e-6 or d2 / s2 > 1e-6 or f1[:, ~live].any()
                    or o2.movedim(-2, 0)[:, ~live].any()):
                raise RuntimeError(f"{label}: padded tiles differ from "
                                   f"the W {p.W} tiles")
    # a batch of two hard tile sets (seeds 0 and 1, the second in a box
    # 0.5 % longer, so each replica must read its own box) in one launch
    # of each kernel, bitwise each set's own launch: at W 24 (one pass)
    # and padded to W 208 (K1 3 passes, K2 9)
    other = hard_water_tiles(seed=1)
    other["box"] = (other["box"] * 1.005).astype(other["box"].dtype)
    for W in (None, 208):
        sets = [tiles(h if W is None else pad_tiles(h, W))
                for h in (hard, other)]
        pw = sets[0][0]
        for style, alpha in COULOMB[1:2]:
            label = f"hard-batch-W{pw.W}-{style}-{alpha}"
            kw = dict(style=style, alpha=alpha, rc=pw.cutoff)
            r1 = check_ww_batch([s[1] for s in sets], [s[4] for s in sets],
                                wm, pw, label, timing=False, **kw)
            r2 = check_tally_batch([s[3] for s in sets],
                                   [s[4] for s in sets], wm, pw, label,
                                   timing=False, **kw)
            if W == 208 and (r1["passes"], r2["passes"]) != (3, 9):
                raise RuntimeError(f"{label}: passes {r1['passes']}, "
                                   f"{r2['passes']} (want K1 3, K2 9)")
    # past W_MAX: a refusal that names the limit
    pw, wxw, _, wtw, _ = tiles(pad_tiles(hard, W_MAX + 4))
    for fn in (lambda: cuda_ww.water_water_cuda(wxw, wm, pw, box, **kw),
               lambda: cuda_ww.water_water_tally_cuda(wtw, box, wm, pw,
                                                      **kw)):
        try:
            fn()
        except ValueError as err:
            if str(W_MAX) not in str(err):
                raise
        else:
            raise RuntimeError(f"a kernel took W {W_MAX + 4}")
    log(f"[kernel] W {W_MAX + 4} refused by both wrappers")


def profile_block(run_block, st, ms_step, block, label="profile"):
    """torch.profiler over one production block (profiling.profile_block):
    device busy time by kernel and kernel launches per step. Returns
    (state, {busy ms/step, device ops/step})."""
    from constant_ph_tpu_torch.profiling import profile_block as prof

    st, bp = prof(run_block, st, block)
    summary = dict(busy_ms_per_step=bp.busy_ms_per_step,
                   ops_per_step=bp.ops_per_step)
    log(f"[{label}] device busy {bp.busy_ms_per_step:.3f} ms/step "
        f"(unprofiled step {ms_step:.3f} ms); "
        f"{bp.ops_per_step:.0f} device ops/step")
    # the top rows, and the port's own kernels wherever they rank
    for i, (us, n, key) in enumerate(bp.rows):
        if i < 12 or any(k in key for k in ("ww_pair", "ww_tally",
                                            "energy_sum")):
            log(f"[{label}] {us / 1e3 / block:9.4f} ms/step "
                f"{n / block:6.1f}/step {key[:90]}")
    return st, summary


# bench.py's pair settings (:128-131); the builder's skin sizes the
# reference engine's neighbour list
PAIR = {"dsf": dict(cutoff=8.0, skin=0.8, coul_style="dsf", alpha=0.2),
        "pme": dict(cutoff=8.0, skin=0.8, coul_style="cut", alpha=0.30)}
PME_MESH = dict(spacing=1.5, p=6)
# λ in the DSF and PME production blocks (dt 2 fs): the λ thermostat and
# walls of the JAX package's production campaign driver at dt 2 fs
# (examples/titration_metad_multisite.py:318-320), which the campaign
# phase runs too. At bench.py's defaults (λ γ 0.005 /fs, walls -0.5 and
# 1.5) λ runs hot in both packages (ROADMAP Queue 3; on a 3,001-atom box
# in JAX on the CPU, T_λ 5,577-6,246 K with PME, 2,311-2,355 K with DSF)
# and the continued PME state can collapse
LAMBDA_2FS = dict(lambda_gamma=0.05, lam_min=-0.12, lam_max=1.12)
# free slots a cell keeps when the DSF and PME paths retile to their
# occupancy before production (the hewl phase keeps 6, the campaign 12):
# at 4, the PME production at LAMBDA_2FS filled a cell to W - 1 (rebin's
# capacity flag) within its 144 steps
PROD_MARGIN = 8
# the DSF path from the PME path's production state (the same atoms,
# thermal at ~326 K): no FIRE, a 48-step re-equilibration in DSF
DSF_START = dict(n_min=0, n_eq=48)
# bound on T_lam_mean, the production mean of the one site's
# instantaneous λ temperature: 10 T. One degree of freedom is
# heavy-tailed (JAX at LAMBDA_2FS on a 3,001-atom box: mean 565-617 K,
# median 158-161, single steps up to 47,884 K), so a mean over 60-192
# steps spreads over several T: the DSF path read 1,506 K at LAMBDA_2FS
# on the card. The bench defaults read 12,003 K (PME) and 15,567 K (DSF)
# there, 4-5x above the bound
T_LAM_MAX = 3000.0


# λ of every site at the start of each phase that continues the PME
# production state: inside (0, 1), the PME REX leg's highest start. From
# there λ falls into its upper wall within a few steps and the fall's
# energy passes through λ's kinetic energy; the further the start from
# the wall, the larger that λ-temperature transient in T_lam_mean
LAMBDA_START = 0.8


def held_lambda(st, cfg):
    """The state with each site's λ at its nearest end state (0 or 1) and
    v_λ 0, and cfg with λ held (lambda_frozen): the start of the tally
    and tiled Ewald paths. With λ moving, the tally path met the λ-wall
    event from the PME production state (with the state's own λ, 1.07,
    and from λ 0.8) and the tiled Ewald path from λ 0.8 (its drift flag
    tripped after λ reached its wall); at an end state every charge is
    one of the model's own. K2 runs λ dynamics in the PME REX leg."""
    import dataclasses

    import torch

    held = dataclasses.replace(
        st, lam=torch.round(torch.clamp(st.lam, 0.0, 1.0)),
        v_lam=torch.zeros_like(st.v_lam))
    return held, dataclasses.replace(cfg, lambda_frozen=True)


def interior_lambda(st):
    """The state (tiled or in atom order) with every site's λ at
    LAMBDA_START and v_λ 0. With the uncalibrated acid and PME, λ sits
    against its upper wall near 1.07, where the acid's titratable H (no
    LJ) carries a negative charge and can fuse with a water H (ROADMAP
    Queue 3); NPT, the reference engine and the spatial leg start λ
    inside (0, 1) instead, where every charge lies between the model's
    end states, and run its λ dynamics from there."""
    import dataclasses

    import torch

    return dataclasses.replace(st, lam=torch.full_like(st.lam, LAMBDA_START),
                               v_lam=torch.zeros_like(st.v_lam))


def md_path(dev, kind, n_side=20, n_min=400, n_eq=800, n_meas=20,
            profile=False, start=None):
    """One MD path through the port's entry points at the bench size:
    build → minimise → equilibrate (kspace_every 1) → retile → warm-up and
    measured production blocks (kspace_every 2 with PME). With ``start``
    (another path's (ts, st) of the same system) the built system takes
    that state's positions and velocities, its λ the builder's, and
    ``n_min`` may be 0. The launch counters are zeroed just before the
    run and read just after; every force evaluation must have gone
    through K1. Smaller sizes only serve a rehearsal on the CPU. Returns
    the run's objects and numbers."""
    import dataclasses

    import torch

    from constant_ph_tpu_torch import units
    from constant_ph_tpu_torch.engine import EngineConfig
    from constant_ph_tpu_torch.ops.pme import make_pme_params
    from constant_ph_tpu_torch.systems.water import solvated_acid
    from constant_ph_tpu_torch.tiled.engine import TiledEngine
    from constant_ph_tpu_torch.tiled.layout import (
        retile, split_system, to_canonical, to_tiled)

    t0 = time.perf_counter()
    sys_ = solvated_acid(n_side=n_side, rigid_water=True, lambda_coupled=True,
                         hmr=3.0, pH=5.0, device=dev, **PAIR[kind])
    ts = split_system(sys_, skin=0.8, tile_safety=1.72, device=dev)
    state = sys_.state
    if start is not None:
        relaxed = to_canonical(*start)
        state = dataclasses.replace(state, x=relaxed.x, v=relaxed.v)
    st = to_tiled(ts, state)
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
    if n_min:
        st, e_hist = eng_eq.make_minimize(n_min)(st)
        torch.cuda.synchronize()
        log(f"[{kind} minimize] {n_min} steps: E {float(e_hist[0]):.1f} "
            f"-> {float(e_hist[-1]):.1f} kcal/mol in "
            f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    st, ov_eq, obs = eng_eq.make_run(n_eq)(st)
    torch.cuda.synchronize()
    log(f"[{kind} equilibrate] {n_eq} steps: T {float(obs.temp[-1]):.1f} K, "
        f"overflow {bool(ov_eq)} in {time.perf_counter() - t0:.1f} s")
    occ_max = int(st.wvalid.sum(dim=1).max())
    W_prod = -(-(occ_max + PROD_MARGIN) // 4) * 4
    ts, st = retile(ts, st, W_prod)
    log(f"[{kind} retile] occ_max {occ_max} -> W {ts.params.W} "
        f"(A = {3 * ts.params.W})")

    cfg = EngineConfig(dt=2.0, thermostat="langevin", T=300.0, gamma=0.002,
                       lambda_thermostat="langevin", rebuild_every=block,
                       kspace_every=2 if pme else 1, seed=2, **LAMBDA_2FS)
    eng = TiledEngine(ts, cfg, kspace_ep=pme)
    run_block = eng.make_run(block, detailed_flags=True)
    for _ in range(n_warm):
        st, _, obs = run_block(st)
    torch.cuda.synchronize()
    ov_cap = ov_drift = torch.zeros((), dtype=torch.bool,
                                    device=st.wx.device)
    rows = []
    # the run loop must never wait for the device: any synchronising
    # call (.item(), a pageable host copy, ...) inside a block raises here
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    block_states = []
    for _ in range(n_meas):
        st, (cap, drift), obs = run_block(st)
        ov_cap, ov_drift = ov_cap | cap, ov_drift | drift
        rows.append(obs)
        block_states.append(st)
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
        # the λ temperature (one site, instantaneous, averaged over the
        # steps), bounded by T_LAM_MAX: λ heated far above T at dt 2 fs
        # is the fault of ROADMAP Queue 3
        T_lam_mean=float(torch.cat([o.temp_lam for o in rows]).mean()),
        lam_min=float(lam.min()), lam_max=float(lam.max()),
        overflow=bool(ov_cap | ov_drift | ov_eq),
        capacity_flag=bool(ov_cap), drift_flag=bool(ov_drift),
        h_conserved_finite=bool(
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
    if not result["T_lam_mean"] <= T_LAM_MAX:
        raise RuntimeError(f"{kind} production λ temperature "
                           f"{result['T_lam_mean']} K")
    # PME on boundary steps only: e_kspace is non-zero exactly on the
    # h_valid rows (every other step at kspace_every 2); none without PME
    want_k = h_valid if pme is not None else torch.zeros_like(h_valid)
    if not torch.equal(e_k != 0, want_k) or (
            pme is not None and result["h_valid_rows"] != n_steps // 2):
        raise RuntimeError(f"{kind}: k-space ran on other steps than the "
                           "MTS boundaries")
    if profile:
        st, _ = profile_block(run_block, st, ms_step, block)
    # the last six block ends: distinct states on the production tiles
    return dict(system=sys_, ts=ts, st=st, pme=pme, cfg=cfg, counts=counts,
                result=result, checks=checks, block_states=block_states[-6:])


def check_pme_on_cpu(ts, st, pme):
    """The card's pme_recip_tiled against the same call on a CPU copy of
    the production tiles (guards against TF32 and FFT differences), and
    its time on the card."""
    import torch

    from constant_ph_tpu_torch.ops.pme import make_pme_params, pme_recip_tiled
    from constant_ph_tpu_torch.profiling import cuda_ms

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
    # the pairs whose in-cutoff test differs between float32 and float64
    # r² ('cut' Coulomb steps at rc), the force they carry, and what is
    # left of each kernel's distance from its float64 plain version once
    # that force is taken off (it carries the sign of the float32 choice)
    n_flip, f_flip = cutoff_flips(wxg, p, st.box, ts.water, **kw)
    f64["cutoff_flip_pairs"] = n_flip
    f64["cutoff_flip_force"] = float(torch.abs(f_flip).max()) / scale
    f64["k1_vs_plain64_less_flips"] = float(
        torch.abs(k1 - k1_64 - f_flip).max()) / scale
    f64["k2_vs_plain64_less_flips"] = float(
        torch.abs(k2 - k2_64 - f_flip).max()) / scale
    hs["ww_f_scaled"] = f64
    log(f"[tally float64] water-water forces / max|f| {json.dumps(f64)}")
    if hs["rel_err"] > 1e-3:
        raise RuntimeError(f"compute_Hs sum rule fails ({hs})")
    if (max(hs[f"{n}_rel_k2_k1"] for n in ("e_lj", "e_coul", "e_pot"))
            > TOL_K2_K1_E_REL or hs["f_scaled_k2_k1"] > TOL_K2_K1_F_SCALED):
        raise RuntimeError(f"K2 and K1 paths disagree ({hs})")
    return st, counts, res, hs


# the JAX package's campaign-physics replica leg (__graft_entry__.py:185-
# 225) at the PME main path's full width: its pH ladder and metadynamics
# parameters, one hill a replica in the frozen bias
PME_REX_PHS = (4.0, 4.25, 4.5, 4.75)
PME_REX_METAD = dict(nbins=61, sigma=0.05, h0=0.3, gamma=20.0, stride=4)


def pme_rex_batch(ts, st):
    """The PME REX leg's R = 4 replicas of a state at PME_REX_PHS, each
    with λ 0.2 + 0.2 r and one hill of the frozen bias at its λ; and the
    metadynamics parameters."""
    import dataclasses

    import torch

    from constant_ph_tpu_torch import metad
    from constant_ph_tpu_torch.parallel import replica

    mp = metad.MetadParams(**PME_REX_METAD)
    V0, dV0 = metad.init_tables(ts.spec.n_sites, mp, device=st.lam.device)
    reps = []
    for r, ph in enumerate(PME_REX_PHS):
        lam = torch.full_like(st.lam, 0.2 + 0.2 * r)
        V, dV = metad.deposit(V0, dV0, lam, mp)
        reps.append(dataclasses.replace(
            st, pH=torch.full_like(st.pH, ph), lam=lam, metad_v=V,
            metad_dv=dV))
    return replica.stack_replicas(reps), mp


def pme_rex_path(ts, st, pme, cfg):
    """The REX leg of __graft_entry__.py at the PME main path's width:
    R = 4 replicas of the PME production state (24,001 atoms, kspace_every
    2) at pH 4.0–4.75 with a frozen metadynamics bias, one block through
    make_rex_runner_tiled with K1, then one with use_pallas_ww=True (K2),
    the counts zeroed just before each and read just after: one launch a
    batched force evaluation, no host sync. Then one batched force
    evaluation on a k-space boundary and one off it (each replica's λ
    forces on its own carried φ) against the same evaluations of a CPU
    copy of the engine, within TOL_PME_SCALED of max (e_kspace
    TOL_PME_E_ULPS), and the off-boundary one against each replica's
    single evaluation on the card."""
    import dataclasses

    import torch

    from constant_ph_tpu_torch.ops.pme import make_pme_params
    from constant_ph_tpu_torch.parallel import replica
    from constant_ph_tpu_torch.tiled.engine import TiledEngine

    batch, mp = pme_rex_batch(ts, st)
    R = batch.pH.shape[0]
    res = dict(R=R, pH=list(PME_REX_PHS), steps=cfg.rebuild_every)
    t_phase = time.perf_counter()
    for name, k2 in (("ww_pair", False), ("ww_tally", True)):
        eng = TiledEngine(ts, cfg, kspace_ep=pme, metad=mp, metad_frozen=True,
                          use_pallas_ww=k2)
        block = replica.make_rex_runner_tiled(
            eng, cfg.rebuild_every, generators=replica.replica_generators(
                [500 + r for r in range(R)], st.lam.device))
        swap = torch.Generator(device=st.lam.device).manual_seed(25)
        torch.cuda.synchronize()
        zero_counts()
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        out, _, accepted, last = block(batch, swap, 0)
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        want = {"ww_pair": 0, "ww_tally": 0}
        want[name] = cfg.rebuild_every + 1
        res[name] = dict(
            launches=counts, ms_per_walker_step=wall / (
                R * cfg.rebuild_every) * 1e3,
            T=last.temp.tolist(), accepted=accepted.tolist(),
            finite=bool(torch.isfinite(last.h_conserved).all()))
        log(f"[pme rex {name}] {json.dumps(res[name])}")
        if counts != want or not res[name]["finite"]:
            raise RuntimeError(f"the PME REX block with {name} failed its "
                               f"checks (launches {counts}, want {want})")
        if sorted(out.pH.tolist()) != sorted(batch.pH.tolist()):
            raise RuntimeError("the PME REX swap changed the pH multiset")
        if name == "ww_pair":        # what the rank-split block is held to
            res["k1_out"] = dict(lam=out.lam, sx=out.sx, wx=out.wx,
                                 pH=out.pH, accepted=accepted,
                                 h=last.h_conserved)
        batch = out
    if batch.step_host % cfg.kspace_every:
        raise RuntimeError("the PME REX blocks ended off a k-space boundary")

    # one batched evaluation on a boundary, then one off it on the φ it
    # carried, on the card and on a CPU copy
    eng = TiledEngine(ts, cfg, kspace_ep=pme, metad=mp, metad_frozen=True)
    ts_c = ts.to("cpu")
    pme_c = make_pme_params(pme.box.cpu().numpy(), pme.grid, pme.alpha,
                            skin=0.8, device="cpu", **PME_MESH)
    eng_c = TiledEngine(ts_c, cfg, kspace_ep=pme_c, metad=mp,
                        metad_frozen=True)
    batch_c = dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name).cpu()
        for f in dataclasses.fields(batch)
        if isinstance(getattr(batch, f.name), torch.Tensor)})
    off = dict(step_host=batch.step_host + 1)
    f_on = eng.compute_forces(batch, kspace_impulse=True,
                              phi_recip_prev=batch.phi_recip_s)
    f_off = eng.compute_forces(dataclasses.replace(batch, **off),
                               kspace_impulse=True,
                               phi_recip_prev=f_on.phi_recip_s)
    c_on = eng_c.compute_forces(batch_c, kspace_impulse=True,
                                phi_recip_prev=batch_c.phi_recip_s)
    c_off = eng_c.compute_forces(dataclasses.replace(batch_c, **off),
                                 kspace_impulse=True,
                                 phi_recip_prev=c_on.phi_recip_s)
    errs = {}
    for tag, a, b in (("on", f_on, c_on), ("off", f_off, c_off)):
        for name in ("fw", "fs", "dUdlam", "phi_recip_s"):
            g, c = getattr(a, name).cpu(), getattr(b, name)
            errs[f"{tag}_{name}_scaled"] = float(
                (g - c).abs().max()) / max(1.0, float(c.abs().max()))
    # within TOL_PME_E_ULPS float32 ulps of the PME call's own energy
    e_pme = float((c_on.e_kspace - eng_c.e_corr).abs().max())
    errs["e_kspace_abs"] = float(
        (f_on.e_kspace.cpu() - c_on.e_kspace).abs().max())
    errs["e_kspace_bar"] = TOL_PME_E_ULPS * 2.0 ** (math.frexp(e_pme)[1]
                                                    - 24)
    # each replica's off-boundary λ force is its own single evaluation's,
    # on its own carried φ (the replicas' φ differ)
    single = 0.0
    for r, one in enumerate(replica.unstack_replicas(
            dataclasses.replace(batch, **off))):
        f1 = eng.compute_forces(one, kspace_impulse=True,
                                phi_recip_prev=f_on.phi_recip_s[r])
        single = max(single, float((f1.dUdlam - f_off.dUdlam[r]).abs().max())
                     / max(1.0, float(f1.dUdlam.abs().max())))
    errs["off_dUdlam_vs_single_scaled"] = single
    spread = float((f_on.phi_recip_s - f_on.phi_recip_s[:1]).abs().max())
    errs["phi_recip_spread"] = spread
    res["card_vs_cpu"] = errs
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[pme rex card vs cpu] {json.dumps(errs)}")
    if (max(v for k, v in errs.items() if k.endswith("_scaled")
            and not k.startswith("off_dUdlam_vs")) > TOL_PME_SCALED
            or errs["e_kspace_abs"] > errs["e_kspace_bar"]
            or single > TOL_F_SCALED or not spread > 0.0):
        raise RuntimeError(f"the batched PME evaluation failed its checks "
                           f"({errs})")
    return res


# the reference engine on the PME path's system: factorized Ewald at the
# PME path's α, accuracy 1e-5 (Mx 20, My = Mz 39 on the 64 Å box);
# 10-step blocks, a list build at each block start. The path continues
# the PME production state from λ LAMBDA_START (interior_lambda), with the
# λ thermostat and walls of the tiled production it continues
# (LAMBDA_2FS): from λ 1 at the EngineConfig defaults (γ_λ 0.005 /fs,
# walls −0.5 and 1.5) its blocks ran to 2.8e13 K on the H100
REF_EWALD = dict(alpha=0.30, accuracy=1e-5)
REF_BLOCK = 10
REF_LANGEVIN = dict(dt=2.0, thermostat="langevin", T=300.0,
                    lambda_thermostat="langevin", rebuild_every=REF_BLOCK,
                    **LAMBDA_2FS)
# γ of the reference path's blocks (1/fs): FIRE drops the potential
# energy below its 300 K value while the velocities stay, so at the
# production γ 0.002 the measured blocks would run far below 250 K;
# 0.05 hands the energy back within ~10 fs (see PERF.md §4)
REF_GAMMA = 0.05
# tiled PME against tiled Ewald at the 24,001-atom production state:
# |Δe_kspace| bar in kcal/mol, set in PERF.md before the first chip run.
# A CPU rehearsal of this script at 3,001 atoms (n_side 10, the same
# 1.33 Å mesh spacing, Ewald at 1e-5) read 0.27 kcal/mol; scaled by N to
# 24,001 atoms that is 2.1 (by √N, 0.75). A wrong mesh, spline or k-space
# term is off by hundreds
TOL_PME_EWALD_E = 10.0


def tiled_forces_to_atoms(ts, st, fw, fs):
    """Tile force arrays (3, G, 3W) and (Ns, 3) → (N, 3) in atom order, on
    the tiles' device (host index arithmetic; run boundaries only)."""
    import numpy as np
    import torch

    dev = fw.device
    c, s = np.nonzero(st.wvalid.cpu().numpy() > 0.5)
    m = st.wid.cpu().numpy()[c, s]
    f = torch.zeros((ts.n_atoms, 3), dtype=fw.dtype, device=dev)
    cols = torch.as_tensor(c, device=dev)
    for a in range(3):
        ids = torch.as_tensor(ts.water_atom_ids[m, a], device=dev)
        f[ids] = fw[:, cols, torch.as_tensor(3 * s + a, device=dev)].T
    f[torch.as_tensor(ts.solute_ids, device=dev)] = fs[:len(ts.solute_ids)]
    return f


def in_atom_order(system, ts, st):
    """``system`` (an md_path's build: bench.py's solvated_acid call) with
    the tiled state ``st`` mapped to atom order as its state."""
    import dataclasses

    from constant_ph_tpu_torch.tiled.layout import to_canonical

    return dataclasses.replace(system, state=to_canonical(ts, st))


def reference_path(system, ts, st, n_fire=200, n_warm=2, n_meas=5):
    """The reference engine (Engine, padded neighbour lists, pair_forces,
    factorized Ewald) on the PME main path's system and production state:
    the list's build time and peak memory, one Ewald call, FIRE, then
    warm-up and measured Langevin blocks, sync-free. Gates: no overflow,
    finite h_conserved, T in 250–350 K, no host sync in a block, and no
    launch of K1 or K2 (the path has neither). Readings: the largest
    displacement at each block boundary (kept on the device, read after
    the run), the blocks that ended past skin/2, and the gap between the
    final forces from the carried list and from a fresh build. Returns
    the engine, system, final state and list, and the numbers."""
    import dataclasses

    import torch

    from constant_ph_tpu_torch import units
    from constant_ph_tpu_torch.engine import EngineConfig
    from constant_ph_tpu_torch.minimize import fire_minimize
    from constant_ph_tpu_torch.neighbors import max_displacement2
    from constant_ph_tpu_torch.ops.ewald import (
        ewald_recip, make_ewald_params, make_kspace_fn)
    from constant_ph_tpu_torch.profiling import cuda_ms

    t_phase = time.perf_counter()
    sys_ = in_atom_order(system, ts, st)
    box = sys_.state.box
    ep = make_ewald_params(box.cpu().numpy(), REF_EWALD["alpha"],
                           accuracy=REF_EWALD["accuracy"],
                           device=box.device)
    cfg = EngineConfig(gamma=REF_GAMMA, seed=4, **REF_LANGEVIN)
    eng = sys_.make_engine(cfg, kspace_fn=make_kspace_fn(ep))
    nbp = eng.nbr_params
    n = int(sys_.state.x.shape[0])
    build = dict(atoms=n, K=nbp.capacity, grid=list(nbp.grid),
                 cell_capacity=nbp.cell_capacity,
                 stencil_cells=len(nbp.stencil), skin=nbp.skin,
                 ewald_M=[int(ep.kx.shape[0]), int(ep.ky.shape[0]),
                          int(ep.kz.shape[0])])
    log(f"[reference build] {json.dumps(build)}")

    # the list build and one Ewald call: time and peak memory
    x = sys_.state.x
    q = eng.charges(sys_.state.lam)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eng.build_neighbors(x, box)
    torch.cuda.synchronize()
    nbr_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    ewald_recip(x, q, ep)
    torch.cuda.synchronize()
    ewald_peak = torch.cuda.max_memory_allocated() - base
    parts = dict(
        nbr_build_ms=cuda_ms(lambda: eng.build_neighbors(x, box), 5),
        nbr_peak_gib=nbr_peak / 2**30,
        ewald_ms=cuda_ms(lambda: ewald_recip(x, q, ep), 10),
        ewald_peak_gib=ewald_peak / 2**30)
    log(f"[reference parts] {json.dumps(parts)}")

    # -- the path: counts zeroed just before, read just after --------------
    zero_counts()
    t0 = time.perf_counter()
    state, e_hist = fire_minimize(eng, sys_.state, n_fire)
    torch.cuda.synchronize()
    log(f"[reference minimize] {n_fire} FIRE steps: E "
        f"{float(e_hist[0]):.1f} -> {float(e_hist[-1]):.1f} kcal/mol in "
        f"{time.perf_counter() - t0:.1f} s")
    run = eng.make_run(REF_BLOCK)
    nbr = eng.build_neighbors(state.x, state.box)
    for _ in range(n_warm):
        state, nbr, obs = run(state, nbr)
    torch.cuda.synchronize()
    d2_start, d2_end, ovs, rows = [], [], [], []
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    for _ in range(n_meas):
        d2_start.append(max_displacement2(nbr, state.x, state.box))
        state, nbr, obs = run(state, nbr)
        d2_end.append(max_displacement2(nbr, state.x, state.box))
        ovs.append(nbr.overflow)
        rows.append(obs)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    # -------------------------------------------------------------------

    half2 = (0.5 * nbp.skin) ** 2
    d_end = torch.sqrt(torch.stack(d2_end)).cpu().tolist()
    temp = torch.cat([o.temp for o in rows])
    h = torch.cat([o.h_conserved for o in rows])
    # the final forces from the carried list and from a fresh build
    f_c = eng.compute_forces(state.x, state.lam, state.box, state.pH, nbr)
    f_f = eng.compute_forces(state.x, state.lam, state.box, state.pH,
                             eng.build_neighbors(state.x, state.box))
    n_steps = n_meas * REF_BLOCK
    ms_step = wall / n_steps * 1e3
    res = dict(
        ms_per_step=ms_step,
        ns_per_day=cfg.dt / units.FS_PER_NS * 86400.0 / (ms_step * 1e-3),
        steps=n_steps, T_mean=float(temp.mean()), T_min=float(temp.min()),
        T_max=float(temp.max()),
        overflow=bool(torch.stack(ovs).any()),
        h_conserved_finite=bool(torch.isfinite(h).all()),
        rebuilds=int((torch.stack(d2_start) > half2).sum()),
        blocks_past_half_skin=int((torch.stack(d2_end) > half2).sum()),
        max_displacement_at_block_end=d_end,
        half_skin=0.5 * nbp.skin,
        carried_vs_fresh_f_scaled=float(torch.abs(f_c.f - f_f.f).max())
        / float(torch.abs(f_f.f).max()),
        carried_vs_fresh_e_pot=float(f_c.e_pot - f_f.e_pot),
        lam_final=float(state.lam[0]), counts=counts)
    log(f"[reference production] {json.dumps(res)}")
    if counts != {"ww_pair": 0, "ww_tally": 0}:
        raise RuntimeError("the reference path launched a tile kernel")
    if res["overflow"] or not res["h_conserved_finite"]:
        raise RuntimeError("reference production overflowed or went "
                           "non-finite")
    if not 250.0 < res["T_mean"] < 350.0:
        raise RuntimeError(f"reference production temperature "
                           f"{res['T_mean']} K")
    log(f"[reference phase] {time.perf_counter() - t_phase:.1f} s")
    return dict(eng=eng, sys=dataclasses.replace(sys_, state=state),
                nbr=nbr, ep=ep, cfg=cfg, result=res, parts=parts)


def tiled_vs_reference(dsf, pme, ep):
    """Both engines' forces in atom order on the production states:
    the DSF path's (the bars of tests/test_tiled.py:56), and the PME
    path's with the tiled engine on Ewald against the reference engine +
    Ewald (tests/test_tiled.py:152) and tiled PME against tiled Ewald
    (tests/test_tiled.py:258, the e_kspace bar TOL_PME_EWALD_E)."""
    import dataclasses

    import torch

    from constant_ph_tpu_torch.engine import EngineConfig
    from constant_ph_tpu_torch.ops.ewald import make_kspace_fn
    from constant_ph_tpu_torch.tiled.engine import TiledEngine

    def rel(a, b):
        return abs(float(a) - float(b)) / abs(float(b))

    def rel_close(a, b, rtol, atol):
        return (torch.abs(a - b) <= atol + rtol * torch.abs(b)).all()

    t_phase = time.perf_counter()
    out = {}
    # DSF production state
    ts, st = dsf["ts"], dsf["st"]
    sys_ = in_atom_order(dsf["system"], ts, st)
    ref = sys_.make_engine(EngineConfig(**REF_LANGEVIN))
    s0 = sys_.state
    nbr = ref.build_neighbors(s0.x, s0.box)
    rf = ref.compute_forces(s0.x, s0.lam, s0.box, s0.pH, nbr)
    tf = TiledEngine(ts, dsf["cfg"]).compute_forces(st)
    f_t = tiled_forces_to_atoms(ts, st, tf.fw, tf.fs)
    scale = float(torch.abs(rf.f).max())
    d = dict(f_scaled=float(torch.abs(f_t - rf.f).max()) / scale,
             e_lj_rel=rel(tf.e_lj, rf.e_lj),
             e_coul_rel=rel(tf.e_coul, rf.e_coul),
             dUdlam=[float(tf.dUdlam[0]), float(rf.dUdlam[0])],
             overflow=bool(nbr.overflow))
    ok = (d["f_scaled"] <= 3e-5 and d["e_lj_rel"] <= 2e-4
          and d["e_coul_rel"] <= 2e-4 and not d["overflow"]
          and bool(rel_close(tf.dUdlam, rf.dUdlam, 5e-4, 5e-3))
          and bool(rel_close(tf.f_lam, rf.f_lam, 5e-4, 5e-3)))
    out["dsf"] = d
    log(f"[tiled vs reference dsf] {json.dumps(d)}")
    if not ok:
        raise RuntimeError(f"tiled and reference engines disagree on the "
                           f"DSF production state ({d})")

    # PME production state: tiled Ewald against reference + Ewald
    ts, st = pme["ts"], pme["st"]
    cfg1 = dataclasses.replace(pme["cfg"], kspace_every=1)
    sys_ = in_atom_order(pme["system"], ts, st)
    ref = sys_.make_engine(EngineConfig(**REF_LANGEVIN),
                           kspace_fn=make_kspace_fn(ep))
    s0 = sys_.state
    nbr = ref.build_neighbors(s0.x, s0.box)
    rf = ref.compute_forces(s0.x, s0.lam, s0.box, s0.pH, nbr)
    eng_ew = TiledEngine(ts, cfg1, kspace_ep=ep)
    tf = eng_ew.compute_forces(st)
    f_t = tiled_forces_to_atoms(ts, st, tf.fw, tf.fs)
    scale = float(torch.abs(rf.f).max())
    sol = torch.as_tensor(ts.solute_ids, device=rf.f.device)
    wat = torch.as_tensor(ts.water_atom_ids, device=rf.f.device)
    # the reference adds the intra-water erf forces, which act along the
    # bonds of the rigid waters (the tiled path's e_corr replaces them):
    # the solute atoms and each water molecule's net force are free of them
    d = dict(coul_total=[float(tf.e_coul + tf.e_kspace),
                         float(rf.e_coul + rf.e_kspace)],
             coul_total_rel=rel(tf.e_coul + tf.e_kspace,
                                rf.e_coul + rf.e_kspace),
             solute_f_scaled=float(torch.abs(f_t[sol] - rf.f[sol]).max())
             / scale,
             water_net_f_scaled=float(torch.abs(
                 f_t[wat].sum(1) - rf.f[wat].sum(1)).max()) / scale,
             water_O_f_scaled=float(torch.abs(
                 f_t[wat[:, 0]] - rf.f[wat[:, 0]]).max()) / scale,
             dUdlam=[float(tf.dUdlam[0]), float(rf.dUdlam[0])],
             overflow=bool(nbr.overflow))
    ok = (d["coul_total_rel"] <= 3e-3 and d["solute_f_scaled"] <= 2e-4
          and d["water_net_f_scaled"] <= 2e-4 and not d["overflow"]
          and bool(rel_close(tf.dUdlam, rf.dUdlam, 1e-3, 1e-2)))
    out["ewald"] = d
    log(f"[tiled vs reference ewald] {json.dumps(d)}")
    if not ok:
        raise RuntimeError(f"tiled Ewald and reference + Ewald disagree on "
                           f"the PME production state ({d})")

    # same state: tiled PME against tiled Ewald
    tp = TiledEngine(ts, cfg1, kspace_ep=pme["pme"]).compute_forces(st)
    vm = torch.repeat_interleave(st.wvalid, 3, dim=-1)[None]
    scale = float(torch.abs(tf.fw).max())
    d = dict(e_kspace=[float(tp.e_kspace), float(tf.e_kspace)],
             e_kspace_abs=abs(float(tp.e_kspace) - float(tf.e_kspace)),
             fw_scaled=float(torch.abs((tp.fw - tf.fw) * vm).max()) / scale,
             fs_scaled=float(torch.abs(tp.fs - tf.fs).max()) / scale,
             dUdlam=[float(tp.dUdlam[0]), float(tf.dUdlam[0])])
    ok = (d["e_kspace_abs"] <= TOL_PME_EWALD_E and d["fw_scaled"] <= 5e-4
          and d["fs_scaled"] <= 5e-4
          and bool(rel_close(tp.dUdlam, tf.dUdlam, 2e-3, 1e-2)))
    out["pme_vs_ewald"] = d
    log(f"[tiled pme vs ewald] {json.dumps(d)}")
    if not ok:
        raise RuntimeError(f"tiled PME and tiled Ewald disagree ({d})")
    log(f"[tiled vs reference phase] {time.perf_counter() - t_phase:.1f} s")
    return out


def ewald_tiled_path(ts, st, cfg, ep, n_warm=2, n_meas=5):
    """The PME production state on TiledEngine(kspace_ep=EwaldParams,
    kspace_every=2): warm-up and measured sync-free blocks (K1 on every
    force evaluation, Ewald on MTS boundary steps only: its calls are
    counted), then compute_Hs on the Ewald engine with use_pallas_ww=True
    (K2 once) and the tally sum rule, k-space included."""
    import dataclasses

    import torch

    from constant_ph_tpu_torch import units
    from constant_ph_tpu_torch.tiled import engine as tengine
    from constant_ph_tpu_torch.tiled.engine import TiledEngine

    t_phase = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, kspace_every=2, seed=5)
    eng = TiledEngine(ts, cfg2, kspace_ep=ep)
    block = cfg2.rebuild_every
    run_block = eng.make_run(block)
    ewald_sets = tengine.ewald_recip_sets
    calls = [0]

    def counted(*args, **kw):
        calls[0] += 1
        return ewald_sets(*args, **kw)

    # evaluations on MTS boundaries: the block start at its step counter,
    # then one after each step
    steps = [st.step_host + b * block + k
             for b in range(n_warm + n_meas) for k in range(block + 1)]
    want_calls = sum(1 for s in steps if s % 2 == 0)
    tengine.ewald_recip_sets = counted
    try:
        # -- the path: counts zeroed just before, read just after ----------
        zero_counts()
        for _ in range(n_warm):
            st, ov, obs = run_block(st)
        torch.cuda.synchronize()
        rows, ov_any = [], ov
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
        # ---------------------------------------------------------------
    finally:
        tengine.ewald_recip_sets = ewald_sets
    n_steps = n_meas * block
    ms_step = wall / n_steps * 1e3
    temp = torch.cat([o.temp for o in rows])
    e_k = torch.cat([o.e_kspace.reshape(-1) for o in rows])
    h_valid = torch.cat([o.h_valid.reshape(-1) for o in rows])
    res = dict(
        ms_per_step=ms_step,
        ns_per_day=cfg2.dt / units.FS_PER_NS * 86400.0 / (ms_step * 1e-3),
        steps=n_steps, T_mean=float(temp.mean()), overflow=bool(ov_any),
        h_conserved_finite=bool(torch.isfinite(
            torch.cat([o.h_conserved for o in rows])).all()),
        ewald_calls=calls[0], ewald_calls_expected=want_calls,
        kspace_rows=int((e_k != 0).sum()), h_valid_rows=int(h_valid.sum()))
    expected = (n_warm + n_meas) * (block + 1)
    log(f"[ewald production] {json.dumps(res)}")
    log(f"[ewald launches] {json.dumps(counts)}, force evaluations "
        f"{expected}")
    if counts != {"ww_pair": expected, "ww_tally": 0}:
        raise RuntimeError("the tiled Ewald path did not run every force "
                           "evaluation through the CUDA kernel K1")
    if (calls[0] != want_calls or not torch.equal(e_k != 0, h_valid)
            or res["h_valid_rows"] != n_steps // 2):
        raise RuntimeError(f"Ewald ran on other steps than the MTS "
                           f"boundaries ({res})")
    if res["overflow"] or not res["h_conserved_finite"] or not (
            250.0 < res["T_mean"] < 350.0):
        raise RuntimeError(f"tiled Ewald production failed its checks "
                           f"({res})")

    # compute_Hs on the Ewald engine with K2
    eng_t = TiledEngine(ts, dataclasses.replace(cfg2, kspace_every=1),
                        kspace_ep=ep, use_pallas_ww=True)
    zero_counts()
    frc = eng_t.compute_forces(st, need_tally=True)
    HA, HB = eng_t.compute_Hs(st, frc)
    torch.cuda.synchronize()
    tally_counts = read_counts()
    want = float(frc.e_lj + frc.e_coul + frc.e_bonded + frc.e_kspace
                 - eng_t.e_corr)
    hs = dict(HA=float(HA), HB=float(HB), e_sum=want,
              rel_err=abs(float(HA) - want) / abs(want),
              e_kspace=float(frc.e_kspace), counts=tally_counts)
    log(f"[ewald compute_Hs] {json.dumps(hs)}")
    if tally_counts != {"ww_pair": 0, "ww_tally": 1}:
        raise RuntimeError("compute_Hs with Ewald did not run K2 once")
    if hs["rel_err"] > 1e-3:
        raise RuntimeError(f"Ewald compute_Hs sum rule fails ({hs})")
    log(f"[ewald phase] {time.perf_counter() - t_phase:.1f} s")
    return dict(counts=counts, tally_counts=tally_counts, result=res, hs=hs)


class _RefProbe:
    """Records, while active, the batch size of every call of a run that
    Engine.make_run returns and of every neighbour-list build the
    reference engine makes (1 for a single state)."""

    def __enter__(self):
        from constant_ph_tpu_torch import engine as engine_mod

        self.runs = runs = []
        self.builds = builds = []
        self._mod = engine_mod
        self._make_run = make_run = engine_mod.Engine.make_run
        self._build = build = engine_mod.build_neighbor_list

        def counted_make_run(eng, n_steps):
            run = make_run(eng, n_steps)

            def counted(state, nbr, generators=None):
                runs.append(int(state.x.shape[0]) if state.x.ndim == 3
                            else 1)
                return run(state, nbr, generators)
            return counted

        def counted_build(x, *args):
            builds.append(int(x.shape[0]) if x.ndim == 3 else 1)
            return build(x, *args)

        engine_mod.Engine.make_run = counted_make_run
        engine_mod.build_neighbor_list = counted_build
        return self

    def __exit__(self, *exc):
        self._mod.Engine.make_run = self._make_run
        self._mod.build_neighbor_list = self._build


def _ref_batch_vs_looped(eng, batch, nbrs, seeds, steps, sync):
    """One run of the reference replicas as the batch and one by one
    from the same state with generators of the same seeds: λ, positions
    and h_conserved within TOL_BATCH_LOOP, and each form's ms per
    walker-step (host clock, synchronised)."""
    from constant_ph_tpu_torch.parallel import replica

    run = eng.make_run(steps)
    dev = batch.x.device
    R = batch.x.shape[0]
    sync()
    t0 = time.perf_counter()
    got, _, obs = run(batch, nbrs, replica.replica_generators(seeds, dev))
    sync()
    t_batch = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = [run(st, nb, g) for st, nb, g in zip(
        replica.unstack_replicas(batch), replica.unstack_replicas(nbrs),
        replica.replica_generators(seeds, dev))]
    sync()
    t_loop = time.perf_counter() - t0
    diff = dict(lam=0.0, x=0.0, h_rel=0.0)
    for r, (st, _, o) in enumerate(outs):
        diff["lam"] = max(diff["lam"], float((obs.lam[r] - o.lam).abs().max()))
        diff["x"] = max(diff["x"], float((got.x[r] - st.x).abs().max()))
        diff["h_rel"] = max(diff["h_rel"], float(
            (obs.h_conserved[r] - o.h_conserved).abs().max()
            / o.h_conserved.abs().max()))
    return dict(batched_ms_per_walker_step=t_batch / (R * steps) * 1e3,
                looped_ms_per_walker_step=t_loop / (R * steps) * 1e3,
                batched_ms_per_step=t_batch / steps * 1e3,
                max_diff=diff, bars=TOL_BATCH_LOOP)


def reference_campaign(ref, phs=None, rex_steps=20, ti=(5, 10),
                       n_min=50, dev="cuda"):
    """The campaign tools on the reference engine, cut in depth, on the
    reference path's system and Ewald. (a) make_rex_runner on R = 4
    replicas of the final 24,001-atom state at PME_REX_PHS (the JAX
    package's __graft_entry__ replica leg at full width, the pH rungs of
    the PME REX leg) as one batch: one REX block under sync-debug "error"
    with its run calls and list builds counted (one run call for all R,
    one build a rebuild_every block for the batch; no tile kernel), the
    list build's peak memory at R = 4, then one run of the replicas
    batched and looped from one state with generators of the same seeds
    (deltas within TOL_BATCH_LOOP) and one batched block under the
    profiler (device busy ms of a batched step); gates:
    finite, no overflow, the pH multiset kept. (b) calibrate_dG_ref (7
    nodes × ti steps after n_min FIRE steps; the result finite)."""
    import dataclasses

    import torch

    from constant_ph_tpu_torch.ops.ewald import make_kspace_fn
    from constant_ph_tpu_torch.parallel import replica
    from constant_ph_tpu_torch.profiling import profile_block
    from constant_ph_tpu_torch.titration import calibrate_dG_ref

    phs = PME_REX_PHS if phs is None else phs
    cuda = dev == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t_phase = time.perf_counter()
    eng, state = ref["eng"], ref["sys"].state
    R = len(phs)
    batch = replica.stack_replicas([
        dataclasses.replace(state, pH=torch.full_like(state.pH, ph))
        for ph in phs])
    # the list build of the R replicas in one pass: its peak memory
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if cuda else 0
    t0 = time.perf_counter()
    nbrs = eng.build_neighbors(batch.x, batch.box)
    sync()
    t_build = time.perf_counter() - t0
    build_peak = ((torch.cuda.max_memory_allocated() - base) / 2**30
                  if cuda else 0.0)
    total = (torch.cuda.get_device_properties(0).total_memory / 2**30
             if cuda else 0.0)
    resident = torch.cuda.memory_allocated() / 2**30 if cuda else 0.0
    gen = torch.Generator(device=state.x.device).manual_seed(9)

    # -- (a) one REX block of the batch: counts zeroed just before ---------
    with _RefProbe() as probe:
        block = replica.make_rex_runner(eng, rex_steps)
        # the generators the runner makes at its first call, made here,
        # outside the sync-free block
        block.generators = replica.replica_generators(
            [replica._fold_in(eng.cfg.seed, r) for r in range(R)],
            state.x.device)
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.set_sync_debug_mode("error")
        zero_counts()
        t0 = time.perf_counter()
        out, nbrs_out, gen, acc, last = block(batch, nbrs, gen, 0)
        if cuda:
            torch.cuda.set_sync_debug_mode("default")
        sync()
        t_block = time.perf_counter() - t0
        counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    n_blocks = -(-rex_steps // eng.cfg.rebuild_every)
    cmp = _ref_batch_vs_looped(eng, batch, nbrs,
                               [5000 + r for r in range(R)], rex_steps,
                               sync)
    # one batched block under the profiler
    run_block = eng.make_run(eng.cfg.rebuild_every)
    gens = replica.replica_generators([6000 + r for r in range(R)],
                                      state.x.device)
    if cuda:
        _, bp = profile_block(lambda b: run_block(b, nbrs_out, gens), out,
                              eng.cfg.rebuild_every)
        busy = bp.busy_ms_per_step
    else:
        busy = float("nan")
    rex = dict(
        R=R, atoms=int(state.x.shape[0]), steps=rex_steps, pH=phs,
        pH_after=out.pH.tolist(), accepted=acc.tolist(),
        T=last.temp.tolist(),
        finite=bool(replica.replica_finite(out).all()),
        overflow=bool(nbrs_out.overflow.any()),
        run_calls=probe.runs, list_builds=probe.builds,
        builds_expected=n_blocks, counts=counts,
        block_ms_per_walker_step=t_block / (R * rex_steps) * 1e3,
        batched_ms_per_walker_step=cmp["batched_ms_per_walker_step"],
        looped_ms_per_walker_step=cmp["looped_ms_per_walker_step"],
        device_busy_ms_per_step=busy,
        build_s=t_build, build_peak_gib=build_peak,
        build_peak_gib_per_replica=build_peak / R,
        block_peak_gib=peak, resident_gib=resident, card_gib=total,
        # the replicas a list build could take beside what is resident
        r_max_build=(int((total - resident) / (build_peak / R))
                     if build_peak > 0 else None),
        max_diff=cmp["max_diff"], bars=TOL_BATCH_LOOP,
        card=gpu_name_and_power() if cuda else None)
    log(f"[reference rex batch] {json.dumps(rex)}")
    if (sorted(rex["pH_after"]) != sorted(phs) or not rex["finite"]
            or rex["overflow"]):
        raise RuntimeError(f"reference replica exchange failed ({rex})")
    if probe.runs != [R] or probe.builds != [R] * n_blocks:
        raise RuntimeError(f"the reference REX block made run calls "
                           f"{probe.runs} and builds {probe.builds}, not "
                           f"one batched run and {n_blocks} batched builds")
    if counts != {"ww_pair": 0, "ww_tally": 0}:
        raise RuntimeError("the reference REX block launched a tile kernel")
    if any(cmp["max_diff"][k] > TOL_BATCH_LOOP[k] for k in TOL_BATCH_LOOP):
        raise RuntimeError(f"the batched reference run left the looped "
                           f"one ({rex})")
    t0 = time.perf_counter()
    dG = calibrate_dG_ref(ref["sys"], ref["cfg"],
                          kspace_fn=make_kspace_fn(ref["ep"]),
                          equil_steps=ti[0], sample_steps=ti[1],
                          minimize_steps=n_min)
    cal = dict(dG_ref=dG, nodes=7, steps_a_node=list(ti),
               minimize_steps=n_min, seconds=time.perf_counter() - t0)
    log(f"[reference calibrate] {json.dumps(cal)}")
    if not math.isfinite(dG):
        raise RuntimeError(f"calibrate_dG_ref gave {dG}")
    log(f"[reference campaign phase] {time.perf_counter() - t_phase:.1f} s")
    return dict(rex=rex, calibrate=cal)


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


# the campaign's walkers as one batch against the same walkers run one by
# one, one 12-step block from one state with generators of the same
# seeds: both draw the same noise and differ only in the order of the
# batch's sums (fixed before the first reading on the card; CPU runs of
# the acid box agree bit for bit, and a CPU rehearsal of this block on a
# 2,100-atom polypeptide read λ 7.5e-9, positions 1.05e-5 Å and
# h_conserved 2.87e-5 of its |max| ~1e3 kcal/mol: float32 sums in
# another order, of terms that do not shrink with h). A walker fed
# another walker's noise moves ~1e-2 Å and its λ ~1e-2 in such a block
TOL_BATCH_LOOP = dict(lam=1e-4, x=1e-3, h_rel=1e-4)
# the production driver's default --replicas 9: pH 3.0–7.0 in 0.5 steps,
# one walker a pH
CAMPAIGN_R9_PHS = tuple(3.0 + 0.5 * k for k in range(9))


def _batch_vs_looped(eng, batch, seeds, block, sync):
    """One block of the walkers as the batch and one by one (the port's
    loop before replicas were a batch), from the same state with
    generators of the same seeds: λ, positions and h_conserved within
    TOL_BATCH_LOOP, and each form's ms per walker-step (host clock)."""
    from constant_ph_tpu_torch.parallel import replica

    run = eng.make_run(block)
    dev = batch.lam.device
    R = batch.lam.shape[0]
    sync()
    t0 = time.perf_counter()
    got, _, obs = run(batch, replica.replica_generators(seeds, dev))
    sync()
    t_batch = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = [run(st, g) for st, g in zip(
        replica.unstack_replicas(batch),
        replica.replica_generators(seeds, dev))]
    sync()
    t_loop = time.perf_counter() - t0
    diff = dict(lam=0.0, x=0.0, h_rel=0.0)
    for r, (st, _, o) in enumerate(outs):
        diff["lam"] = max(diff["lam"], float((obs.lam[r] - o.lam).abs().max()))
        diff["x"] = max(diff["x"], float((got.wx[r] - st.wx).abs().max()),
                        float((got.sx[r] - st.sx).abs().max()))
        diff["h_rel"] = max(diff["h_rel"], float(
            (obs.h_conserved[r] - o.h_conserved).abs().max()
            / o.h_conserved.abs().max()))
    res = dict(R=R, steps=block, max_diff=diff, bars=TOL_BATCH_LOOP,
               batched_ms_per_walker_step=t_batch / (R * block) * 1e3,
               looped_ms_per_walker_step=t_loop / (R * block) * 1e3,
               batched_ms_per_step=t_batch / block * 1e3)
    log(f"[campaign batched vs looped] {json.dumps(res)}")
    if any(diff[k] > TOL_BATCH_LOOP[k] for k in diff):
        raise RuntimeError(f"the batched block left the looped one ({res})")
    return res


def _campaign_r9(eng, batch, mp, chunk, block, sync, dev):
    """One measured chunk of R = 9 walkers (CAMPAIGN_R9_PHS, one a pH,
    zeroed frozen tables, λ in the basin HH favours) on the campaign's
    relaxed positions, after a one-block warm-up: ms per walker-step,
    peak GiB, K1 launches = batched force evaluations, no overflow, T
    in 250–350 K; then a block of the nine under the profiler."""
    import dataclasses

    import torch

    from constant_ph_tpu_torch import metad
    from constant_ph_tpu_torch.parallel import replica

    base = replica.unstack_replicas(batch)
    V0, dV0 = metad.init_tables(batch.lam.shape[-1], mp,
                                device=batch.lam.device)
    pK = eng.ts.spec.pK
    walkers = [dataclasses.replace(
        base[k % len(base)], pH=torch.full_like(base[0].pH, ph),
        lam=torch.where(pK > ph, 0.05, 0.95).to(base[0].lam.dtype),
        v_lam=torch.zeros_like(base[0].v_lam), metad_v=V0, metad_dv=dV0)
        for k, ph in enumerate(CAMPAIGN_R9_PHS)]
    R = len(walkers)
    b9 = replica.stack_replicas(walkers)
    gens = replica.replica_generators([3000 + k for k in range(R)],
                                      batch.lam.device)
    one, run = eng.make_run(block), eng.make_run(chunk)
    b9 = one(b9, gens)[0]
    sync()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.set_sync_debug_mode("error")
    zero_counts()
    t0 = time.perf_counter()
    b9, ov, obs = run(b9, gens)
    if dev == "cuda":
        torch.cuda.set_sync_debug_mode("default")
    sync()
    wall = time.perf_counter() - t0
    counts = read_counts()
    evals = -(-chunk // block) * (block + 1)
    res = dict(R=R, pH=list(CAMPAIGN_R9_PHS), steps=chunk,
               ms_per_walker_step=wall / (R * chunk) * 1e3,
               ms_per_step=wall / chunk * 1e3,
               peak_memory_gib=(torch.cuda.max_memory_allocated() / 2**30
                                if dev == "cuda" else None),
               launches=counts, force_evaluations=evals,
               T_mean=float(obs.temp.mean()), overflow=bool(ov.any()),
               h_conserved_finite=bool(torch.isfinite(obs.h_conserved).all()))
    log(f"[campaign R9] {json.dumps(res)}")
    if counts != {"ww_pair": evals, "ww_tally": 0}:
        raise RuntimeError("the R = 9 chunk did not run each batched force "
                           "evaluation through one K1 launch")
    if (res["overflow"] or not res["h_conserved_finite"]
            or not 250.0 < res["T_mean"] < 350.0):
        raise RuntimeError(f"the R = 9 chunk failed its checks ({res})")
    if dev == "cuda":
        _, res["profile"] = profile_block(
            lambda s: one(s, gens), b9, res["ms_per_step"], block,
            label=f"campaign profile R{R}")
    return res


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
    rolled back; (e) the estimators. The walkers run as one batch (one
    run call, one K1 launch a force evaluation). Counts are zeroed just
    before the path and read just after; the run blocks never
    synchronise. Then the batched-vs-looped block and the R = 9 chunk. The
    relaxation is the PME path's (a 200 + 96-step one left the
    production box above the T gate; with 600 steps the PME path's
    production tripped the drift flag). Smaller ``build`` / depths only
    serve a rehearsal on the CPU. Returns the numbers."""
    import dataclasses
    import math

    import numpy as np
    import torch

    from constant_ph_tpu_torch import metad, titration
    from constant_ph_tpu_torch.engine import EngineConfig
    from constant_ph_tpu_torch.lambda_dyn import BiasParams
    from constant_ph_tpu_torch.parallel import replica
    from constant_ph_tpu_torch.profiling import cuda_ms
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
    # the walkers are one batch: every run call below moves all of them
    # with one sequence of launches (K1 once a force evaluation)
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
        batch, ov, obs = run(batch, gens)                    # (R, T, …)
        evals += runs
        ovs.append(ov)
        rows.append(obs)
        lam_tr = obs.lam[:, mp.stride - 1::mp.stride]        # (R, K, S)
        K = lam_tr.shape[1]
        seq = lam_tr.reshape(G, wpp, K, S).transpose(1, 2).reshape(
            G, K * wpp, S)
        Vg = batch.metad_v.reshape(G, wpp, S, mp.nbins)[:, 0]
        dVg = batch.metad_dv.reshape(G, wpp, S, mp.nbins)[:, 0]
        if not merges:          # the mesh merge phase's inputs: the
            # rungs' tables and each walker's snapshots (G, wpp, K, S)
            merge_in = dict(V=Vg.clone(), dV=dVg.clone(),
                            seq=lam_tr.reshape(G, wpp, K, S).clone(),
                            mp=dataclasses.asdict(mp))
        new = [metad.deposit_many(Vg[g], dVg[g], seq[g], mp)
               for g in range(G)]
        batch = dataclasses.replace(
            batch,
            metad_v=torch.stack([v for v, _ in new]).repeat_interleave(
                wpp, dim=0),
            metad_dv=torch.stack([d for _, d in new]).repeat_interleave(
                wpp, dim=0))
        merges.append((Vg, seq, batch.metad_v))
    # (b) in-run deposits: a walker per rung, the three as one batch, one
    # chunk in calls of one block, so each call's booked ΔV is its final
    # ext_work minus the ext_work of its last step
    dep = dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name)[::wpp]
        for f in dataclasses.fields(batch)
        if isinstance(getattr(batch, f.name), torch.Tensor)})
    dep_gens = gens[::wpp]
    booked = []
    for _ in range(-(-chunk // block)):
        v0, dv0 = dep.metad_v, dep.metad_dv
        dep, ov, obs = run_block(dep, dep_gens)
        evals += block + 1
        ovs.append(ov)
        rows.append(obs)
        booked.append((v0, dv0, dep.metad_v, dep.metad_dv, dep.lam,
                       dep.ext_work - obs.ext_work[:, -1], dep.ext_work))
    # (c) one replica-exchange block on the six walkers; parity 1 pairs
    # walkers of neighbouring rungs
    prev = batch
    batch, _, accepted, last = rex(batch, swap_gen, 1)
    evals += block + 1
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
                overflow=bool(torch.cat(ovs).any() | ov_eq),
                h_conserved_finite=bool(torch.isfinite(h).all()),
                swaps_accepted=accepted.tolist(),
                peak_memory_gib=(torch.cuda.max_memory_allocated() / 2**30
                                 if dev == "cuda" else None))
    log(f"[campaign production] {json.dumps(prod)}")
    log(f"[campaign launches] {json.dumps(counts)}, force evaluations "
        f"{evals} (one launch a batched evaluation)")
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
        for v0, dv0, v1, dv1, lam, moved, work in booked:
            v0, dv0, v1, dv1, lam = (t[r] for t in (v0, dv0, v1, dv1, lam))
            added = _table_mass(v1, mp) - _table_mass(v0, mp)
            if float(np.abs(added).max()) > 0.0:
                hills += 1
                ratio = added / _hill_mass(lam[None], mp)
                if not (0.8 <= ratio.min() and ratio.max() <= 1.0 + 1e-4):
                    raise RuntimeError(f"in-run deposit grew the tables by "
                                       f"{ratio} of a hill")
            want = torch.sum(metad.lookup(v1, dv1, lam, mp)[0]
                             - metad.lookup(v0, dv0, lam, mp)[0])
            err = abs(float(moved[r]) - float(want))
            gates["inrun_booked_err"] = max(gates["inrun_booked_err"], err)
            ulp = float(np.spacing(np.float32(abs(float(work[r])))))
            if err > 4 * ulp + 1e-5 * abs(float(want)):
                raise RuntimeError(f"in-run deposit: ext_work moved by "
                                   f"{float(moved[r])}, ΣΔV is {float(want)} "
                                   f"(ext_work {float(work[r])})")
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

    res = dict(prod=prod, counts=counts, gates=gates, merge_in=merge_in)
    res["compare"] = _batch_vs_looped(eng, batch, seeds, block, sync)
    res["r9"] = _campaign_r9(eng, batch, mp, chunk, block, sync, dev)

    # measurements: K1 on the campaign tiles, alone and as the batch of
    # the six walkers, the solute blocks at Ns 600, and a batched block of
    # the six under the profiler
    walker = replica.unstack_replicas(batch)[0]
    if dev == "cuda":
        res["k1"] = check_ww(ts, walker, "campaign-tiles", forced=(3,))
        res["k1_batch"] = check_batches(
            ts, replica.unstack_replicas(batch), "campaign-tiles")["k1"]
        p = ts.params
        kw = dict(style=ts.coul_style, alpha=ts.alpha, rc=ts.cutoff)
        wxg = walker.wx.reshape((3,) + p.grid + (3 * p.W,))
        wxb = batch.wx.reshape((R, 3) + p.grid + (3 * p.W,))
        qs = eng.charges_solute(walker.lam)
        qb = eng.charges_solute(batch.lam)
        blocks = {}
        for name, fn in (
                ("water_solute_fast", lambda: forces.water_solute_fast(
                    wxg, walker.sx, qs, ts.solute, ts.water, p, walker.box,
                    **kw)),
                (f"water_solute_fast_R{R}", lambda: forces.water_solute_fast(
                    wxb, batch.sx, qb, ts.solute, ts.water, p, batch.box,
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
        _, res["profile"] = profile_block(
            lambda s: one(s, gens), batch,
            res["compare"]["batched_ms_per_step"], block,
            label=f"campaign profile R{R}")
    log(f"[campaign] phase {time.perf_counter() - t_phase:.1f} s")
    return res


# configs/hewl_like.json as the JAX CLI's tiled `run` drives it
# (constant_ph_tpu/cli.py:140-290): its build, the JAX builder's figures
# for it, and the cut depth (chunks of 60 steps, not 2,000)
HEWL_CONFIG = "configs/hewl_like.json"
HEWL_SHAPE = dict(atoms=20241, sites=16, grid=[4, 4, 4], W=208)
HEWL_CHUNK = 60
HEWL_CHUNKS = 4
# the relaxation the DSF and PME paths use, inserted between FIRE and
# production: from FIRE's zero velocities the config's γ 0.002 /fs warms
# the box over ~500 fs, so production would start far below 250 K
HEWL_EQ = dict(dt=0.5, thermostat="langevin", T=300.0, gamma=0.01,
               lambda_thermostat="langevin", force_cap=50.0, seed=61)
HEWL_N_EQ = 800



def _first_difference(a, b):
    """The name of the first tensor field in which two sequences of
    dataclasses (tiled states, Observables) differ, or None when they are
    equal bit for bit."""
    import dataclasses

    import torch

    for x, y in zip(a, b):
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if isinstance(u, torch.Tensor) and not torch.equal(u, v):
                return f.name
    return None


def hewl_path(dev, config=HEWL_CONFIG, shape=HEWL_SHAPE, n_min=None,
              n_eq=HEWL_N_EQ, chunk=HEWL_CHUNK):
    """configs/hewl_like.json through the port's run control, as the JAX
    CLI's tiled run drives it: build, split at the defaults, FIRE at the
    built W 208 (K1 in passes), a Langevin relaxation, then elastic_run at
    the built W in chunks of ``chunk`` steps: a DCD frame a chunk
    (to_canonical), the observables as JSONL, a checkpoint (state and
    generator) after chunk 2, and chunks 3-4 twice: (a) continued in
    memory through to_canonical → to_tiled, (b) from the checkpoint file.
    Gates: (b) equals (a) bit for bit; the DCD reads back; no molecule
    lost; T in 250–350 K after the first chunk; finite h_conserved; K1
    launches = force evaluations; no host sync inside a chunk. Then K1 and
    K2 on the production tiles at W 208 (passes) and K1 at occupancy + 6
    (one pass). Smaller ``shape`` / depths only serve a rehearsal on the
    CPU. Returns the numbers."""
    import dataclasses
    import tempfile

    import torch

    from constant_ph_tpu_torch import checkpoint, observables
    from constant_ph_tpu_torch.engine import EngineConfig
    from constant_ph_tpu_torch.lambda_dyn import BiasParams
    from constant_ph_tpu_torch.systems.protein import solvated_polypeptide
    from constant_ph_tpu_torch.tiled.elastic import (
        concat_observables, elastic_run)
    from constant_ph_tpu_torch.tiled.engine import TiledEngine
    from constant_ph_tpu_torch.tiled.layout import (
        retile_auto, split_system, to_canonical, to_tiled)
    from constant_ph_tpu_torch.trajectory import DCDWriter, read_dcd

    t_phase = t0 = time.perf_counter()
    with open(config) as fh:
        conf = json.load(fh)
    build = dict(conf["system"])
    if build.pop("builder") != "solvated_polypeptide":
        raise RuntimeError(f"{config}: not a solvated_polypeptide config")
    sys_ = solvated_polypeptide(device=dev, **build)
    ecfg = EngineConfig(**conf["engine"])
    bias = BiasParams()
    ts = split_system(sys_, device=dev)
    st = to_tiled(ts, sys_.state)
    n_atoms = int(sys_.state.x.shape[0])
    got = dict(atoms=n_atoms, sites=ts.spec.n_sites,
               grid=list(ts.params.grid), W=ts.params.W)
    log(f"[hewl build] {json.dumps(got)} (occupancy "
        f"{int(st.wvalid.sum(dim=1).max())}) in "
        f"{time.perf_counter() - t0:.1f} s")
    if shape is not None and got != shape:
        raise RuntimeError(f"hewl build {got}, expected {shape}")
    n_min = conf["run"]["minimize_steps"] if n_min is None else n_min
    every = conf["run"]["observe_every"]
    blk = ecfg.rebuild_every
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    tmp = tempfile.TemporaryDirectory()
    dcd_path = os.path.join(tmp.name, "hewl.dcd")
    ckpt_path = os.path.join(tmp.name, "hewl_ckpt.npz")
    dcd = DCDWriter(dcd_path, n_atoms, dt_fs=ecfg.dt)

    def on_chunk(done, ts_c, tst_c, obs_c):
        dcd.write_frame(to_canonical(ts_c, tst_c).x, tst_c.box)

    # -- the path: counts zeroed just before, read just after --------------
    zero_counts()
    eng = TiledEngine(ts, ecfg, bias=bias)
    t0 = time.perf_counter()
    st, e_hist = eng.make_minimize(n_min)(st)
    cfg_eq = EngineConfig(rebuild_every=blk, **HEWL_EQ)
    st, ov_eq, obs_eq = TiledEngine(ts, cfg_eq, bias=bias).make_run(n_eq)(st)
    sync()
    evals = -(-n_min // blk) * blk + -(-n_eq // blk) * (blk + 1)
    log(f"[hewl relax] {n_min} FIRE steps at W {ts.params.W}: E "
        f"{float(e_hist[0]):.1f} -> {float(e_hist[-1]):.1f} kcal/mol; "
        f"{n_eq} Langevin steps (dt 0.5, γ 0.01): T "
        f"{float(obs_eq.temp[-1]):.1f} K, overflow {bool(ov_eq)} in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=st.wx.device).manual_seed(ecfg.seed)
    kw = dict(chunk=chunk, bias=bias, check_sync=dev == "cuda")
    n_chunk = -(-chunk // blk) * (blk + 1)      # force evaluations a chunk
    sync()
    t0 = time.perf_counter()
    ts1, st1, obs1, info1 = elastic_run(ts, st, ecfg, 2 * chunk,
                                        on_chunk=on_chunk, generator=gen,
                                        **kw)
    sync()
    wall = time.perf_counter() - t0
    # the checkpoint after chunk 2, then chunks 3-4 twice
    canon = to_canonical(ts1, st1)
    checkpoint.save(ckpt_path, canon, generator=gen)
    gen_a = torch.Generator(device=st.wx.device)
    gen_a.set_state(gen.get_state())
    t0 = time.perf_counter()
    ts_a, st_a, obs_a, info_a = elastic_run(
        ts1, to_tiled(ts1, canon), ecfg, 2 * chunk, on_chunk=on_chunk,
        generator=gen_a, **kw)
    sync()
    wall += time.perf_counter() - t0
    gen_b = torch.Generator(device=st.wx.device)
    loaded = checkpoint.load(ckpt_path, device=dev, generator=gen_b)
    ts_b, st_b, obs_b, info_b = elastic_run(
        ts1, to_tiled(ts1, loaded), ecfg, 2 * chunk, generator=gen_b, **kw)
    sync()
    evals += 6 * n_chunk
    counts = read_counts()
    # -------------------------------------------------------------------
    dcd.close()

    differs = _first_difference((st_a, obs_a), (st_b, obs_b))
    frames, boxes = read_dcd(dcd_path)
    final = to_canonical(ts_a, st_a)
    obs = concat_observables([obs1, obs_a])
    jsonl = os.path.join(tmp.name, "hewl_obs.jsonl")
    with open(jsonl, "w") as fh:
        observables.write_jsonl(obs, fh, every=every)
    with open(jsonl) as fh:
        n_rows = sum(1 for _ in fh)
    temp = obs.temp[chunk:]                      # after the first chunk
    n_steps = 4 * chunk
    res = dict(
        ms_per_step=wall / n_steps * 1e3, steps=n_steps,
        T_mean=float(temp.mean()), T_min=float(temp.min()),
        T_max=float(temp.max()),
        h_conserved_finite=bool(torch.isfinite(obs.h_conserved).all()),
        waters=int(st_a.wvalid.sum()), n_waters=len(ts.water_atom_ids),
        retiles=[info1.n_retiles, info_a.n_retiles, info_b.n_retiles],
        dangerous_blocks=info1.n_dangerous_blocks + info_a.n_dangerous_blocks,
        final_W=info_a.final_W, resume_bitwise=differs is None,
        dcd_frames=int(frames.shape[0]), jsonl_rows=n_rows,
        dcd_last_frame_equal=bool(
            (frames[-1] == final.x.float().cpu().numpy()).all()))
    log(f"[hewl production] {json.dumps(res)}")
    log(f"[hewl launches] {json.dumps(counts)}, force evaluations {evals}")
    if counts != {"ww_pair": evals, "ww_tally": 0}:
        raise RuntimeError("the hewl path did not run every force "
                           "evaluation through the CUDA kernel K1")
    if differs is not None:
        raise RuntimeError(f"resume from the checkpoint file differs from "
                           f"the in-memory continuation in {differs}")
    if (res["dcd_frames"] != HEWL_CHUNKS or not res["dcd_last_frame_equal"]
            or n_rows != -(-n_steps // every)):
        raise RuntimeError(f"hewl outputs wrong ({res})")
    if res["waters"] != res["n_waters"] or not res["h_conserved_finite"]:
        raise RuntimeError(f"hewl production lost molecules or went "
                           f"non-finite ({res})")
    if not 250.0 < res["T_mean"] < 350.0:
        raise RuntimeError(f"hewl production temperature {res['T_mean']} K")

    # the kernels on the production tiles: W 208 (passes) and K1 at the
    # occupancy + 6 retile (one pass)
    out = dict(res=res, counts=counts)
    if dev == "cuda":
        out["k1"] = check_ww(ts_a, st_a, "hewl-production-tiles",
                             forced=(9,))
        out["k2"] = check_tally(ts_a, st_a, "hewl-production-tiles",
                                forced=(3,))
        occ = int(st_a.wvalid.sum(dim=1).max())
        ts_o, st_o = retile_auto(ts_a, st_a, occ)
        out["k1_occ"] = check_ww(ts_o, st_o,
                                 f"hewl-production-state-W{ts_o.params.W}")
    tmp.cleanup()
    log(f"[hewl] phase {time.perf_counter() - t_phase:.1f} s")
    return out


# FIRE cut to 100 steps: the CLI's runs gate on finite output, not on a
# temperature
CLI_HEWL = dict(n_min=100, steps=120, every=60, restart_steps=60)
GLU_CONFIG = "configs/glu_water.json"
DECK_TYPES = [6, 7]          # hewl's water O and H types, 1-based
# the reference engine's force parity of a deck-built system against its
# builder's, as tests/test_data_roundtrip.py:65-102 holds them
DECK_TOL = dict(x=1e-6, q0=1e-6, mass_rel=1e-6, e_rel=1e-5, f_scaled=1e-5)


def _cli(argv):
    """constant_ph_tpu_torch.cli.main(argv) in-process: returns (the last
    stdout line parsed as JSON, stderr's text); both are logged."""
    import contextlib
    import io

    from constant_ph_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        cli.main(argv)
    for line in err.getvalue().splitlines():
        log(f"  {line}")
    last = out.getvalue().strip().splitlines()[-1]
    log(f"  {last}")
    return json.loads(last), err.getvalue()


class _ElasticProbe:
    """Wraps tiled.elastic.elastic_run while a CLI command runs (the CLI
    imports it at call time): on the card it runs with check_sync, so a
    production chunk that synchronises with the host raises; it records
    each call's tile shape, steps, chunk and retiles, and its wall time
    between two synchronisations (the production chunks with their DCD
    and checkpoint writes)."""

    def __init__(self, dev):
        import torch

        self.sync = torch.cuda.synchronize if dev == "cuda" else (
            lambda: None)
        self.check_sync = dev == "cuda"
        self.calls = []

    def __enter__(self):
        from constant_ph_tpu_torch.tiled import elastic

        self.orig = elastic.elastic_run

        def wrapped(ts, tst, cfg, n_steps, **kw):
            # on the card every chunk must run without a host sync
            kw["check_sync"] = self.check_sync
            self.sync()
            t0 = time.perf_counter()
            out = self.orig(ts, tst, cfg, n_steps, **kw)
            self.sync()
            blk = cfg.rebuild_every
            chunk = -(-kw.get("chunk", 2000) // blk) * blk
            self.calls.append(dict(
                wall=time.perf_counter() - t0, steps=n_steps, chunk=chunk,
                grid=list(ts.params.grid), W=ts.params.W,
                atoms=ts.n_atoms, retiles=out[3].n_retiles,
                check_sync=kw["check_sync"],
                evals=(-(-n_steps // chunk) + out[3].n_retiles)
                * -(-chunk // blk) * (blk + 1)))
            return out

        elastic.elastic_run = wrapped
        return self

    def __exit__(self, *exc):
        from constant_ph_tpu_torch.tiled import elastic

        elastic.elastic_run = self.orig


class _RunProbe:
    """Records, while active, the batch size of every call of a run that
    TiledEngine.make_run returns (1 for a single state)."""

    def __enter__(self):
        from constant_ph_tpu_torch.tiled.engine import TiledEngine

        self.calls = calls = []
        self._orig = orig = TiledEngine.make_run

        def make_run(eng, n_steps, detailed_flags=False):
            run = orig(eng, n_steps, detailed_flags)

            def counted(st, generators=None):
                calls.append(int(st.pH.shape[0]) if st.pH.ndim else 1)
                return run(st, generators)
            return counted

        TiledEngine.make_run = make_run
        return self

    def __exit__(self, *exc):
        from constant_ph_tpu_torch.tiled.engine import TiledEngine

        TiledEngine.make_run = self._orig


def _k1_passes(dev, W):
    """The passes K1 stages its stencil in at W (None off the card)."""
    if dev != "cuda":
        return None
    from constant_ph_tpu_torch.tiled import cuda_ww

    return cuda_ww.pass_count(cuda_ww._lib("ww_pair").ww_pair_smem_bytes, W)


def _write_json(path, obj):
    with open(path, "w") as fh:
        json.dump(obj, fh)
    return path


def _deck_parity(built, deck_sys):
    """A deck-built System against the builder's: coordinates, charges,
    masses and constraint triplets, then the reference engine's energies
    and forces on both at the builder's λ."""
    import numpy as np
    import torch

    from constant_ph_tpu_torch.engine import EngineConfig

    def h(t):
        return t.double().cpu().numpy()

    res = dict(
        x=float(np.abs(h(deck_sys.state.x) - h(built.state.x)).max()),
        q0=float(np.abs(h(deck_sys.ff.q0) - h(built.ff.q0)).max()),
        mass_rel=float((np.abs(h(deck_sys.ff.mass) - h(built.ff.mass))
                        / h(built.ff.mass)).max()),
        triplets_equal=bool(torch.equal(deck_sys.constraints.triplets.cpu(),
                                        built.constraints.triplets.cpu())))
    cfg = EngineConfig(dt=1.0, thermostat="nve", lambda_thermostat="none",
                       rebuild_every=10)
    frc = []
    for s in (built, deck_sys):
        eng = s.make_engine(cfg)
        nbr = eng.build_neighbors(s.state.x, s.state.box)
        frc.append((eng.compute_forces(s.state.x, built.state.lam,
                                       s.state.box, s.state.pH, nbr),
                    bool(nbr.overflow)))
    (f1, ov1), (f2, ov2) = frc
    for name in ("e_lj", "e_coul", "e_bonded"):
        a, b = float(getattr(f1, name)), float(getattr(f2, name))
        res[name] = [a, b]
        res[f"{name}_rel"] = abs(b - a) / max(abs(a), 1e-30)
    fa, fb = h(f1.f), h(f2.f)
    res["f_scaled"] = float(np.abs(fb - fa).max() / max(1.0,
                                                         np.abs(fa).max()))
    res["overflow"] = ov1 or ov2
    ok = (res["x"] <= DECK_TOL["x"] and res["q0"] <= DECK_TOL["q0"]
          and res["mass_rel"] <= DECK_TOL["mass_rel"]
          and res["triplets_equal"] and not res["overflow"]
          and res["f_scaled"] <= DECK_TOL["f_scaled"]
          and all(res[f"{n}_rel"] <= DECK_TOL["e_rel"]
                  for n in ("e_lj", "e_coul", "e_bonded")))
    return res, ok


def _finite(obj):
    """Every number in a JSON value is finite."""
    if isinstance(obj, dict):
        return all(_finite(v) for v in obj.values())
    if isinstance(obj, list):
        return all(_finite(v) for v in obj)
    if isinstance(obj, (int, float)):
        return math.isfinite(obj)
    return True


def cli_path(dev, config=HEWL_CONFIG, shape=HEWL_SHAPE, glu=GLU_CONFIG,
             n_min=CLI_HEWL["n_min"], steps=CLI_HEWL["steps"],
             every=CLI_HEWL["every"],
             restart_steps=CLI_HEWL["restart_steps"]):
    """The port's command line, in-process through cli.main, with every
    file in a temporary directory and depth cut through derived configs.

    (a) ``run`` on ``config`` (hewl_like.json: 20,241 atoms, grid 4³, W
    208, K1 in 3 passes): its minimize_steps, ``steps`` steps with a DCD
    frame every ``every``, a checkpoint and JSONL observables, the chunks
    under elastic_run's check_sync (``_ElasticProbe``); then ``run``
    again from that checkpoint for ``restart_steps`` steps without
    minimisation. (b) The same system
    written by write_lammps_data / write_sites_json, read back by the
    native reader (parity with the builder's system at the deck's printed
    digits, through the reference engine's forces), and ``run`` on the
    deck (builder lammps_data). (c) ``titrate`` (rex, metad) and
    ``calibrate`` (TI; metad must refuse as never crossed) on ``glu``
    (649 atoms, grid 1³: the plain tally path, no kernel), and the
    reference engine's ``run`` with Ewald k-space against Engine +
    make_kspace_fn. Counts zeroed just before each command and read just
    after; K1 must have launched once per force evaluation of (a) and
    (b). Smaller configs and depths only serve a rehearsal on the CPU."""
    import tempfile

    import torch

    from constant_ph_tpu_torch import checkpoint, cli
    from constant_ph_tpu_torch.forcefield import build_exclusions
    from constant_ph_tpu_torch.ops.ewald import make_kspace_fn
    from constant_ph_tpu_torch.systems import lammps_data as ld
    from constant_ph_tpu_torch.tiled.layout import split_system, to_tiled
    from constant_ph_tpu_torch.trajectory import read_dcd

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    d = tmp.name
    dev_args = [] if dev == "cuda" else ["--device", dev]
    with open(config) as fh:
        conf = json.load(fh)
    blk = conf["engine"]["rebuild_every"]
    fire_evals = -(-n_min // blk) * blk
    out = dict(launches={}, res={})

    def command(argv, probe_label, expect_kernel=True, fire=0):
        """One CLI command with the counts zeroed before and read after;
        K1 once per force evaluation (FIRE's plus the probed runs')."""
        zero_counts()
        t0 = time.perf_counter()
        with _ElasticProbe(dev) as probe:
            summary, err = _cli(argv + dev_args)
        counts = read_counts()
        evals = fire + sum(c["evals"] for c in probe.calls)
        want = {"ww_pair": evals if expect_kernel else 0, "ww_tally": 0}
        log(f"[cli {probe_label} launches] {json.dumps(counts)}, force "
            f"evaluations {evals}; runs {json.dumps(probe.calls)}; "
            f"{time.perf_counter() - t0:.1f} s")
        if counts != want:
            raise RuntimeError(f"cli {probe_label}: launches {counts}, "
                               f"expected {want}")
        return summary, err, probe.calls, counts["ww_pair"]

    # -- (a) run on the config, then a restart from its checkpoint --------
    paths = {k: os.path.join(d, f) for k, f in (
        ("dcd", "hewl.dcd"), ("ckpt", "hewl_ckpt.npz"),
        ("jsonl", "hewl_obs.jsonl"), ("ckpt2", "hewl_ckpt2.npz"),
        ("jsonl2", "hewl_obs2.jsonl"))}
    run_a = dict(conf["run"], minimize_steps=n_min, steps=steps,
                 trajectory=paths["dcd"], traj_every=every,
                 checkpoint=paths["ckpt"], output=paths["jsonl"])
    cfg_a = _write_json(os.path.join(d, "hewl_run.json"),
                        dict(conf, run=run_a))
    t0 = time.perf_counter()
    summary, err, calls, n_a = command(["run", cfg_a],
                                       "hewl run", fire=fire_evals)
    wall = time.perf_counter() - t0
    prod = calls[0]
    got = dict(atoms=prod["atoms"], sites=None, grid=prod["grid"],
               W=prod["W"])
    frames, _ = read_dcd(paths["dcd"])
    with open(paths["jsonl"]) as fh:
        n_rows = sum(1 for _ in fh)
    gen = torch.Generator(device=dev)
    saved = checkpoint.load(paths["ckpt"], dev, generator=gen)
    build = dict(conf["system"])
    build.pop("builder")
    system = cli._build_system(dict(conf["system"]), dev)
    ts = split_system(system, device=dev)
    got["sites"] = ts.spec.n_sites
    waters = int(to_tiled(ts, saved).wvalid.sum())
    res_a = dict(
        summary=summary, command_s=wall, production_s=prod["wall"],
        ms_per_step=prod["wall"] / steps * 1e3, shape=got,
        passes=_k1_passes(dev, got["W"]),
        dcd_frames=int(frames.shape[0]), dcd_atoms=int(frames.shape[1]),
        jsonl_rows=n_rows, ckpt_step=int(saved.step),
        ckpt_finite=bool(torch.isfinite(saved.x).all()
                         and torch.isfinite(saved.v).all()),
        waters=waters, n_waters=len(ts.water_atom_ids))
    log(f"[cli hewl run] {json.dumps(res_a)}")
    if shape is not None and (got != shape
                              or res_a["passes"] not in (None, 3)):
        raise RuntimeError(f"cli hewl run on {got} in {res_a['passes']} "
                           f"passes, expected {shape} in 3")
    if not (_finite(summary) and summary["steps"] == steps
            and res_a["dcd_frames"] == steps // every
            and res_a["dcd_atoms"] == prod["atoms"]
            and n_rows == -(-steps // run_a["observe_every"])
            and res_a["ckpt_step"] == steps and res_a["ckpt_finite"]
            and waters == res_a["n_waters"]):
        raise RuntimeError(f"cli hewl run failed its checks ({res_a})")

    run_r = dict(conf["run"], minimize_steps=0, steps=restart_steps,
                 restart=paths["ckpt"], checkpoint=paths["ckpt2"],
                 output=paths["jsonl2"])
    cfg_r = _write_json(os.path.join(d, "hewl_restart.json"),
                        dict(conf, run=run_r))
    summary_r, err_r, calls_r, n_r = command(
        ["run", cfg_r], "hewl restart")
    resumed = checkpoint.load(paths["ckpt2"], dev)
    res_r = dict(summary=summary_r, ckpt_step=int(resumed.step),
                 ms_per_step=calls_r[0]["wall"] / restart_steps * 1e3,
                 restarted_at=f"at step {steps}" in err_r,
                 generator_restored="no generator state" not in err_r)
    log(f"[cli hewl restart] {json.dumps(res_r)}")
    if not (_finite(summary_r) and res_r["restarted_at"]
            and res_r["generator_restored"]
            and res_r["ckpt_step"] == steps + restart_steps):
        raise RuntimeError(f"cli restart failed its checks ({res_r})")
    out["launches"]["run"] = n_a + n_r
    out["res"]["run"], out["res"]["restart"] = res_a, res_r

    # -- (b) the deck written from the same system -------------------------
    deck, sidecar = os.path.join(d, "hewl.data"), os.path.join(d,
                                                              "hewl.json")
    t0 = time.perf_counter()
    ld.write_lammps_data(deck, system)
    ld.write_sites_json(sidecar, system)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    ld.read_lammps_data(deck)
    t_read = time.perf_counter() - t0
    reader = ld.read_lammps_data.last_reader
    deck_kw = dict(rigid_water_types=DECK_TYPES, cutoff=build["cutoff"],
                   coul_style=build["coul_style"], alpha=build["alpha"],
                   pH=build["pH"])
    t0 = time.perf_counter()
    deck_sys = ld.system_from_deck(deck, sites_json=sidecar, device=dev,
                                   **deck_kw)
    t_build = time.perf_counter() - t0
    excl_path = build_exclusions.last_path
    parity, ok = _deck_parity(system, deck_sys)
    res_b = dict(write_s=t_write, read_s=t_read, build_s=t_build,
                 deck_mb=os.path.getsize(deck) / 2**20, reader=reader,
                 exclusions=excl_path, parity=parity)
    log(f"[cli deck] {json.dumps(res_b)}")
    if not ok or reader != "native" or excl_path != "native":
        raise RuntimeError(f"cli deck failed its checks ({res_b})")
    del deck_sys
    run_b = dict(conf["run"], minimize_steps=n_min, steps=steps)
    run_b.pop("output", None)
    cfg_b = _write_json(os.path.join(d, "deck_run.json"), dict(
        conf, system=dict(builder="lammps_data", path=deck,
                          sites_json=sidecar, **deck_kw), run=run_b))
    summary_b, _, calls_b, n_b = command(["run", cfg_b],
                                         "deck run", fire=fire_evals)
    shape_b = dict(atoms=calls_b[0]["atoms"], sites=got["sites"],
                   grid=calls_b[0]["grid"], W=calls_b[0]["W"])
    res_b.update(summary=summary_b, shape=shape_b,
                 ms_per_step=calls_b[0]["wall"] / steps * 1e3)
    log(f"[cli deck run] {json.dumps(res_b)}")
    if not (_finite(summary_b) and shape_b == got):
        raise RuntimeError(f"cli deck run failed its checks ({res_b})")
    out["launches"]["deck"] = n_b
    out["res"]["deck"] = res_b
    del system

    # -- (c) titrate and calibrate on the small box; the Ewald repair -----
    # depth cut, host-bound on 649 atoms: blocks of 2 steps, so a metad
    # chunk (50 · rebuild_every) is 100 steps; 20 FIRE steps; TI at 10 +
    # 5 + 10 steps a node; 200 metad calibration steps (with 100 the one
    # walker can pass the crossing guard, which this check needs to refuse)
    with open(glu) as fh:
        gconf = json.load(fh)
    gconf["engine"]["rebuild_every"] = 2
    gconf["run"] = {k: v for k, v in gconf["run"].items()
                    if k not in ("checkpoint", "output")}
    n_swaps, per_swap, met_steps = 2, 10, 100
    cfg_c = _write_json(os.path.join(d, "glu.json"), dict(
        gconf, run=dict(gconf["run"], steps=met_steps, minimize_steps=20,
                        steps_per_swap=per_swap, n_swaps=n_swaps)))
    t0 = time.perf_counter()
    # the rex replicas run as one batch on the reference engine: one run
    # call a block, one list build for both at the start and one a
    # rebuild_every block
    with _RefProbe() as rex_probe:
        rex, _, _, _ = command(["titrate", cfg_c, "--ph", "4,6"],
                               "titrate rex", expect_kernel=False)
    want_builds = [2] * (1 + n_swaps * -(-per_swap // 2))
    if rex_probe.runs != [2] * n_swaps or rex_probe.builds != want_builds:
        raise RuntimeError(f"cli titrate rex made run calls "
                           f"{rex_probe.runs} and builds "
                           f"{rex_probe.builds}, not one batched call a "
                           f"block and {want_builds}")
    # the metad walkers run as one batch: one run call of both a chunk
    # (met_steps in chunks of 50 · rebuild_every: one chunk)
    with _RunProbe() as walker_runs:
        met, _, _, _ = command(["titrate", cfg_c, "--ph", "4,6", "--method",
                                "metad"], "titrate metad",
                               expect_kernel=False)
    if walker_runs.calls != [2]:
        raise RuntimeError(f"cli titrate metad ran {walker_runs.calls}, not "
                           "one batched call of its two walkers")
    ti, _, _, _ = command(["calibrate", cfg_c, "--equil", "10",
                           "--window-equil", "5", "--samples", "10"],
                          "calibrate ti", expect_kernel=False)
    try:
        command(["calibrate", cfg_c, "--equil", "10", "--samples", "200",
                 "--method", "metad"], "calibrate metad",
                expect_kernel=False)
        refused = False
    except RuntimeError as err:
        refused = "never crossed" in str(err)
        log(f"  refused: {str(err)[:100]}")
    fracs = rex["deprotonated_fraction"] + met["deprotonated_fraction"]
    res_c = dict(
        rex_run_calls=rex_probe.runs, rex_list_builds=rex_probe.builds,
        metad_run_calls=walker_runs.calls,
        rex_keys=sorted(rex), metad_keys=sorted(met), ti_keys=sorted(ti),
        fractions=fracs, metad_refused=refused,
        finite=_finite([rex, met, ti]),
        seconds=time.perf_counter() - t0)
    log(f"[cli titrate] {json.dumps(res_c)}")
    if not (res_c["rex_keys"] == sorted(
                ["pH", "deprotonated_fraction", "hh_reference",
                 "swap_acceptance"])
            and res_c["metad_keys"] == sorted(
                ["method", "pH", "deprotonated_fraction", "per_site",
                 "hh_reference", "steps"])
            and res_c["ti_keys"] == sorted(
                ["dG_ref", "lambda_nodes", "dUdlam_profile"])
            and met["steps"] == met_steps and res_c["finite"] and refused
            and all(0.0 <= f <= 1.0 for f in fracs)):
        raise RuntimeError(f"cli titrate/calibrate failed ({res_c})")

    # the reference engine's run with Ewald k-space (real space 'cut' at
    # the same α): its first energy against Engine + make_kspace_fn
    ks = dict(style="ewald", alpha=0.3, accuracy=1e-5)
    esys = dict(gconf["system"], coul_style="cut", alpha=ks["alpha"])
    obs_path = os.path.join(d, "ewald_obs.jsonl")
    cfg_e = dict(gconf, system=esys, kspace=ks,
                 run=dict(steps=20, minimize_steps=0, observe_every=1,
                          tiled=False, output=obs_path))
    summary_e, _, _, _ = command(
        ["run", _write_json(os.path.join(d, "ewald.json"), cfg_e)],
        "ewald run", expect_kernel=False)
    with open(obs_path) as fh:
        row = json.loads(fh.readline())
    rsys = cli._build_system(dict(esys), dev)
    ecfg, bias, ep = cli._make_engines(cfg_e, rsys)
    gen = torch.Generator(device=dev).manual_seed(ecfg.seed)
    ref = rsys.make_engine(ecfg, bias=bias, kspace_fn=make_kspace_fn(ep)).run(
        rsys.state, ecfg.rebuild_every, generator=gen)[2]
    res_e = dict(e_pot=[row["e_pot"], float(ref.e_pot[0])],
                 e_kspace=[row["e_kspace"], float(ref.e_kspace[0])],
                 summary_finite=_finite(summary_e))
    log(f"[cli ewald] {json.dumps(res_e)}")
    if not (e_close(*res_e["e_pot"]) and e_close(*res_e["e_kspace"])
            and abs(row["e_kspace"]) > 1.0 and res_e["summary_finite"]):
        raise RuntimeError(f"cli Ewald run failed its checks ({res_e})")
    out["res"]["titrate"], out["res"]["ewald"] = res_c, res_e
    tmp.cleanup()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[cli] phase {out['seconds']:.1f} s")
    return out


def _bond_lengths(ts, st):
    """O-H and H-H distances of every valid tile water (molecules are
    whole in the tiles), float64 on the host."""
    import numpy as np

    W = ts.params.W
    xm = st.wx.double().cpu().numpy().reshape(3, -1, W, 3)
    v = st.wvalid.cpu().numpy() > 0.5

    def d(a, b):
        return np.sqrt(((xm[..., a] - xm[..., b]) ** 2).sum(0))[v]

    return np.concatenate([d(0, 1), d(0, 2)]), d(1, 2)


def npt_path(ts, st, pme, cfg, n_chunks=2, chunk=48, pressure_atm=1.0,
             seed=71):
    """NPT on the PME main path's production state: npt_elastic_run at
    ``pressure_atm`` with the live-box PME (one MC move after each of
    ``n_chunks`` chunks) and make_pressure_fn once. Counts zeroed just
    before, read just after (two force evaluations a move and a pressure).
    Gates: the box within the ±4 % drift guard; a move's result (an
    accepted one where there is one) is the state the next chunk starts
    from; rigid water geometry kept through a move; a finite pressure; no
    host sync inside a chunk; _check_npt_kspace refuses the same engine
    without kspace_live_box. Returns the numbers."""
    import dataclasses

    import numpy as np
    import torch

    from constant_ph_tpu_torch.tiled.engine import TiledEngine
    from constant_ph_tpu_torch.tiled.npt import (
        make_mc_barostat, make_pressure_fn, npt_elastic_run)

    t_phase = time.perf_counter()
    cfg_n = dataclasses.replace(cfg, kspace_live_box=True, seed=72)
    ends = []

    def on_chunk(done, ts_c, tst_c, obs_c):
        ends.append((ts_c, tst_c, gen.get_state()))

    gen = torch.Generator(device=st.wx.device).manual_seed(cfg_n.seed)
    box0 = st.box.double().cpu().numpy()
    # -- the path: counts zeroed just before, read just after --------------
    zero_counts()
    pressure = make_pressure_fn(TiledEngine(ts, cfg_n, kspace_ep=pme),
                                T=cfg_n.T)(st)
    t0 = time.perf_counter()
    ts_n, st_n, obs, info, stats = npt_elastic_run(
        ts, st, cfg_n, n_chunks * chunk, pressure_atm=pressure_atm,
        chunk=chunk, kspace_ep=pme, seed=seed, on_chunk=on_chunk,
        generator=gen, check_sync=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    # -------------------------------------------------------------------
    blk = cfg_n.rebuild_every
    evals = 2 + n_chunks * (-(-chunk // blk) * (blk + 1) + 2)
    box = st_n.box.double().cpu().numpy()
    res = dict(pressure_atm=float(pressure), accepted=stats["accepted"],
               proposed=stats["proposed"], volume=stats["volume"],
               volume0=float(np.prod(box0)),
               box_drift=float(np.abs(box / box0 - 1.0).max()),
               ms_per_step=wall / (n_chunks * chunk) * 1e3,
               T_mean=float(obs.temp.mean()),
               T_lam_mean=float(obs.temp_lam.mean()),
               h_conserved_finite=bool(torch.isfinite(obs.h_conserved).all()),
               retiles=info.n_retiles)
    # a move's result is the next chunk's start: redo the moves (their
    # uniforms from a generator seeded as the run's) and the chunk after
    # one (an accepted one where there is one) from its result, with the
    # run generator's state at that chunk's start
    mc = torch.Generator(device=st.wx.device).manual_seed(seed)
    moves = []
    for ts_k, st_k, _ in ends[:-1]:
        move = make_mc_barostat(TiledEngine(ts_k, cfg_n, kspace_ep=pme),
                                pressure_atm=pressure_atm, T=cfg_n.T)
        moves.append(move(st_k, mc))
    flags = [bool(a) for _, a in moves]
    k = flags.index(True) if True in flags else 0
    ts_k, st_k, g_k = ends[k]
    moved = moves[k][0]
    g = torch.Generator(device=st.wx.device)
    g.set_state(g_k)
    nxt = TiledEngine(ts_k, cfg_n, kspace_ep=pme).make_run(
        chunk, detailed_flags=True)(moved, g)[0]
    ratio = (moved.box.double() / st_k.box.double()).cpu().numpy()
    bonds0, hh0 = _bond_lengths(ts_k, st_k)
    bonds1, hh1 = _bond_lengths(ts_k, moved)
    res.update(checked_move=k, checked_move_accepted=flags[k],
               move_scale=float(ratio[0]), bond_change=float(max(
                   np.abs(bonds1 - bonds0).max(), np.abs(hh1 - hh0).max())))
    same = _first_difference((nxt,), (ends[k + 1][1],)) is None
    scaled = bool(np.allclose(ratio, ratio[0], rtol=1e-6, atol=0.0))
    # the guard: the same engine without the live box is refused
    try:
        make_mc_barostat(TiledEngine(ts, cfg, kspace_ep=pme),
                         pressure_atm=pressure_atm, T=cfg.T)
        refused = False
    except NotImplementedError:
        refused = True
    res.update(next_chunk_from_move=same, isotropic_box=scaled,
               baked_box_refused=refused)
    log(f"[npt production] {json.dumps(res)}")
    log(f"[npt launches] {json.dumps(counts)}, force evaluations {evals}")
    if counts != {"ww_pair": evals, "ww_tally": 0}:
        raise RuntimeError("the NPT path did not run every force "
                           "evaluation through the CUDA kernel K1")
    if not (same and scaled and refused and np.isfinite(res["pressure_atm"])
            and res["box_drift"] <= 0.04 and res["bond_change"] < 5e-5
            and res["h_conserved_finite"]
            and res["T_lam_mean"] <= T_LAM_MAX):
        raise RuntimeError(f"NPT path failed its checks ({res})")
    log(f"[npt] phase {time.perf_counter() - t_phase:.1f} s")
    return dict(res=res, counts=counts, ts=ts_n, st=st_n)


def cutoff_flips(wxg, p, box, wm, *, style, alpha, rc):
    """The atom pairs of the hot-path function (half stencil plus half the
    self tile, as water_water_fast_plain takes them) whose in-cutoff test
    r² < rc² differs between r² computed in float32 from the float32
    tiles and in float64 from the same tiles, and the float64 force they
    carry: (count, per-atom force of those pairs (3, ..., A) float64, each
    pair counted + where float32 takes it in and − where float64 does).
    The self tile holds each pair twice; so does its force, each half
    carrying 0.5 as in the plain version."""
    import numpy as np
    import torch

    from constant_ph_tpu_torch import units
    from constant_ph_tpu_torch.tiled import forces

    dims = (1, 2, 3)
    consts = forces.coulomb_constants(style, alpha, rc)
    q = np.tile(np.asarray(wm.q_pattern, np.float64), p.W)
    kqq = torch.as_tensor(units.QQR2E * q[:, None] * q[None, :],
                          device=wxg.device)
    mol = torch.arange(3 * p.W, device=wxg.device) // 3
    oo = ((torch.arange(3 * p.W, device=wxg.device) % 3 == 0)[:, None]
          & (torch.arange(3 * p.W, device=wxg.device) % 3 == 0)[None, :])
    w64 = wxg.double()
    f = torch.zeros_like(w64)
    n = 0
    for off in list(p.half_stencil) + [None]:
        xs = []
        for x in (wxg, w64):
            if off is None:
                xs.append(x)
            else:
                xs.append(torch.roll(x, tuple(-o for o in off), dims=dims)
                          + forces._roll_shift(box.to(x.dtype), p.grid, off,
                                               x.dtype))
        r2 = []
        for x, xj in ((wxg, xs[0]), (w64, xs[1])):
            d = x[..., :, None] - xj[..., None, :]
            r2.append(torch.clamp(d[0] * d[0] + d[1] * d[1] + d[2] * d[2],
                                  min=forces.R2_MIN))
        in32, in64 = r2[0] < rc * rc, r2[1] < rc * rc
        flip = in32 != in64
        if off is None:
            flip = flip & (mol[:, None] != mol[None, :])
        n += int(flip.sum()) // (2 if off is None else 1)
        if not flip.any():
            continue
        # +1 where float32 counts the pair and float64 does not
        sign = flip.double() * torch.where(in32, 1.0, -1.0)
        d = w64[..., :, None] - xs[1][..., None, :]
        _, w_r, inv_r2 = forces._screened_coulomb(r2[1], style, rc, consts)
        inv_r6 = inv_r2 ** 3
        h = kqq * w_r + oo * (12.0 * wm.c12_OO * inv_r6
                              - 6.0 * wm.c6_OO) * inv_r6 * inv_r2
        if off is None:
            h = 0.5 * h
        hd = (h * sign)[None] * d
        fi = torch.sum(hd, dim=-1)
        fj = -torch.sum(hd, dim=-2)
        f = f + fi + (fj if off is None else torch.roll(fj, off, dims=dims))
    return n, f


def rc_band_pairs(wxg, p, box, wm, *, style, alpha, rc, band=1e-3):
    """The hot-path atom pairs (half stencil plus the self tile, as
    water_water_fast_plain takes them) whose float64 r² lies within
    ``band`` Å² of rc²: pairs that a float32 r² may place on the other
    side of the cutoff than float64 does, where the 'cut' style steps by
    ~0.01-0.03 kcal/mol/Å a pair. A float32 r² is off by up to ~1e-4 Å²
    on the 64 Å box: a neighbour's image shift (±L) is added to its
    coordinates in float32 (7.8e-5 Å² measured for the plain version's
    r² at rc), and the kernels' fused multiply-adds round otherwise. One dict a pair: its atoms ``i`` and ``j`` as
    (cx, cy, cz, slot) tile indices, ``in64`` (float64 takes it inside
    rc), and its float64 terms when inside: ``f`` the force on i (j gets
    its negative), ``e_lj`` and ``e_coul`` the pair energies, ``u`` the
    Coulomb kernel u(r)·QQR2E, ``qi`` and ``qj`` the charges."""
    import numpy as np
    import torch

    from constant_ph_tpu_torch import units
    from constant_ph_tpu_torch.tiled import forces

    dims = (1, 2, 3)
    consts = forces.coulomb_constants(style, alpha, rc)
    q = np.tile(np.asarray(wm.q_pattern, np.float64), p.W)
    w64 = wxg.double()
    out = []
    for off in list(p.half_stencil) + [None]:
        xj = w64 if off is None else (
            torch.roll(w64, tuple(-o for o in off), dims=dims)
            + forces._roll_shift(box.double(), p.grid, off, torch.float64))
        d = w64[..., :, None] - xj[..., None, :]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        near = (r2 - rc * rc).abs() < band
        if off is None:          # the self tile: each pair once, no water
            a = torch.arange(3 * p.W, device=wxg.device)       # with itself
            near = near & ((a // 3)[:, None] < (a // 3)[None, :])
        idx = torch.nonzero(near)
        if idx.shape[0] == 0:
            continue
        cx, cy, cz, ai, bj = idx.unbind(1)
        r2_p = r2[cx, cy, cz, ai, bj]
        u_r, w_r, inv_r2 = forces._screened_coulomb(
            torch.clamp(r2_p, min=forces.R2_MIN), style, rc, consts)
        inv_r6 = inv_r2 ** 3
        oo = ((ai % 3 == 0) & (bj % 3 == 0)).double()
        qa = torch.as_tensor(q, device=wxg.device)[ai]
        qb = torch.as_tensor(q, device=wxg.device)[bj]
        kqq = units.QQR2E * qa * qb
        h = kqq * w_r + oo * (12.0 * wm.c12_OO * inv_r6
                              - 6.0 * wm.c6_OO) * inv_r6 * inv_r2
        f = (h[None] * d[:, cx, cy, cz, ai, bj]).T
        e_lj = oo * ((wm.c12_OO * inv_r6 - wm.c6_OO) * inv_r6
                     - wm.eshift_OO)
        o = (0, 0, 0) if off is None else off
        for k, (x, y, z, a_, b_) in enumerate(idx.tolist()):
            j = tuple((c + oc) % g for c, oc, g in zip((x, y, z), o, p.grid))
            out.append(dict(
                i=(x, y, z, a_), j=j + (b_,), in64=bool(r2_p[k] < rc * rc),
                f=f[k].tolist(), e_lj=float(e_lj[k]),
                e_coul=float(kqq[k] * u_r[k]),
                u=float(units.QQR2E * u_r[k]), qi=float(qa[k]),
                qj=float(qb[k])))
    return out


def k1_pair_terms(pr):
    """A pair's terms in K1's outputs, one list for each of its atoms:
    the force on that atom (3, gx, gy, gz, A), and with atom i the two
    energies ("e": e_lj, e_coul)."""
    return [[("f", (k,) + pr["i"], pr["f"][k]) for k in range(3)]
            + [("e", (0,), pr["e_lj"]), ("e", (1,), pr["e_coul"])],
            [("f", (k,) + pr["j"], -pr["f"][k]) for k in range(3)]]


def k2_pair_terms(pr):
    """A pair's terms in K2's packed output (gx, gy, gz, 8, A), one list
    for each of its atoms: force rows 0-2, half of each pair energy in
    eatom rows 3-4, φ in row 5 (the other atom's charge times u)."""
    def side(atom, sign, q_other):
        def at(row):
            return atom[:3] + (row, atom[3])
        return ([("f", at(k), sign * pr["f"][k]) for k in range(3)]
                + [("eatom", at(3), 0.5 * pr["e_lj"]),
                   ("eatom", at(4), 0.5 * pr["e_coul"]),
                   ("phi", at(5), pr["u"] * q_other)])

    return [side(pr["i"], 1.0, pr["qj"]), side(pr["j"], -1.0, pr["qi"])]


# a pair's force at rc below which settle_rc_pairs does not judge its two
# shares apart (kcal/mol/Å): the DSF terms vanish at rc and the O-O LJ
# step there is 2e-4, while the 'cut' Coulomb steps of the PME tiles are
# 0.009-0.034 a pair
SHARE_FLOOR = 1e-3


def settle_rc_pairs(diffs, scales, pairs, terms):
    """Counts each atom's share of each pair of ``pairs`` (rc_band_pairs)
    wholly inside or wholly outside rc, whichever the kernel chose for
    that atom: ``diffs`` holds the kernel's outputs less its float64 plain
    version's (float64 tensors by group, changed in place), in which a
    share the kernel placed on the other side shows as its whole float64
    terms (``terms(pair)``: one list of (group, index, value) for each
    atom of the pair), with the sign of that side. The kernels evaluate a
    pair's two shares apart (K1 from each atom's staged tile, K2 from
    each atom's cell), so float32 may place them on different sides. A
    share is taken as placed on the other side where removing its terms
    leaves the smaller sum of |diff| / scale over the per-atom outputs it
    touches (the groups in ``scales``); then all its terms go, totals
    included, and nothing else is taken off. Returns (the number of
    shares so taken, the number of pairs whose force at rc is at least
    SHARE_FLOOR and of whose two shares one was taken and the other not:
    pairs the kernel placed on both sides of rc at once)."""
    n = split = 0
    for pr in pairs:
        sign = -1.0 if pr["in64"] else 1.0
        taken = []
        for share in terms(pr):
            per_atom = [(float(diffs[g][ix]), g, v) for g, ix, v in share
                        if g in scales]
            before = sum(abs(d) / scales[g] for d, g, _ in per_atom)
            after = sum(abs(d - sign * v) / scales[g]
                        for d, g, v in per_atom)
            taken.append(after < before)
            if after < before:
                for g, ix, v in share:
                    diffs[g][ix] -= sign * v
                n += 1
        if (len(set(taken)) > 1
                and math.sqrt(sum(f * f for f in pr["f"])) >= SHARE_FLOOR):
            split += 1
    return n, split


# -- the multi-rank phases: torch.distributed on the one card -------------
#
# world 1 runs over nccl; world 2 runs two processes that share the card
# over gloo, whose collectives go through pinned host buffers
# (parallel/comm.py). The ranks load what they need from a checkpoint the
# parent wrote (the PME production state, its TiledSystem and engine
# settings, the campaign's merge inputs): they relax nothing.

SPATIAL_BLOCKS = 1          # timed 12-step blocks after the held one
# owned-cell forces on slabs against the single-process evaluation: the
# water-water rows are bitwise (each owned cell's pairs and bits are the
# whole grid's); at world 2 the PME mesh is summed over the ranks in
# another float32 order
TOL_SPATIAL_F = 1e-6
# a block on slabs against the single-process block (the same noise):
# float32 sums taken in another order over 12 steps, as TOL_BATCH_LOOP
TOL_SPATIAL_RUN = dict(lam=1e-4, x=1e-3, h_rel=1e-4)
# FIRE, NPT and Ewald on slabs (slab_paths): FIRE's energy history and
# positions at world 2 at the bars of tests/test_spatial.py:116-135; the
# MC moves' boxes, and the pressure at tests/test_torch_npt.py's bar;
# the Ewald forces (of max) and energies at tests/test_torch_tiled_ewald
# .py's; compute_Hs on the Ewald engine K2's slab entry against the whole
# grid's K2 (the water's tallies summed over the ranks)
SLAB_FIRE_BLOCKS = 2
SLAB_MC_U = ((0.8, 0.2), (0.3, 0.9))      # (proposal, acceptance) a move
TOL_SLAB = dict(fire_e_rel=2e-5, fire_x=1e-4, box_rel=1e-6, p_rel=2e-3,
                p_abs=5.0, ewald_f=1e-5, ewald_e_rel=2e-5, hs_rel=2e-5)
# compute_Hs on slabs (K2's slab entry) against the single-process
# compute_Hs (the plain tally path with the exact erfc): the bar of K2
# against K1 through compute_forces on the tally path
TOL_HS_REL = 5e-5


def _on(obj, dev):
    """A dataclass of tensors (a TiledState) with every tensor on dev."""
    import dataclasses

    import torch

    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(dev)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


def _sync(dev):
    import torch

    if str(dev) == "cuda":
        torch.cuda.synchronize()


def _load_ranks_ckpt(path, dev):
    """The checkpoint's objects on dev: (ts, st, pme, cfg, data)."""
    import torch

    from constant_ph_tpu_torch.ops.pme import make_pme_params

    data = torch.load(path, weights_only=False)
    ts = data["ts"].to(dev)
    st = _on(data["state"], dev)
    pme = make_pme_params(data["pme_box"], ts.params.grid, data["alpha"],
                          skin=data["skin"], device=dev, **PME_MESH)
    return ts, st, pme, data["cfg"], data


def _rank_merge(data, dev):
    """make_mesh_group_merge of the campaign rungs' tables over the default
    group (each rank folds its walkers)."""
    import torch

    from constant_ph_tpu_torch import metad

    m = data["merge"]
    mp = metad.MetadParams(**m["mp"])
    args = [torch.as_tensor(m[k], device=dev) for k in ("V", "dV", "seq")]
    t0 = time.perf_counter()
    V, dV = metad.make_mesh_group_merge(None, mp)(*args)
    _sync(dev)
    return dict(V=V, dV=dV, seconds=time.perf_counter() - t0)


def _rank_spatial(r, n, ts, st, pme, cfg, dev):
    """The PME production tiles on x-slabs: one force evaluation, a held
    12-step block, SPATIAL_BLOCKS timed ones, K1's and K2's slab entries
    against their plain versions and their whole-grid launches, and K2's
    slab entry once through compute_Hs."""
    import torch

    from constant_ph_tpu_torch.parallel import comm, spatial
    from constant_ph_tpu_torch.profiling import graph_ms
    from constant_ph_tpu_torch.tiled import cuda_ww, forces
    from constant_ph_tpu_torch.tiled.engine import TiledEngine

    grp = spatial.make_spatial_mesh(n)
    eng = TiledEngine(ts, cfg, kspace_ep=pme, spatial=grp)
    sl = eng.slab
    mine = spatial.shard_tiled_state(st, grp, ts.params)
    block = cfg.rebuild_every
    run = eng.make_run(block)
    gen = torch.Generator(device=dev).manual_seed(31)
    # -- the path: counts zeroed just before, read just after --------------
    _sync(dev)
    zero_counts()
    comm.reset_stats()
    frc = eng.compute_forces(mine, kspace_impulse=True,
                             phi_recip_prev=mine.phi_recip_s)
    st2, ov, obs = run(mine, gen)
    _sync(dev)
    counts, stats = read_counts(), {k: dict(v) for k, v in
                                    comm.STATS.items()}
    counts["spatial"] = read_slab_counts()
    # -----------------------------------------------------------------------
    t0 = time.perf_counter()
    st3 = st2
    for _ in range(SPATIAL_BLOCKS):
        st3, _, _ = run(st3, gen)
    _sync(dev)
    ms_step = (time.perf_counter() - t0) / (SPATIAL_BLOCKS * block) * 1e3
    # K2's slab entry once through compute_Hs
    zero_counts()
    HA, HB = eng.compute_Hs(mine)
    _sync(dev)
    hs_counts = read_counts()
    hs_counts["spatial"] = read_slab_counts()["ww_tally"]
    res = dict(
        rank=r, world=n, x_first=sl.x_first, layers=sl.n,
        fw=frc.fw, fs=frc.fs, e_pot=frc.e_pot, dUdlam=frc.dUdlam,
        obs=dict(e_pot=obs.e_pot, ke=obs.ke, h=obs.h_conserved,
                 lam=obs.lam),
        lam=st2.lam, sx=st2.sx, wx=st2.wx, overflow=bool(ov.any()),
        counts=counts, stats=stats, ms_per_step=ms_step,
        HA=HA, HB=HB, hs_counts=hs_counts,
        paths=slab_paths(ts, st, pme, cfg, dev, grp))
    if dev != "cuda":               # a rehearsal: the kernels need the card
        return res
    # both slab entries against their plain versions on the halo'd tiles,
    # their owned rows against the whole grid's launch, and timed
    p = ts.params
    gy, gz = p.grid[1:]
    R = 1
    wxg = mine.wx.reshape(R, 3, sl.n, gy, gz, 3 * p.W)
    wvg = mine.wvalid.reshape(R, sl.n, gy, gz, p.W)
    wxh, wvh = spatial.halo(wxg, wvg, sl)
    kw = dict(style=ts.coul_style, alpha=ts.alpha, rc=ts.cutoff,
              x_first=sl.x_first)
    box = st.box[None].contiguous()
    k1 = cuda_ww.water_water_cuda(wxh, ts.water, p, box, **kw)
    k1_plain = forces.water_water_slab_plain(wxh, ts.water, p, box, **kw)
    whole = forces.water_water_fast(
        st.wx.reshape((1, 3) + p.grid + (3 * p.W,)).contiguous(), ts.water,
        p, box, style=ts.coul_style, alpha=ts.alpha, rc=ts.cutoff)
    wt = forces.pack_water_tiles(wxh, wvh, ts.water, p)
    k2 = cuda_ww.water_water_tally_cuda(wt, box, ts.water, p, **kw)
    k2_plain = forces.water_water_tally_plain(wt, box, ts.water, p, **kw)
    wt_whole = forces.pack_water_tiles(
        st.wx.reshape((1, 3) + p.grid + (3 * p.W,)).contiguous(),
        st.wvalid.reshape((1,) + p.grid + (p.W,)), ts.water, p)
    k2_whole = cuda_ww.water_water_tally_cuda(
        wt_whole, box, ts.water, p, style=ts.coul_style, alpha=ts.alpha,
        rc=ts.cutoff)
    own = slice(sl.x_first, sl.x_first + sl.n)
    f1s = max(1.0, float(k1_plain[2].abs().max()))
    f2s = max(1.0, float(k2_plain[..., :3, :].abs().max()))
    res.update(
        k1_vs_plain=float((k1[2] - k1_plain[2]).abs().max()) / f1s,
        k1_e_vs_plain=[float(k1[i] - k1_plain[i]) for i in (0, 1)],
        k1_rows_bitwise=bool(torch.equal(k1[2], whole[2][:, :, own])),
        k2_vs_plain=float((k2[..., :3, :] - k2_plain[..., :3, :])
                          .abs().max()) / f2s,
        k2_rows_bitwise=bool(torch.equal(k2, k2_whole[:, own])),
        slab_ms=dict(
            ww_pair=graph_ms(lambda: cuda_ww.water_water_cuda(
                wxh, ts.water, p, box, **kw), 50),
            ww_tally=graph_ms(lambda: cuda_ww.water_water_tally_cuda(
                wt, box, ts.water, p, **kw), 50)))
    return res


def slab_paths(ts, st, pme, cfg, dev, group=None):
    """FIRE, NPT and Ewald from the whole-grid state ``st``: on x-slabs
    over ``group`` (each rank shards ``st`` and returns its slab's water
    arrays), or in one process without. ``fire``: make_minimize of
    SLAB_FIRE_BLOCKS blocks on the PME engine. ``npt``: PME on the live
    box, the SLAB_MC_U moves chained, make_pressure_fn once, then one
    chunk of npt_elastic_run with its move. ``ewald``: a tiled Ewald
    engine (make_ewald_params at the state's box) with one full force
    evaluation and a rebuild_every block (kspace_every as ``cfg``; λ held
    at its end state, held_lambda); ``hs``: its compute_Hs (on slabs K2's slab entry; in one process K2
    on the whole grid, use_pallas_ww). Each phase carries its launches
    (K1/K2, and their slab entries'), the comm.STATS of the phase, its
    steps (FIRE steps; the chunk's and block's steps) and its ms on the
    host clock, and ms/step (npt and ewald: of the chunk and the block
    alone)."""
    import dataclasses

    import torch

    from constant_ph_tpu_torch.ops.ewald import make_ewald_params
    from constant_ph_tpu_torch.parallel import comm, spatial
    from constant_ph_tpu_torch.tiled.engine import TiledEngine
    from constant_ph_tpu_torch.tiled.npt import (
        make_mc_barostat, make_pressure_fn, npt_elastic_run)

    block = cfg.rebuild_every

    def own(x):
        return (x if group is None
                else spatial.shard_tiled_state(x, group, ts.params))

    mine = own(st)
    # Ewald holds λ at its end state, as ewald_tiled_path does (with λ
    # moving the tiled Ewald block meets the λ-wall event's drift flag)
    st_h, cfg_h = held_lambda(st, cfg)
    mine_h = own(st_h)
    out = {}

    def phase(name, steps, fn):
        _sync(dev)
        zero_counts()
        comm.reset_stats()
        t0 = time.perf_counter()
        res = fn()
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        res.setdefault("ms_per_step", ms / steps)
        res.update(
            steps=steps, ms=ms,
            launches=dict(read_counts(), spatial=read_slab_counts()),
            stats={k: dict(v) for k, v in comm.STATS.items()})
        out[name] = res

    def fire():
        eng = TiledEngine(ts, cfg, kspace_ep=pme, spatial=group)
        st_f, e = eng.make_minimize(SLAB_FIRE_BLOCKS * block)(mine)
        return dict(e=e, sx=st_f.sx, wx=st_f.wx)

    cfg_n = dataclasses.replace(cfg, kspace_live_box=True, seed=72)

    def npt():
        eng = TiledEngine(ts, cfg_n, kspace_ep=pme, spatial=group)
        move = make_mc_barostat(eng, pressure_atm=1.0, T=cfg.T)
        cur, acc, boxes = mine, [], []
        for u in SLAB_MC_U:
            cur, a = move(cur, u=u)
            acc.append(a)
            boxes.append(cur.box)
        p = make_pressure_fn(eng, T=cfg.T)(mine)
        _sync(dev)
        t0 = time.perf_counter()
        _, st_n, obs, info, stats = npt_elastic_run(
            ts, cur, cfg_n, block, pressure_atm=1.0, chunk=block,
            kspace_ep=pme, seed=73, spatial=group,
            generator=torch.Generator(device=dev).manual_seed(74))
        _sync(dev)
        return dict(accepted=torch.stack(acc), box=torch.stack(boxes),
                    pressure=p, e_run=obs.e_pot, h=obs.h_conserved,
                    lam=st_n.lam, sx=st_n.sx, wx=st_n.wx, box_run=st_n.box,
                    run_accepted=stats["accepted"], retiles=info.n_retiles,
                    ms_per_step=(time.perf_counter() - t0) / block * 1e3)

    ep = make_ewald_params(st.box.cpu().numpy(), REF_EWALD["alpha"],
                           accuracy=REF_EWALD["accuracy"], device=dev)

    def ewald():
        eng = TiledEngine(ts, cfg_h, kspace_ep=ep, spatial=group)
        frc = eng.compute_forces(mine_h)
        _sync(dev)
        t0 = time.perf_counter()
        st_e, ov, obs = eng.make_run(block)(
            mine_h, torch.Generator(device=dev).manual_seed(75))
        _sync(dev)
        return dict(fw=frc.fw, fs=frc.fs, e_pot=frc.e_pot,
                    e_kspace=frc.e_kspace, dUdlam=frc.dUdlam,
                    e_run=obs.e_pot, h=obs.h_conserved, lam=st_e.lam,
                    sx=st_e.sx, wx=st_e.wx, overflow=ov,
                    ms_per_step=(time.perf_counter() - t0) / block * 1e3)

    def hs():
        eng = TiledEngine(ts, cfg_h, kspace_ep=ep, spatial=group,
                          use_pallas_ww=group is None)
        HA, HB = eng.compute_Hs(mine_h)
        return dict(HA=HA, HB=HB)

    phase("fire", SLAB_FIRE_BLOCKS * block, fire)
    phase("npt", block, npt)
    phase("ewald", block, ewald)
    phase("hs", 1, hs)
    return out


def _rank_replicas(r, n, ts, st, pme, cfg, dev):
    """The PME REX leg's block (R 4, K1, frozen bias) with the replicas
    split over the ranks."""
    import torch

    from constant_ph_tpu_torch.parallel import replica
    from constant_ph_tpu_torch.tiled.engine import TiledEngine

    batch, mp = pme_rex_batch(ts, st)
    R = batch.pH.shape[0]
    own = replica.rank_slice(R, None)
    mine = replica.split_replicas(batch, None)
    eng = TiledEngine(ts, cfg, kspace_ep=pme, metad=mp, metad_frozen=True)
    block = replica.make_rex_runner_tiled(
        eng, cfg.rebuild_every, group=None,
        generators=replica.replica_generators(
            [500 + k for k in range(own.start, own.stop)], dev))
    swap = torch.Generator(device=dev).manual_seed(25)
    zero_counts()
    t0 = time.perf_counter()
    out, _, accepted, last = block(mine, swap, 0)
    _sync(dev)
    wall = time.perf_counter() - t0
    return dict(lam=out.lam, sx=out.sx, wx=out.wx, pH=out.pH,
                accepted=accepted, h=last.h_conserved, counts=read_counts(),
                ms_per_walker_step=wall / ((own.stop - own.start)
                                           * cfg.rebuild_every) * 1e3)


def _slab_evals(block, ph):
    """The force evaluations of each slab_paths phase: K1 for fire, npt
    and ewald, K2 for hs. npt: two a move (SLAB_MC_U and the chunk's), two
    for the pressure, a block's (its start and a step's) per run of the
    chunk (a retile redoes it)."""
    return dict(fire=SLAB_FIRE_BLOCKS * block,
                npt=2 * len(SLAB_MC_U) + 2 + 2
                + (block + 1) * (1 + ph["npt"]["retiles"]),
                ewald=1 + block + 1, hs=1)


def _slab_rows(n, ranks, ref, block):
    """[spatial fire], [spatial npt] and [spatial ewald] at world n: each
    rank's slab_paths against the single-process ``ref`` (world 1
    bitwise, world 2 at TOL_SLAB / TOL_SPATIAL_RUN), every rank alike,
    and the launches (the slab entries on every force evaluation).
    Returns (rows, the names of the failed ones)."""
    import numpy as np

    sp = [o["spatial"]["paths"] for o in ranks]
    one = n == 1

    def whole(ph, k):
        return np.concatenate([o[ph][k] for o in sp], axis=1)

    def rel(a, b):
        b = np.asarray(b, np.float64)
        return _max_diff(a, b) / max(float(np.abs(b).max()), 1e-30)

    def scaled(a, b):
        return _max_diff(a, b) / max(1.0, float(np.abs(b).max()))

    def alike(ph, keys):
        return all(np.array_equal(o[ph][k], sp[0][ph][k])
                   for o in sp for k in keys)

    def bitwise(ph, keys, tiles=("wx",)):
        return (all(np.array_equal(sp[0][ph][k], ref[ph][k]) for k in keys)
                and all(np.array_equal(whole(ph, k), ref[ph][k])
                        for k in tiles))

    def comms(ph):
        steps = sp[0][ph]["steps"]
        return dict(
            collectives_per_step={k: [o[ph]["stats"][k]["calls"] / steps
                                      for o in sp]
                                  for k in sp[0][ph]["stats"]},
            comm_bytes_per_step=[sum(v["bytes"] for v in
                                     o[ph]["stats"].values()) / steps
                                 for o in sp],
            ms_per_step=[o[ph]["ms_per_step"] for o in sp],
            single_ms_per_step=ref[ph]["ms_per_step"],
            launches=[o[ph]["launches"] for o in sp])

    def run_diffs(ph):
        return dict(run_lam=_max_diff(sp[0][ph]["lam"], ref[ph]["lam"]),
                    run_x=max(_max_diff(sp[0][ph]["sx"], ref[ph]["sx"]),
                              _max_diff(whole(ph, "wx"), ref[ph]["wx"])),
                    run_h_rel=rel(sp[0][ph]["h"], ref[ph]["h"]))

    def run_ok(row):
        return (row["run_lam"] <= TOL_SPATIAL_RUN["lam"]
                and row["run_x"] <= TOL_SPATIAL_RUN["x"]
                and row["run_h_rel"] <= TOL_SPATIAL_RUN["h_rel"])

    evals = _slab_evals(block, sp[0])

    def launches_ok(ph, kernel):
        want = evals[ph]
        other = "ww_tally" if kernel == "ww_pair" else "ww_pair"
        return all(o[ph]["launches"][kernel] == want
                   and o[ph]["launches"]["spatial"][kernel] == want
                   and o[ph]["launches"][other] == 0 for o in sp)

    t = TOL_SLAB
    rows, fails = {}, []
    f = dict(world=n, evals=evals["fire"],
             bitwise=bitwise("fire", ("e", "sx")),
             e_rel=rel(sp[0]["fire"]["e"], ref["fire"]["e"]),
             x=max(_max_diff(sp[0]["fire"]["sx"], ref["fire"]["sx"]),
                   _max_diff(whole("fire", "wx"), ref["fire"]["wx"])),
             ranks_alike=alike("fire", ("e", "sx")), **comms("fire"))
    f["ok"] = (launches_ok("fire", "ww_pair") and f["ranks_alike"]
               and (f["bitwise"] if one else
                    f["e_rel"] <= t["fire_e_rel"] and f["x"] <= t["fire_x"]))
    rows["fire"] = f

    npt_keys = ("accepted", "box", "pressure", "e_run", "lam", "sx",
                "box_run")
    pr, p1 = float(sp[0]["npt"]["pressure"]), float(ref["npt"]["pressure"])
    m = dict(world=n, evals=evals["npt"],
             bitwise=bitwise("npt", npt_keys),
             accepted=np.asarray(sp[0]["npt"]["accepted"]).tolist(),
             accepted_single=np.asarray(ref["npt"]["accepted"]).tolist(),
             box_rel=max(rel(sp[0]["npt"]["box"], ref["npt"]["box"]),
                         rel(sp[0]["npt"]["box_run"],
                             ref["npt"]["box_run"])),
             pressure_atm=pr, pressure_single_atm=p1,
             run_accepted=sp[0]["npt"]["run_accepted"],
             retiles=sp[0]["npt"]["retiles"],
             ranks_alike=alike("npt", ("accepted", "box", "box_run",
                                       "lam", "sx")),
             broadcasts_per_move=[o["npt"]["stats"]["broadcast"]["calls"]
                                  / (len(SLAB_MC_U) + 1) for o in sp],
             **run_diffs("npt"), **comms("npt"))
    m["ok"] = (launches_ok("npt", "ww_pair") and m["ranks_alike"]
               and m["accepted"] == m["accepted_single"]
               and m["run_accepted"] == ref["npt"]["run_accepted"]
               and m["retiles"] == ref["npt"]["retiles"]
               and m["broadcasts_per_move"] == [2.0] * n
               and (m["bitwise"] if one else
                    m["box_rel"] <= t["box_rel"] and run_ok(m)
                    and abs(pr - p1) <= t["p_abs"] + t["p_rel"] * abs(p1)))
    rows["npt"] = m

    ew_keys = ("fs", "e_pot", "dUdlam", "e_run", "lam", "sx")
    e = dict(world=n, evals=evals["ewald"],
             bitwise=(bitwise("ewald", ew_keys, ("fw", "wx"))
                      and np.array_equal(sp[0]["hs"]["HA"], ref["hs"]["HA"])),
             fw_scaled=scaled(whole("ewald", "fw"), ref["ewald"]["fw"]),
             fs_scaled=scaled(sp[0]["ewald"]["fs"], ref["ewald"]["fs"]),
             e_pot_rel=rel(sp[0]["ewald"]["e_pot"], ref["ewald"]["e_pot"]),
             e_kspace=float(sp[0]["ewald"]["e_kspace"]),
             HA_rel=rel(sp[0]["hs"]["HA"], ref["hs"]["HA"]),
             HB_rel=rel(sp[0]["hs"]["HB"], ref["hs"]["HB"]),
             overflow=any(bool(o["ewald"]["overflow"]) for o in sp),
             ranks_alike=alike("ewald", ("fs", "e_pot", "lam", "sx")),
             hs_launches=[o["hs"]["launches"] for o in sp],
             **run_diffs("ewald"), **comms("ewald"))
    e["ok"] = (launches_ok("ewald", "ww_pair") and launches_ok("hs",
                                                                "ww_tally")
               and e["ranks_alike"] and not e["overflow"]
               and (e["bitwise"] if one else
                    max(e["fw_scaled"], e["fs_scaled"]) <= t["ewald_f"]
                    and e["e_pot_rel"] <= t["ewald_e_rel"] and run_ok(e)
                    and max(e["HA_rel"], e["HB_rel"]) <= t["hs_rel"]))
    rows["ewald"] = e
    for name, row in rows.items():
        log(f"[spatial {name}] {json.dumps(row)}")
        if not row["ok"]:
            fails.append(f"spatial {name} at world {n}")
    return rows, fails


def ranks_child(r, n, path, todo, dev):
    """One rank of the multi-rank phases (a spawned process on the card):
    the phases named in ``todo`` on the checkpoint at ``path``."""
    import torch

    if dev == "cuda":
        torch.cuda.set_device(0)
    ts, st, pme, cfg, data = _load_ranks_ckpt(path, dev)
    out = {}
    if "merge" in todo:
        out["merge"] = _rank_merge(data, dev)
    if "replicas" in todo:
        out["replicas"] = _rank_replicas(r, n, ts, st, pme, cfg, dev)
    if "spatial" in todo:
        out["spatial"] = _rank_spatial(r, n, ts, interior_lambda(st), pme,
                                       cfg, dev)
    return out


def _max_diff(a, b):
    import numpy as np

    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def ranks_phase(ts, st, pme, cfg, rex, camp, dev="cuda", skin=0.8):
    """[mesh merge], [rank replicas] and [spatial]: the checkpoint
    written, the single-process references computed here, then the ranks
    spawned at world 1 (nccl: merge, spatial) and world 2 (gloo: merge,
    replicas, spatial), each held to its reference. Returns the
    readings. ``cfg`` runs the replicas (the PME REX leg's, which sets
    their λ) and the spatial leg (from interior_lambda(st)). ``dev`` "cpu"
    and a smaller state
    (its split ``skin``) only serve a rehearsal (world 1 over gloo there;
    no kernel checks)."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from constant_ph_tpu_torch import metad
    from constant_ph_tpu_torch.parallel import comm
    from constant_ph_tpu_torch.tiled.engine import TiledEngine

    t_phase = time.perf_counter()
    d = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    path = os.path.join(d, "ranks.pt")
    torch.save(dict(ts=ts.to("cpu"), state=_on(st, "cpu"), cfg=cfg,
                    pme_box=pme.box.cpu().numpy(), alpha=pme.alpha,
                    skin=skin,
                    merge={k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                           for k, v in camp["merge_in"].items()}),
               path)
    # the single-process references on the card
    m = camp["merge_in"]
    mp = metad.MetadParams(**m["mp"])
    S = m["seq"].shape[-1]
    ser = [metad.deposit_frozen(m["V"][g], m["dV"][g],
                                m["seq"][g].reshape(-1, S), mp)
           for g in range(m["V"].shape[0])]
    merge_ref = (m["V"] + torch.stack([a for a, _ in ser]),
                 m["dV"] + torch.stack([b for _, b in ser]))
    st_sp = interior_lambda(st)
    eng = TiledEngine(ts, cfg, kspace_ep=pme)
    block = cfg.rebuild_every
    run = eng.make_run(block)
    gen = torch.Generator(device=dev).manual_seed(31)
    frc1 = eng.compute_forces(st_sp, kspace_impulse=True,
                              phi_recip_prev=st_sp.phi_recip_s)
    st1, _, obs1 = run(st_sp, gen)
    _sync(dev)
    t0 = time.perf_counter()
    st_t = st1
    for _ in range(SPATIAL_BLOCKS):
        st_t, _, _ = run(st_t, gen)
    _sync(dev)
    ms_single = (time.perf_counter() - t0) / (SPATIAL_BLOCKS * block) * 1e3
    HA1, _ = eng.compute_Hs(st_sp)
    ref = dict(fw=frc1.fw.cpu().numpy(), fs=frc1.fs.cpu().numpy(),
               e_pot=float(frc1.e_pot), dUdlam=frc1.dUdlam.cpu().numpy(),
               e_run=obs1.e_pot.cpu().numpy(), ke=obs1.ke.cpu().numpy(),
               h=obs1.h_conserved.cpu().numpy(), lam=st1.lam.cpu().numpy(),
               sx=st1.sx.cpu().numpy(), wx=st1.wx.cpu().numpy(),
               HA=float(HA1))
    ref_paths = comm._to_host(slab_paths(ts, st_sp, pme, cfg, dev))
    try:
        runs = {}
        for n, backend, todo in ((1, "nccl" if dev == "cuda" else "gloo",
                                  ("merge", "spatial")),
                                 (2, "gloo", ("merge", "replicas",
                                              "spatial"))):
            t0 = time.perf_counter()
            runs[n] = comm.run_ranks(ranks_child, n, (path, todo, dev),
                                     backend=backend, init_dir=d,
                                     timeout=600.0)
            log(f"[ranks] world {n} over {backend}: "
                f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    res = dict(merge={}, spatial={}, slab_paths={},
               single_ms_per_step=ms_single)
    fails = []

    # [mesh merge]: every rank the same tables, within the JAX package's
    # bars of the serial frozen merge (V 1e-5, dV 1e-4)
    mV, mdV = (t.cpu().numpy() for t in merge_ref)
    for n, ranks in runs.items():
        same = all(np.array_equal(o["merge"]["V"], ranks[0]["merge"]["V"])
                   for o in ranks)
        errs = dict(V=_max_diff(ranks[0]["merge"]["V"], mV),
                    dV=_max_diff(ranks[0]["merge"]["dV"], mdV))
        ok = (same and np.allclose(ranks[0]["merge"]["V"], mV, rtol=1e-5,
                                   atol=1e-5)
              and np.allclose(ranks[0]["merge"]["dV"], mdV, rtol=1e-4,
                              atol=1e-4)
              and float(np.abs(ranks[0]["merge"]["V"]
                               - m["V"].cpu().numpy()).max()) > 0.0)
        res["merge"][n] = dict(world=n, ranks_alike=same, max_err=errs,
                               seconds=ranks[0]["merge"]["seconds"], ok=ok)
        log(f"[mesh merge] {json.dumps(res['merge'][n])}")
        if not ok:
            fails.append(f"mesh merge at world {n}")

    # [rank replicas]: world 2, 2 replicas a rank, each held to the
    # one-process batched block
    k1o = rex["k1_out"]
    reps = runs[2]
    got = {k: np.concatenate([o["replicas"][k] for o in reps], axis=0)
           for k in ("lam", "sx", "wx", "pH", "h")}
    one = {k: k1o[k].cpu().numpy() for k in ("lam", "sx", "wx", "pH", "h")}
    rr = dict(
        R=int(one["pH"].shape[0]), world=2,
        bitwise={k: bool(np.array_equal(got[k], one[k])) for k in got},
        lam=_max_diff(got["lam"], one["lam"]),
        x=max(_max_diff(got["sx"], one["sx"]),
              _max_diff(got["wx"], one["wx"])),
        h_rel=float(np.max(np.abs(got["h"] - one["h"]) / np.abs(one["h"]))),
        pH=got["pH"].tolist(),
        launches=[o["replicas"]["counts"] for o in reps],
        ms_per_walker_step=[o["replicas"]["ms_per_walker_step"]
                            for o in reps])
    log(f"[rank replicas] {json.dumps(rr)}")
    res["replicas"] = rr
    if (rr["lam"] > TOL_BATCH_LOOP["lam"] or rr["x"] > TOL_BATCH_LOOP["x"]
            or rr["h_rel"] > TOL_BATCH_LOOP["h_rel"]
            or not np.array_equal(got["pH"], one["pH"])
            or any(c["ww_pair"] != cfg.rebuild_every + 1
                   for c in rr["launches"])):
        fails.append("rank replicas")

    # [spatial]: world 1 and 2 against the single-process evaluation and
    # block
    for n, ranks in runs.items():
        sp = [o["spatial"] for o in ranks]
        fw = np.concatenate([o["fw"] for o in sp], axis=1)
        scale = max(1.0, float(np.abs(ref["fw"]).max()))
        # the force evaluation, then the block's (its start and a step's)
        ev = cfg.rebuild_every + 2
        e_run = sp[0]["obs"]["e_pot"]
        row = dict(
            world=n, layers=[o["layers"] for o in sp],
            fw_bitwise=bool(np.array_equal(fw, ref["fw"])),
            fw_scaled=_max_diff(fw, ref["fw"]) / scale,
            fs_scaled=_max_diff(sp[0]["fs"], ref["fs"])
            / max(1.0, float(np.abs(ref["fs"]).max())),
            e_pot_rel=abs(float(sp[0]["e_pot"]) - ref["e_pot"])
            / abs(ref["e_pot"]),
            dUdlam=_max_diff(sp[0]["dUdlam"], ref["dUdlam"]),
            run_lam=_max_diff(sp[0]["lam"], ref["lam"]),
            run_x=max(_max_diff(sp[0]["sx"], ref["sx"]), _max_diff(
                np.concatenate([o["wx"] for o in sp], axis=1), ref["wx"])),
            run_h_rel=float(np.max(np.abs(sp[0]["obs"]["h"] - ref["h"])
                                   / np.abs(ref["h"]))),
            run_e_rel=float(np.max(np.abs(e_run - ref["e_run"])
                                   / np.abs(ref["e_run"]))),
            ranks_alike=all(np.array_equal(o["lam"], sp[0]["lam"])
                            and np.array_equal(o["sx"], sp[0]["sx"])
                            for o in sp),
            overflow=any(o["overflow"] for o in sp),
            launches=[o["counts"] for o in sp],
            halo_per_eval=[o["stats"]["halo_exchange"]["calls"] / ev
                           for o in sp],
            halo_sends_per_eval=[o["stats"]["halo_exchange"]["sends"] / ev
                                 for o in sp],
            gathers_per_block=[o["stats"]["all_gather"]["calls"] for o in sp],
            all_reduce_per_step=[o["stats"]["all_reduce"]["calls"] / block
                                 for o in sp],
            comm_bytes_per_step=[sum(v["bytes"] for v in o["stats"].values())
                                 / block for o in sp],
            ms_per_step=[o["ms_per_step"] for o in sp],
            single_ms_per_step=ms_single,
            HA_rel=abs(float(sp[0]["HA"]) - ref["HA"]) / abs(ref["HA"]),
            hs_counts=[o["hs_counts"] for o in sp],
            # the kernel checks (none in a rehearsal on the CPU)
            k1_vs_plain=max(o.get("k1_vs_plain", 0.0) for o in sp),
            k2_vs_plain=max(o.get("k2_vs_plain", 0.0) for o in sp),
            k1_rows_bitwise=all(o.get("k1_rows_bitwise", True) for o in sp),
            k2_rows_bitwise=all(o.get("k2_rows_bitwise", True) for o in sp),
            slab_ms=[o.get("slab_ms") for o in sp])
        log(f"[spatial] {json.dumps(row)}")
        res["spatial"][n] = row
        want = {"ww_pair": ev, "ww_tally": 0,
                "spatial": {"ww_pair": ev, "ww_tally": 0}}
        ok = (all(c == want for c in row["launches"])
              and all(h["ww_tally"] == 1 and h["spatial"] == 1
                      and h["ww_pair"] == 0 for h in row["hs_counts"])
              and row["halo_per_eval"] == [1.0] * n
              and row["halo_sends_per_eval"] == [2.0 * (n > 1)] * n
              and row["gathers_per_block"] == [1] * n
              and (row["fw_bitwise"] if n == 1
                   else row["fw_scaled"] <= TOL_SPATIAL_F)
              and row["fs_scaled"] <= TOL_SPATIAL_F
              and row["e_pot_rel"] <= TOL_E_REL
              and row["run_lam"] <= TOL_SPATIAL_RUN["lam"]
              and row["run_x"] <= TOL_SPATIAL_RUN["x"]
              and row["run_h_rel"] <= TOL_SPATIAL_RUN["h_rel"]
              and row["HA_rel"] <= TOL_HS_REL and row["ranks_alike"]
              and not row["overflow"]
              and row["k1_vs_plain"] <= TOL_F_SCALED_K1
              and row["k2_vs_plain"] <= TOL_F_SCALED
              and row["k1_rows_bitwise"] and row["k2_rows_bitwise"])
        if not ok:
            fails.append(f"spatial at world {n}")
        res["slab_paths"][n], more = _slab_rows(n, runs[n], ref_paths, block)
        fails += more
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[ranks] {res['seconds']:.1f} s")
    if fails:
        raise RuntimeError(f"the multi-rank phases failed: {fails}")
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
    # the PME path relaxes from the build (400 FIRE + 800 steps: after
    # 600 its production tripped the drift flag) and measures half the
    # blocks; the DSF path, the same system in DSF, starts from its
    # relaxed state (DSF_START) and measures a quarter: depth cut so that
    # the script keeps well inside its time limit
    pme = md_path(dev, "pme", n_meas=10, profile="--profile" in sys.argv[1:])
    dsf = md_path(dev, "dsf", n_meas=5, start=(pme["ts"], pme["st"]),
                  **DSF_START)
    dsf["checks"].append(check_ww(dsf["ts"], dsf["st"], "dsf-production-tiles"))
    ts, st = pme["ts"], pme["st"]
    check_pme_on_cpu(ts, st, pme["pme"])
    # the tally and tiled Ewald paths hold λ at its end state
    # (held_lambda); the other phases that continue the state start λ
    # inside (0, 1) (interior_lambda) and run its dynamics
    st, cfg_t = held_lambda(st, pme["cfg"])
    st, t_counts, _, _ = tally_path(ts, st, pme["pme"], cfg_t)
    # passes forced where one pass fits: bitwise the one-pass outputs
    k1 = check_ww(ts, st, "pme-production-tiles", forced=(3,))
    k2 = check_tally(ts, st, "pme-production-tiles", forced=(3, 9))
    # K1 on a batch of six of the path's block-end states in one launch,
    # K2 on two of them: bitwise each state's own launch
    pme_batch = check_batches(ts, pme["block_states"],
                              "pme-production-tiles", k2_replicas=2)
    rex = pme_rex_path(ts, st, pme["pme"], pme["cfg"])
    # both kernels again on the production state at W 56 (A 168), the
    # width the first two slices timed them at
    ts56, st56 = retile(ts, st, max(56, ts.params.W))
    label = f"pme-production-state-A{3 * ts56.params.W}"
    check_ww(ts56, st56, label)
    check_tally(ts56, st56, label)
    # the reference engine and the tiled engine's Ewald branch, on the PME
    # path's system and production state
    ref = reference_path(pme["system"], ts, interior_lambda(st))
    tiled_vs_reference(dsf, pme, ref["ep"])
    ewald = ewald_tiled_path(ts, *held_lambda(st, pme["cfg"]), ref["ep"])
    reference_campaign(ref)
    npt = npt_path(ts, interior_lambda(st), pme["pme"], pme["cfg"])
    camp = campaign_path(dev)
    k1c = camp["k1"]
    # the multi-rank phases on the PME production state and the
    # campaign's merge inputs: world 1 over nccl, world 2 over gloo
    ranks = ranks_phase(ts, st, pme["pme"], pme["cfg"], rex, camp)
    sp1, sp2 = ranks["spatial"][1], ranks["spatial"][2]
    # the slab entries' launches of every spatial path on rank 0: the
    # [spatial] evaluation and block (K1) and compute_Hs (K2), then FIRE,
    # NPT and Ewald (K1) and the Ewald engine's compute_Hs (K2)
    slab_k1, slab_k2 = {}, {}
    for n, sp in ((1, sp1), (2, sp2)):
        rows = ranks["slab_paths"][n]
        slab_k1[n] = dict(run=sp["launches"][0]["spatial"]["ww_pair"],
                          **{ph: rows[ph]["launches"][0]["spatial"]["ww_pair"]
                             for ph in ("fire", "npt", "ewald")})
        slab_k2[n] = dict(
            hs=sp["hs_counts"][0]["spatial"],
            ewald_hs=rows["ewald"]["hs_launches"][0]["spatial"]["ww_tally"])
    hewl = hewl_path(dev)
    k1h, k2h, k1o = hewl["k1"], hewl["k2"], hewl["k1_occ"]
    cli = cli_path(dev)
    k1_errs = [c["f_abs_err"] for c in dsf["checks"] + pme["checks"]
               + [k1, k1c, k1h, k1o]]
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
             # one launch on a batch of R states of these tiles (R × the
             # single bound), and the launches of the batched campaign
             # production (one a batched force evaluation)
             batch_R=pme_batch["k1"]["R"],
             batch_graph_ms=pme_batch["k1"]["batch_graph_ms"],
             batch_bound_ms=pme_batch["k1"]["batch_bound_ms"],
             batch_launches=camp["counts"]["ww_pair"],
             batch_pairs_evaluated=pme_batch["k1"]["pairs_evaluated"],
             # the PME REX block (R 4, kspace_every 2, frozen metad bias)
             rex_launches=rex["ww_pair"]["launches"]["ww_pair"],
             # the same kernel on the campaign path and its tiles, alone
             # and on the batch of its six walkers
             campaign_launches=camp["counts"]["ww_pair"],
             campaign_batch_R=camp["k1_batch"]["R"],
             campaign_batch_graph_ms=camp["k1_batch"]["batch_graph_ms"],
             campaign_batch_bound_ms=camp["k1_batch"]["batch_bound_ms"],
             campaign_ms=k1c["ms"], campaign_plain_ms=k1c["plain_ms"],
             campaign_bound_ms=k1c["bound_ms"],
             campaign_pairs_needed=k1c["pairs_needed"],
             campaign_pairs_evaluated=k1c["pairs_evaluated"],
             # the NPT path (PME production state, live box): its launches
             npt_launches=npt["counts"]["ww_pair"],
             # the tiled Ewald path (PME production state, kspace_every 2)
             ewald_launches=ewald["counts"]["ww_pair"],
             # configs/hewl_like.json at W 208 (stencil in passes), and
             # the same state retiled to occupancy + 6 (one pass)
             hewl_launches=hewl["counts"]["ww_pair"],
             hewl_W=k1h["A"] // 3, hewl_passes=k1h["passes"],
             hewl_ms=k1h["ms"], hewl_plain_ms=k1h["plain_ms"],
             hewl_bound_ms=k1h["bound_ms"],
             hewl_pairs_needed=k1h["pairs_needed"],
             hewl_pairs_evaluated=k1h["pairs_evaluated"],
             hewl_occupancy_W=k1o["A"] // 3,
             hewl_occupancy_passes=k1o["passes"],
             hewl_occupancy_ms=k1o["ms"],
             hewl_occupancy_bound_ms=k1o["bound_ms"],
             hewl_occupancy_pairs_evaluated=k1o["pairs_evaluated"],
             # the CLI's run (and restart) on configs/hewl_like.json, and
             # its run on the LAMMPS deck written from that system
             cli_launches=cli["launches"]["run"],
             deck_launches=cli["launches"]["deck"],
             # the slab entry on the PME production tiles: launches of
             # the spatial paths (one force evaluation and a 12-step
             # block, FIRE, NPT, Ewald) on rank 0 at world 2 (3 owned
             # x-layers) and at world 1, and its device time there (CUDA
             # graph)
             spatial_launches=sum(slab_k1[2].values()),
             spatial_w1_launches=sum(slab_k1[1].values()),
             spatial_path_launches=slab_k1[2],
             slab_ms=sp2["slab_ms"][0]["ww_pair"],
             slab_w1_ms=sp1["slab_ms"][0]["ww_pair"],
             # the PME REX block with its replicas split over 2 ranks
             rank_replica_launches=ranks["replicas"]["launches"][0][
                 "ww_pair"]),
        dict(name="ww_tally", route="cuda",
             source="constant_ph_tpu_torch/csrc/ww_tally.cu",
             replaces="constant_ph_tpu/tiled/pallas_ww.py:88",
             launches=t_counts["ww_tally"],
             max_abs_err=max(k2["f_abs_err"], k2["phi_abs_err"],
                             k2h["f_abs_err"], k2h["phi_abs_err"]),
             ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None,
             stencil_bound_ms=k2["stencil_bound_ms"],
             pairs_needed=k2["pairs_needed"],
             pairs_evaluated=k2["pairs_evaluated"],
             # one launch on a batch of R states of the PME tiles, and the
             # launches of the batched PME REX block
             batch_R=pme_batch["k2"]["R"],
             batch_graph_ms=pme_batch["k2"]["batch_graph_ms"],
             batch_bound_ms=pme_batch["k2"]["batch_bound_ms"],
             batch_launches=rex["ww_tally"]["launches"]["ww_tally"],
             batch_pairs_evaluated=pme_batch["k2"]["pairs_evaluated"],
             # compute_Hs on the tiled Ewald engine
             ewald_tally_launches=ewald["tally_counts"]["ww_tally"],
             # at W 208 on the hewl production tiles (stencil in passes)
             hewl_W=k2h["A"] // 3, hewl_passes=k2h["passes"],
             hewl_ms=k2h["ms"], hewl_plain_ms=k2h["plain_ms"],
             hewl_bound_ms=k2h["bound_ms"],
             hewl_pairs_needed=k2h["pairs_needed"],
             hewl_pairs_evaluated=k2h["pairs_evaluated"],
             # the slab entry through compute_Hs on the PME and the Ewald
             # engine on rank 0 at world 2 and at world 1, and its device
             # time on the 3 (6) owned x-layers of the PME production
             # tiles
             spatial_launches=sum(slab_k2[2].values()),
             spatial_w1_launches=sum(slab_k2[1].values()),
             spatial_path_launches=slab_k2[2],
             slab_ms=sp2["slab_ms"][0]["ww_tally"],
             slab_w1_ms=sp1["slab_ms"][0]["ww_tally"])]
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(gpu_name_and_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
