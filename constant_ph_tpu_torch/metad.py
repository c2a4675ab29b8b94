"""Well-tempered metadynamics on the λ coordinates (port of
constant_ph_tpu/metad.py; same formulas and estimators).

Per titratable site s, independent 1-D well-tempered hills:

  V_s(λ) ← V_s(λ) + h0·exp(−V_s(λ_s)/((γ−1)kT)) · exp(−(λ−λ_s)²/2σ²)
  F_s(λ) = −γ/(γ−1) · V_s(λ)            (well-tempered estimator)
  x_deprot(s) = ∫_{λ>1/2} e^{−βF_s} / ∫ e^{−βF_s}

The bias rides on a fixed λ grid as (V, dV/dλ) value tables, both updated
analytically on deposit, so the in-step bias force is a linear
interpolation (``lookup``). Tables are (S, nbins) tensors, (R, S, nbins)
for a batch of R walkers with λ (R, S) (``lookup``, ``deposit``); every
function runs on the device of its inputs and never reads a value back to
the host.

The pooled estimators take the switching slope as an argument; callers
pass the installed ``BiasParams.switch_slope`` (the JAX package's
estimators hard-set 50.0, its default).

The cross-rank merges (``make_mesh_walker_merge``,
``make_mesh_group_merge``) fold each rank's walkers with deposit_frozen
and sum the deltas with one all-reduce (parallel/comm.py).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from constant_ph_tpu_torch import profiling, resolve_device, units
from constant_ph_tpu_torch.parallel import comm


def _grid_np(lo: float, hi: float, nbins: int) -> np.ndarray:
    """The λ grid in float32, bit for bit the JAX package's eager
    ``MetadParams.grid()`` (jnp.linspace as XLA:CPU compiles it:
    lo·(1 − i·r) + i·(hi·r) with r = 1/(nbins − 1), the last product
    fused). Which node lands on which side of the λ = 1/2 basin split
    depends on the last bit: at lo −0.1, hi 1.1, nbins 241 the middle
    node is 0.50000006 and counts as deprotonated."""
    f32, f64 = np.float32, np.float64
    div = nbins - 1
    i = np.arange(div, dtype=f32)
    r = f32(1.0 / div)
    one_minus = (f32(1.0) - i * r).astype(f32)
    a = (f32(lo) * one_minus).astype(f32)
    # fused multiply-add: the product i·(hi·r) is exact in float64
    out = (f64(i) * f64(f32(hi) * r) + f64(a)).astype(f32)
    return np.concatenate([out, [f32(hi)]]).astype(f32)


@dataclasses.dataclass(frozen=True)
class MetadParams:
    """Static metadynamics configuration."""

    lo: float = -0.1
    hi: float = 1.1
    nbins: int = 121
    sigma: float = 0.05
    # initial hill height (kcal/mol); the WT factor damps it as V grows
    h0: float = 0.1
    # well-tempered bias factor γ > 1; size it to the barrier:
    # γ ≳ 1 + F_barrier/kT (constant_ph_tpu/metad.py)
    gamma: float = 8.0
    T: float = 300.0
    # one hill whenever a run block crosses a multiple of this many steps
    stride: int = 100

    @property
    def dx(self) -> float:
        return (self.hi - self.lo) / (self.nbins - 1)

    def grid(self, device="cpu", dtype=torch.float32) -> torch.Tensor:
        """The grid on ``device``, made once per device and dtype (a host
        copy inside a run block would wait for the device)."""
        return _constant("grid", (self.lo, self.hi, self.nbins),
                         _device(device), dtype)


def _device(device) -> torch.device:
    # "cuda" and "cuda:0" name one device, and share one cached constant
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@functools.lru_cache(maxsize=None)
def _constant(name: str, args: tuple, device: torch.device,
              dtype) -> torch.Tensor:
    """A grid-sized constant on a device, made once; callers never write
    into it. "grid": the λ grid of (lo, hi, nbins); "log_tw": the log
    trapezoid weights of (nbins,)."""
    if name == "grid":
        a = _grid_np(*args)
    else:
        a = np.ones(args, np.float32)
        a[[0, -1]] = 0.5
        a = np.log(a)
    return torch.as_tensor(a, dtype=dtype, device=device)


def init_tables(n_sites: int, p: MetadParams, dtype=torch.float32,
                device="cuda"):
    """Zeroed (V, dV) bias tables, shape (S, nbins) each."""
    z = torch.zeros((n_sites, p.nbins), dtype=dtype,
                    device=resolve_device(device))
    return z, z.clone()


def lookup(V, dV, lam, p: MetadParams):
    """Linear-interpolated (V_s(λ_s), dV_s/dλ(λ_s)) per site.

    λ outside [lo, hi] clamps to the edge value with ZERO slope: after a
    long fill the edge bins carry steep hill flanks, and the edge
    derivative would hand an escaped walker a constant outward force that
    the saturated erf walls do not oppose (constant_ph_tpu/metad.py
    ``lookup`` has the campaign history)."""
    u = (lam - p.lo) / p.dx
    i0 = torch.clamp(torch.floor(u).to(torch.int64), 0, p.nbins - 2)
    f = torch.clamp(u - i0.to(lam.dtype), 0.0, 1.0)

    def take(A, i):
        return torch.gather(A, -1, i[..., None])[..., 0]

    v = take(V, i0) * (1.0 - f) + take(V, i0 + 1) * f
    dv = take(dV, i0) * (1.0 - f) + take(dV, i0 + 1) * f
    inside = (lam >= p.lo) & (lam <= p.hi)
    return v, torch.where(inside, dv, torch.zeros_like(dv))


def _hills(lam, h, p: MetadParams, grid):
    """(h·g, h·dg/dλ) of hills of height h (…,) at λ (…,) on the grid."""
    x = grid - lam[..., None]
    g = torch.exp(-(x * x) / (2.0 * p.sigma * p.sigma))
    return h[..., None] * g, h[..., None] * (-x / (p.sigma * p.sigma)) * g


def _height(v_at, p: MetadParams):
    kT = units.BOLTZ * p.T
    return p.h0 * torch.exp(-v_at / ((p.gamma - 1.0) * kT))


def deposit(V, dV, lam, p: MetadParams):
    """One well-tempered hill per site at its current λ (analytic V and
    dV/dλ updates, so the force table stays the derivative of the energy
    table)."""
    v_at, _ = lookup(V, dV, lam, p)
    hg, hdg = _hills(lam, _height(v_at, p), p, p.grid(V.device, V.dtype))
    return V + hg, dV + hdg


@profiling.spanned("cph.metad.deposit_many")
def deposit_many(V, dV, lam_seq, p: MetadParams):
    """Deposit a time-ordered sequence of hills (K, S) into shared tables,
    each hill's well-tempered height computed against the progressively
    updated table (the multiple-walkers merge)."""
    profiling.count("hill_merges", len(lam_seq))
    for lam in lam_seq:
        V, dV = deposit(V, dV, lam, p)
    return V, dV


def free_energy(V, p: MetadParams):
    """F_s(λ) = −γ/(γ−1)·V_s(λ), shifted so min F = 0 per site."""
    F = -(p.gamma / (p.gamma - 1.0)) * V
    return F - torch.amin(F, dim=1, keepdim=True)


def _basin_logZ(V, p: MetadParams):
    """Per-site log basin sums (log Σ_dep w, log Σ_prot w) of F_s(λ)
    split at λ = 1/2, in log space (the plain ratio overflows float32
    once the fill passes ~50 kcal)."""
    return _basin_logZ_F(free_energy(V, p), p)


def _basin_logZ_F(F, p: MetadParams):
    """_basin_logZ on an explicit free-energy profile F (…, nbins):
    trapezoid weights on the uniform grid, −inf outside each basin (a
    basin with no node gives −inf, not NaN)."""
    kT = units.BOLTZ * p.T
    logw = -F / kT + _constant("log_tw", (p.nbins,), _device(F.device),
                               F.dtype)
    dep = p.grid(F.device, F.dtype) > 0.5
    neg = torch.full_like(logw, -math.inf)
    lz_dep = torch.logsumexp(torch.where(dep, logw, neg), dim=-1)
    lz_prot = torch.logsumexp(torch.where(dep, neg, logw), dim=-1)
    return lz_dep, lz_prot


def deprotonated_fraction(V, p: MetadParams):
    """Per-site ⟨deprotonated⟩: basin-integrated Boltzmann weights of
    F_s(λ) split at λ = 1/2."""
    lz_dep, lz_prot = _basin_logZ(V, p)
    return torch.sigmoid(lz_dep - lz_prot)


def delta_f_sites(V, p: MetadParams):
    """Per-site deprotonation free energy ΔF_s = −kT·ln(x/(1−x))
    (kcal/mol; negative ⇒ deprotonated favoured)."""
    kT = units.BOLTZ * p.T
    lz_dep, lz_prot = _basin_logZ(V, p)
    return -kT * (lz_dep - lz_prot)


def _switch(p: MetadParams, switch_slope, like):
    grid = p.grid(like.device, like.dtype)
    return torch.sigmoid(switch_slope * (grid - 0.5))


def _kT_ln10(p: MetadParams) -> float:
    # kT·ln 10 as the JAX package forms it: both factors and their
    # product rounded to float32
    f32 = np.float32
    return float(f32(f32(units.BOLTZ * p.T) * f32(math.log(10.0))))


def pooled_intrinsic_profile(V, pK, pH, p: MetadParams,
                             switch_slope: float = 50.0):
    """Minimum-variance intrinsic free-energy profiles F0_s(λ), pooled
    across pH walkers: subtract each walker's analytic pH driving term
    kT·ln10·(pK_s − pH)·f(λ), min-shift, average over walkers.

    V: (G, S, nbins), one table per pH group; pK: (S,); pH: (G,).
    ``switch_slope`` must be the installed BiasParams.switch_slope.
    Returns F0: (S, nbins), min-shifted per site."""
    f_lam = _switch(p, switch_slope, V)                         # (B,)
    F = -(p.gamma / (p.gamma - 1.0)) * V                        # (G,S,B)
    drive = _kT_ln10(p) * (pK[None, :] - pH[:, None])           # (G,S)
    F0 = F - drive[:, :, None] * f_lam[None, None, :]
    F0 = F0 - torch.amin(F0, dim=2, keepdim=True)
    F0 = torch.mean(F0, dim=0)
    return F0 - torch.amin(F0, dim=1, keepdim=True)


def fraction_at_ph(F0, pK, pH, p: MetadParams, switch_slope: float = 50.0):
    """Deprotonated fraction at an arbitrary pH from pooled intrinsic
    profiles: basin-integrate F0_s(λ) + kT·ln10·(pK_s − pH)·f(λ).
    F0: (S, nbins); pH: scalar. Returns (S,)."""
    f_lam = _switch(p, switch_slope, F0)
    drive = _kT_ln10(p) * (pK - pH)[:, None] * f_lam[None, :]
    lz_dep, lz_prot = _basin_logZ_F(F0 + drive, p)
    return torch.sigmoid(lz_dep - lz_prot)


def retilt_profile(F0, dG_ref_from, dG_ref_to, p: MetadParams,
                   switch_slope: float = 50.0):
    """Intrinsic profiles at another ΔG_ref, analytically: ΔG_ref enters
    the λ Hamiltonian only as −ΔG_ref·f(λ), so the landscape converged at
    ``dG_ref_from`` is the one at ``dG_ref_to`` plus
    (dG_ref_from − dG_ref_to)·f(λ). dG_ref_from/to: scalars or (S,).
    Returns the retilted (S, nbins) profiles, min-shifted per site."""
    f_lam = _switch(p, switch_slope, F0)

    def t(a):
        return torch.as_tensor(a, dtype=F0.dtype, device=F0.device)

    delta = torch.atleast_1d(t(dG_ref_from) - t(dG_ref_to))
    delta = torch.broadcast_to(delta, (F0.shape[0],))
    F = F0 + delta[:, None] * f_lam[None, :]
    return F - torch.amin(F, dim=1, keepdim=True)


def pooled_delta_f(F0, p: MetadParams):
    """Intrinsic basin ΔF_s (dep − prot, kcal/mol) of pooled profiles;
    the mean over sites is the fixed-point ΔG_ref correction."""
    kT = units.BOLTZ * p.T
    lz_dep, lz_prot = _basin_logZ_F(F0, p)
    return -kT * (lz_dep - lz_prot)


def deposit_frozen(V, dV, lam_seq, p: MetadParams):
    """Hill deltas (ΔV, ΔdV) of a (K, S) hill sequence against the frozen
    base table: every height is computed against (V, dV), so deltas of
    different walkers are additive and free of order (the delayed-bias
    merge)."""
    v_at = torch.stack([lookup(V, dV, lam, p)[0] for lam in lam_seq])
    hg, hdg = _hills(lam_seq, _height(v_at, p), p, p.grid(V.device,
                                                          V.dtype))
    return torch.sum(hg, dim=0), torch.sum(hdg, dim=0)


def make_mesh_walker_merge(group, p: MetadParams):
    """Cross-rank multiple-walkers hill merge (the JAX package's
    ``make_mesh_walker_merge(mesh, axis, p)``; here ``(group, p)``: the
    mesh axis becomes a torch.distributed process group, None the default
    group). Returns merge(V, dV, seq): (V, dV) the shared (S, nbins)
    tables, the same on every rank, and seq (W, K, S) every walker's λ
    snapshots, the same on every rank; each rank folds its contiguous
    W / world walkers with deposit_frozen and the deltas are summed over
    the ranks. The G = 1 case of make_mesh_group_merge."""
    grp = make_mesh_group_merge(group, p)

    def merge(V, dV, seq):
        Vn, dVn = grp(V[None], dV[None], seq[None])
        return Vn[0], dVn[0]

    return merge


def make_mesh_group_merge(group, p: MetadParams):
    """Cross-rank hill merge of G pH groups at once (the JAX package's
    ``make_mesh_group_merge(mesh, axis, p)``, shard_map + psum; here
    ``(group, p)``, a torch.distributed process group or None for the
    default group). Returns merge(V, dV, seq): V/dV (G, S, nbins) shared
    tables and seq (G, W, K, S) per-walker λ snapshots, both the same on
    every rank (the JAX package's global arrays); the walker axis is
    split into contiguous slices in rank order, as its sharding splits
    it, and W % world != 0 is refused. Each rank folds its walkers' hills
    with deposit_frozen against the frozen tables, and the (G, S, nbins)
    ΔV and ΔdV of all groups go through one all-reduce (the campaign
    driver's MPI_Allreduce analog, fix_constant_pH.cpp:274). Returns
    (V + ΔV, dV + ΔdV), the serial frozen merge up to float addition
    order."""
    def merge(V, dV, seq):
        n, r = comm.world(group), comm.rank(group)
        W = seq.shape[1]
        if W % n:
            raise ValueError(f"{W} walkers do not split over {n} ranks")
        own = seq[:, r * (W // n):(r + 1) * (W // n)]
        deltas = []
        for g in range(V.shape[0]):
            deltas.append(torch.stack(deposit_frozen(
                V[g], dV[g], own[g].reshape(-1, seq.shape[-1]), p)))
        tot = comm.all_reduce_sum(torch.stack(deltas, dim=1), group)
        return V + tot[0], dV + tot[1]

    return merge
