"""Reciprocal-space electrostatics: factorized Ewald (port of
constant_ph_tpu/ops/ewald.py).

The structure factor is factorized per dimension,

    S(k) = Σ_i q_i e^{ik·r} = Σ_i q_i Ex[i,nx] Ey[i,ny] Ez[i,nz],

and every contraction is a tall-skinny matmul: T1 = Ey⊙Ez formed by
broadcast as (N, My·Mz), S = (q·Ex)ᵀ @ T1, and energy, forces and φ all
reduce to (N, My·Mz) @ (My·Mz, Mx) products. The matmuls run in full
float32 (TF32 off, float32 matmul precision "highest"; the engines set
both), where the JAX package asks for Precision.HIGH.

Conventions: U_rec = (2π/V)·C Σ_{k≠0} e^{−k²/4α²}/k² |S(k)|² with
C = QQR2E over a sphere of k; the half space is kept with doubled weights
(S(−k) = conj S(k)). The self energy −C·α/√π Σq² and the neutralising
background −C·π/(2α²V)(Σq)² are included; the real-space erfc part and
the excluded-pair compensation live in ops.pair (pp.alpha > 0). The box
is the one the tables were built for (no NPT).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from constant_ph_tpu_torch import resolve_device, units

_SQRT_PI = 1.7724538509055159


@dataclasses.dataclass
class EwaldParams:
    alpha: float
    nmax: tuple             # (nx, ny, nz) largest index a dimension
    kx: torch.Tensor        # (Mx,) 2π n / Lx, n = 0..nx
    ky: torch.Tensor        # (My,) n = −ny..ny
    kz: torch.Tensor        # (Mz,)
    A: torch.Tensor         # (Mx, My·Mz) C·(2π/V)·2e^{−k²/4α²}/k², 0-masked
    ky_idx: torch.Tensor    # (My·Mz,) int64 index maps of the fused yz axis
    kz_idx: torch.Tensor    # (My·Mz,)
    volume: float


def _s_of(accuracy):
    """s with e^{−s²}/s² ≈ accuracy (the JAX package's search)."""
    s = 1.0
    while np.exp(-s * s) / (s * s) > accuracy and s < 10:
        s += 0.01
    return s


def suggest_alpha(cutoff: float, accuracy: float = 1e-4) -> float:
    """Ewald splitting α from the real-space cutoff and force accuracy
    (erfc(α·rc) ≈ accuracy)."""
    return _s_of(accuracy) / cutoff


def make_ewald_params(box, alpha: float, *, accuracy: float = 1e-4,
                      kmax: int | None = None, dtype=torch.float32,
                      device="cuda") -> EwaldParams:
    """Host-side float64 precomputation of the k tables for a fixed box,
    cast once to ``dtype``."""
    dev = resolve_device(device)
    box = np.asarray(box, dtype=np.float64)
    V = float(np.prod(box))
    if kmax is None:
        k_cut = 2.0 * alpha * _s_of(accuracy)
        nmax = tuple(int(np.ceil(k_cut * L / (2 * np.pi))) for L in box)
    else:
        nmax = (kmax, kmax, kmax)
        k_cut = 2 * np.pi * kmax / box.min()

    ns = [np.arange(0, nmax[0] + 1),
          np.arange(-nmax[1], nmax[1] + 1),
          np.arange(-nmax[2], nmax[2] + 1)]
    kx, ky, kz = (2 * np.pi * n / L for n, L in zip(ns, box))
    KX, KY, KZ = np.meshgrid(kx, ky, kz, indexing="ij")
    NX, NY, NZ = np.meshgrid(ns[0], ns[1], ns[2], indexing="ij")
    k2 = KX**2 + KY**2 + KZ**2
    mask = (k2 > 1e-12) & (np.sqrt(k2) <= k_cut + 1e-12)
    # one of each ±k pair, weight 2: nx > 0; on nx = 0, ny > 0; on
    # nx = ny = 0, nz > 0
    mask &= (NX > 0) | ((NX == 0) & (NY > 0)) \
        | ((NX == 0) & (NY == 0) & (NZ > 0))
    with np.errstate(divide="ignore", invalid="ignore"):
        A = np.where(mask, 2.0 * np.exp(-k2 / (4 * alpha * alpha)) / k2, 0.0)
    A *= units.QQR2E * 2.0 * np.pi / V

    My, Mz = len(ky), len(kz)
    yz_y, yz_z = np.meshgrid(np.arange(My), np.arange(Mz), indexing="ij")

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    return EwaldParams(
        alpha=float(alpha), nmax=nmax, kx=t(kx), ky=t(ky), kz=t(kz),
        A=t(A.reshape(len(kx), My * Mz)),
        ky_idx=torch.as_tensor(yz_y.reshape(-1), device=dev),
        kz_idx=torch.as_tensor(yz_z.reshape(-1), device=dev),
        volume=V)


def ewald_recip(x, q, ep: EwaldParams):
    """Reciprocal + self + background energy, forces, φ = ∂U/∂q and the
    per-atom tally: (E, F (N, 3), φ (N,), eatom (N,)); a batch, x (R, N,
    3) and q (R, N), gives E (R,) and the rest with a leading R."""
    e, f, phi, eatom = ewald_recip_xd(tuple(x[..., d] for d in range(3)),
                                      q, ep)
    return e, torch.stack(f, dim=-1), phi, eatom


def ewald_recip_xd(xd, q, ep: EwaldParams):
    """ewald_recip on a tuple of 3 per-dimension (N,) coordinate arrays
    (the tiled path's layout); forces come back as a per-dimension
    tuple. Coordinates and charges may carry leading replica axes, (…, N):
    energies are then (…,), one a replica."""
    (exr, exi), (eyr, eyi), (ezr, ezi) = (
        (torch.cos(a), torch.sin(a))
        for a in (xd[d][..., :, None] * k
                  for d, k in enumerate((ep.kx, ep.ky, ep.kz))))

    # T1 = Ey ⊙ Ez by broadcast outer products, (…, N, My·Mz)
    lead_n = q.shape
    My, Mz = eyr.shape[-1], ezr.shape[-1]
    t1r = (eyr[..., :, None] * ezr[..., None, :]
           - eyi[..., :, None] * ezi[..., None, :]).reshape(
               lead_n + (My * Mz,))
    t1i = (eyr[..., :, None] * ezi[..., None, :]
           + eyi[..., :, None] * ezr[..., None, :]).reshape(
               lead_n + (My * Mz,))

    # S[nx, yz] = Σ_i q_i Ex[i,nx] T1[i,yz], with the Mx-side operands
    # stacked so each (N, My·Mz) array is read once a matmul
    Mx = exr.shape[-1]
    qex = torch.cat([q[..., None] * exr, q[..., None] * exi],
                    dim=-1)                                # (…, N, 2Mx)
    sr_si_r = qex.transpose(-1, -2) @ t1r                  # (…, 2Mx, MyMz)
    sr_si_i = qex.transpose(-1, -2) @ t1i
    sr = sr_si_r[..., :Mx, :] - sr_si_i[..., Mx:, :]
    si = sr_si_i[..., :Mx, :] + sr_si_r[..., Mx:, :]

    A = ep.A
    e_rec = torch.sum(A * (sr * sr + si * si), dim=(-2, -1))

    # G = A·conj(S) and its k_y-, k_z-weighted variants in one operand;
    # k_x folds into the Ex contraction afterwards
    ky_yz = torch.repeat_interleave(ep.ky, Mz)     # (MyMz,), ij order
    kz_yz = ep.kz.repeat(My)
    gr0, gi0 = A * sr, -(A * si)
    Gs = torch.cat([gr0, gi0, ky_yz * gr0, ky_yz * gi0,
                    kz_yz * gr0, kz_yz * gi0], dim=-2)    # (…, 6Mx, MyMz)
    R = t1r @ Gs.transpose(-1, -2)                 # (…, N, 6Mx)
    I = t1i @ Gs.transpose(-1, -2)

    def w_pair(s):
        wr = R[..., s * Mx:(s + 1) * Mx] - I[..., (s + 1) * Mx:(s + 2) * Mx]
        wi = I[..., s * Mx:(s + 1) * Mx] + R[..., (s + 1) * Mx:(s + 2) * Mx]
        return wr, wi

    w0r, w0i = w_pair(0)
    phi = 2.0 * torch.sum(exr * w0r - exi * w0i, dim=-1)
    # F_d = 2 q Σ_k A·k_d·Im[conj(S)·P]
    fx = 2.0 * q * torch.sum(ep.kx * (exr * w0i + exi * w0r), dim=-1)
    wyr, wyi = w_pair(2)
    fy = 2.0 * q * torch.sum(exr * wyi + exi * wyr, dim=-1)
    wzr, wzi = w_pair(4)
    fz = 2.0 * q * torch.sum(exr * wzi + exi * wzr, dim=-1)

    # self energy + neutralising background
    C = units.QQR2E
    qsum = torch.sum(q, dim=-1)
    e_self = -C * ep.alpha / _SQRT_PI * torch.sum(q * q, dim=-1)
    e_bg = -C * np.pi / (2.0 * ep.alpha**2 * ep.volume) * qsum * qsum
    phi = phi - 2.0 * C * ep.alpha / _SQRT_PI * q \
        - C * np.pi / (ep.alpha**2 * ep.volume) * qsum[..., None]
    return e_rec + e_self + e_bg, (fx, fy, fz), phi, 0.5 * q * phi


def make_kspace_fn(ep: EwaldParams):
    """Engine hook (x, q, box) → (E, F, φ, eatom), one replica or a batch
    (ewald_recip); the box is the one the tables were built for."""
    def fn(x, q, box):
        return ewald_recip(x, q, ep)
    return fn
