"""Shared scalar interaction kernels (used by ops.pair and tiled.forces).

One Coulomb formula covers all styles:
- 'cut' with α=0: plain truncation; α>0: Ewald real space (erfc), with the
  excluded-pair −(1−s)·erf compensation built into the screening factor;
- 'dsf': damped-shifted-force (Fennell–Gezelter), energy and force
  continuous at the cutoff.

All functions return per-charge-pair kernels: u(r) such that E = C·qq·u and
w(r) such that F = C·qq·w·dx.
"""
from __future__ import annotations

import math

import torch

TWO_OVER_SQRT_PI = 1.1283791670955126
R2_MIN = 1.0e-4  # (0.01 Å)² floor keeps r⁻¹² finite in f32 for any input


def coul_kernel(r2, r, inv_r2, scoul, *, alpha: float, style: str, rc: float):
    """Returns (u_r, w_r): energy and force/r per unit C·q_i·q_j."""
    if alpha > 0.0:
        ar = alpha * r
        erfc_ar = torch.special.erfc(ar)
        gauss = TWO_OVER_SQRT_PI * ar * torch.exp(-ar * ar)
    else:
        erfc_ar = torch.ones_like(r)
        gauss = torch.zeros_like(r)
    if style == "dsf":
        # standalone damped electrostatics: no reciprocal space exists, so
        # special pairs are simply SCALED (no erf compensation)
        erfc_rc = math.erfc(alpha * rc)
        e_sh = erfc_rc / rc
        f_sh = erfc_rc / rc**2 + (
            TWO_OVER_SQRT_PI * alpha * math.exp(-((alpha * rc) ** 2)) / rc
        )
        u_r = scoul * (erfc_ar / r - e_sh + f_sh * (r - rc))
        w_r = scoul * ((erfc_ar + gauss) * inv_r2 / r - f_sh / r)
    else:
        # 'cut': plain truncation (α=0, screen = s) or Ewald real space
        # (α>0) where excluded pairs need the −(1−s)·erf compensation for
        # what reciprocal space adds back
        u_r = (erfc_ar - (1.0 - scoul)) / r
        w_r = (erfc_ar + gauss - (1.0 - scoul)) * inv_r2 / r
    return u_r, w_r


def lj_kernel(inv_r2, c6, c12, e_shift):
    """Returns (e, f_over_r2): LJ energy and force/r² (×dx gives force)."""
    inv_r6 = inv_r2 * inv_r2 * inv_r2
    e = (c12 * inv_r6 - c6) * inv_r6 - e_shift
    f = (12.0 * c12 * inv_r6 - 6.0 * c6) * inv_r6 * inv_r2
    return e, f
