"""Holonomic constraints: M-SHAKE / M-RATTLE for rigid triatomics (port of
constant_ph_tpu/ops/constraints.py). Every molecule is solved in parallel
with Cramer 3×3 solves; the incidence matrix is ±1/0, so bond vectors are
plain differences and no matmul (and no TF32) is involved. Positions and
velocities may carry leading replica axes (x (…, N, 3), box (…, 3))."""
from __future__ import annotations

import copy

import numpy as np
import torch

from constant_ph_tpu_torch.state import min_image

# constraint incidence matrix: rows = constraints (0-1, 0-2, 1-2),
# cols = atoms; J_c x = Σ_t C[c,t] x_t is the bond vector of constraint c.
_C = np.array([[1.0, -1.0, 0.0],
               [1.0, 0.0, -1.0],
               [0.0, 1.0, -1.0]])


def solve3_components(a00, a01, a02, a10, a11, a12, a20, a21, a22,
                      b0, b1, b2):
    """Cramer 3×3 solve on component tensors (any broadcastable shape).
    Shared with the tiled SHAKE (tiled/shake.py)."""
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    # degenerate system (violently distorted molecule): zero update
    # instead of a huge one — the next iteration/step recovers
    inv_det = torch.where(torch.abs(det) > 1e-6, 1.0 / det,
                          torch.zeros_like(det))
    x0 = (b0 * c00 + b1 * (a02 * a21 - a01 * a22)
          + b2 * (a01 * a12 - a02 * a11)) * inv_det
    x1 = (b0 * c01 + b1 * (a00 * a22 - a02 * a20)
          + b2 * (a02 * a10 - a00 * a12)) * inv_det
    x2 = (b0 * c02 + b1 * (a01 * a20 - a00 * a21)
          + b2 * (a00 * a11 - a01 * a10)) * inv_det
    return x0, x1, x2


def _solve3(A, b):
    """Batched 3×3 solve: A (..., 3, 3), b (..., 3) → (..., 3)."""
    x0, x1, x2 = solve3_components(
        A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
        A[..., 1, 0], A[..., 1, 1], A[..., 1, 2],
        A[..., 2, 0], A[..., 2, 1], A[..., 2, 2],
        b[..., 0], b[..., 1], b[..., 2])
    return torch.stack([x0, x1, x2], dim=-1)


def _bond_vectors(xm):
    """(M,3atoms,3) → (M,3constraints,3): rows (0-1, 0-2, 1-2) of _C."""
    return torch.stack(
        [xm[..., 0, :] - xm[..., 1, :],
         xm[..., 0, :] - xm[..., 2, :],
         xm[..., 1, :] - xm[..., 2, :]], dim=-2)


def _gram(a, b):
    """A[m,c,d] = Σ_x a[m,c,x]·b[m,d,x] as elementwise products."""
    return torch.sum(a[..., :, None, :] * b[..., None, :, :], dim=-1)


def _apply_ct(k, s, inv_m):
    """dx[m,t,x] = (1/m_t) Σ_c k_c C[c,t] s[m,c,x] with C = ±1/0 rows."""
    k0 = k[..., 0:1]
    k1 = k[..., 1:2]
    k2 = k[..., 2:3]
    dx0 = k0 * s[..., 0, :] + k1 * s[..., 1, :]
    dx1 = -k0 * s[..., 0, :] + k2 * s[..., 2, :]
    dx2 = -k1 * s[..., 1, :] - k2 * s[..., 2, :]
    return inv_m[..., None] * torch.stack([dx0, dx1, dx2], dim=-2)


def mshake_delta(xm0, xr, inv_m, W, d2, n_newton):
    """M-SHAKE core: displacement that puts (M,3,3) molecule coords onto
    the constraint manifold along reference bond directions."""
    s_ref = _bond_vectors(xr)
    xm = xm0
    for _ in range(n_newton):
        s = _bond_vectors(xm)
        g = 0.5 * (torch.sum(s * s, dim=-1) - d2)
        k = _solve3(W * _gram(s, s_ref), -g)
        dx = _apply_ct(k, s_ref, inv_m)
        # trust region: a near-singular geometry must not catapult atoms
        norm = torch.sqrt(torch.sum(dx * dx, dim=-1, keepdim=True) + 1e-20)
        xm = xm + dx * torch.clamp(0.5 / norm, max=1.0)
    return xm - xm0


def mrattle_dv(xm, vm, inv_m, W):
    """M-RATTLE core: velocity change removing constraint-direction
    components for (M,3,3) molecules."""
    s = _bond_vectors(xm)
    jv = torch.sum(s * _bond_vectors(vm), dim=-1)
    k = _solve3(W * _gram(s, s), -jv)
    return _apply_ct(k, s, inv_m)


class RigidTriatomic:
    """Constraints for M identical triatomic molecules.

    triplets: (M, 3) atom indices (center, satellite1, satellite2).
    Constraints: |r01| = d01, |r02| = d01, |r12| = d12."""

    def __init__(self, triplets, masses, d01: float, d12: float, *,
                 n_newton: int = 6, dtype=torch.float32, device="cuda"):
        triplets = np.asarray(triplets, dtype=np.int64)
        self.n_newton = n_newton
        inv_m = 1.0 / np.asarray(masses)[triplets]          # (M, 3)
        self.triplets = torch.as_tensor(triplets, device=device)
        self.d2 = np.array([d01 * d01, d01 * d01, d12 * d12])
        self._d2 = torch.as_tensor(self.d2, dtype=dtype, device=device)
        # W[c',c] = Σ_t C[c',t] C[c,t] / m_t — per-molecule (3, 3)
        self.W = torch.as_tensor(
            np.einsum("ct,dt,mt->mcd", _C, _C, inv_m), dtype=dtype,
            device=device)
        self.inv_m = torch.as_tensor(inv_m, dtype=dtype, device=device)

    @property
    def n_constraints(self) -> int:
        return 3 * self.triplets.shape[0]

    def to(self, device) -> "RigidTriatomic":
        """A copy with its tables on ``device``."""
        out = copy.copy(self)
        for name in ("triplets", "_d2", "W", "inv_m"):
            setattr(out, name, getattr(self, name).to(device))
        return out

    def _gather_local(self, x, box):
        """Molecule positions unwrapped into the center atom's image."""
        xm = x[..., self.triplets, :]         # (…, M, 3, 3)
        center = xm[..., :1, :]
        return center + min_image(xm - center, box[..., None, None, :])

    def positions(self, x_ref, x, v, box, dt):
        """M-SHAKE: moves x onto the constraint manifold along the
        reference bond directions and adds displacement/dt to v."""
        delta = mshake_delta(self._gather_local(x, box),
                             self._gather_local(x_ref, box),
                             self.inv_m, self.W, self._d2, self.n_newton)
        flat = self.triplets.reshape(-1)
        delta = delta.reshape(delta.shape[:-3] + (-1, 3))
        return (x.index_add(-2, flat, delta),
                v.index_add(-2, flat, delta / dt))

    def velocities(self, x, v, box):
        """M-RATTLE: one exact 3×3 solve removes all velocity components
        along constraint directions."""
        dv = mrattle_dv(self._gather_local(x, box), v[..., self.triplets, :],
                        self.inv_m, self.W)
        return v.index_add(-2, self.triplets.reshape(-1),
                           dv.reshape(dv.shape[:-3] + (-1, 3)))
