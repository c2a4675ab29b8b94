"""SHAKE/RATTLE on tile-resident rigid water (port of
constant_ph_tpu/tiled/shake.py).

Water tiles are (3dims, G, 3W) with molecules in consecutive slot triples,
so per-atom views are strided slices ``w[..., a::3]`` of shape (3, G, W)
and every quantity in the solve is a (G, W) tensor. A batch of replicas
adds a leading R to every array (box (R, 3)); the arithmetic is
elementwise, so each replica's result is its own solve's. The constraint math
matches ops.constraints (M-SHAKE Newton with the reference-direction
Jacobian, exact M-RATTLE projection, Cramer 3×3 solves); bond vectors are
plain differences, so no matmul (and no TF32) is involved. Empty slots are
masked after the solve.
"""
from __future__ import annotations

import numpy as np
import torch

from constant_ph_tpu_torch import profiling
from constant_ph_tpu_torch.ops.constraints import _C, solve3_components
from constant_ph_tpu_torch.state import min_image
from constant_ph_tpu_torch.tiled.layout import WaterModel


def _dot3(a, b):
    """Σ over the dim-3 axis of two (…, 3, G, W) tensors → (…, G, W)."""
    a0, a1, a2 = a.unbind(-3)
    b0, b1, b2 = b.unbind(-3)
    return a0 * b0 + a1 * b1 + a2 * b2


def _atoms(w):
    """(…, 3, G, 3W) → three (…, 3, G, W) per-atom views (O, H1, H2)."""
    return w[..., 0::3], w[..., 1::3], w[..., 2::3]


def _merge(a0, a1, a2):
    """three (…, 3, G, W) → (…, 3, G, 3W) with the interleaved slot
    layout."""
    m = torch.stack([a0, a1, a2], dim=-1)          # (…, 3, G, W, 3)
    return m.reshape(m.shape[:-2] + (-1,))


def _bonds(x0, x1, x2):
    return x0 - x1, x0 - x2, x1 - x2


class TiledWaterShake:
    def __init__(self, wm: WaterModel, n_newton: int = 10):
        self.n_newton = n_newton
        inv_m = 1.0 / np.array(wm.mass_pattern)
        self.inv_m = tuple(float(v) for v in inv_m)
        # W3[c,e] = Σ_t C[c,t] C[e,t] / m_t for C rows (0-1, 0-2, 1-2)
        self.W3 = np.einsum("ct,dt,t->cd", _C, _C, inv_m)
        self.d2 = (wm.d_OH ** 2, wm.d_OH ** 2, wm.d_HH ** 2)

    @staticmethod
    def _unwrap(w, box):
        """satellites into the O image (molecules straddle PBC seams)."""
        x0, x1, x2 = _atoms(w)
        b = box[..., :, None, None]
        return x0, x0 + min_image(x1 - x0, b), x0 + min_image(x2 - x0, b)

    @profiling.spanned("cph.shake")
    def positions(self, wx_ref, wx, wv, box, dt, wvalid):
        im0, im1, im2 = self.inv_m
        W3 = self.W3
        x0, x1, x2 = self._unwrap(wx, box)
        sr0, sr1, sr2 = sr = _bonds(*self._unwrap(wx_ref, box))

        def clamp(dx):
            # trust region: cap each atom's per-iteration move at 0.5 Å
            norm = torch.sqrt(_dot3(dx, dx) + 1e-20)[..., None, :, :]
            return dx * torch.clamp(0.5 / norm, max=1.0)

        d0 = torch.zeros_like(x0)
        d1 = torch.zeros_like(x1)
        d2_ = torch.zeros_like(x2)
        for _ in range(self.n_newton):
            s = _bonds(x0 + d0, x1 + d1, x2 + d2_)
            g = [0.5 * (_dot3(s[c], s[c]) - self.d2[c]) for c in range(3)]
            A = [W3[c, e] * _dot3(s[c], sr[e])
                 for c in range(3) for e in range(3)]
            k0, k1, k2 = (k[..., None, :, :] for k in solve3_components(
                *A, -g[0], -g[1], -g[2]))
            d0 = d0 + clamp(im0 * (k0 * sr0 + k1 * sr1))
            d1 = d1 + clamp(im1 * (-k0 * sr0 + k2 * sr2))
            d2_ = d2_ + clamp(im2 * (-k1 * sr1 - k2 * sr2))

        vm = (wvalid > 0.5)[..., None, :, :]
        delta = _merge(*(torch.where(vm, d, torch.zeros_like(d))
                         for d in (d0, d1, d2_)))
        return wx + delta, wv + delta / dt

    @profiling.spanned("cph.shake")
    def velocities(self, wx, wv, box, wvalid):
        im0, im1, im2 = self.inv_m
        W3 = self.W3
        s0, s1, s2 = s = _bonds(*self._unwrap(wx, box))
        sv = _bonds(*_atoms(wv))
        jv = [_dot3(s[c], sv[c]) for c in range(3)]
        A = [W3[c, e] * _dot3(s[c], s[e])
             for c in range(3) for e in range(3)]
        k0, k1, k2 = (k[..., None, :, :] for k in solve3_components(
            *A, -jv[0], -jv[1], -jv[2]))
        dv0 = im0 * (k0 * s0 + k1 * s1)
        dv1 = im1 * (-k0 * s0 + k2 * s2)
        dv2 = im2 * (-k1 * s1 - k2 * s2)
        vm = (wvalid > 0.5)[..., None, :, :]
        return wv + _merge(*(torch.where(vm, d, torch.zeros_like(d))
                             for d in (dv0, dv1, dv2)))
