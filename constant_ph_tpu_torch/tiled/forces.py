"""Tiled pair blocks on the hot path (port of the fast path of
constant_ph_tpu/tiled/forces.py): water-water, water-solute and
solute-solute forces and total energies, plus φ on solute atoms for dU/dλ.

``water_water_fast`` is the water-water contract (the JAX package's
``water_water_fast`` and its Pallas twin ``pallas_ww._chunk_pair_kernel``).
On a CUDA tensor it launches the hand-written kernel (tiled/cuda_ww.py,
csrc/ww_pair.cu); on a CPU tensor it runs ``water_water_fast_plain``,
the plain PyTorch version of the same function.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from constant_ph_tpu_torch import units
from constant_ph_tpu_torch.ops.kernels import (
    R2_MIN,
    TWO_OVER_SQRT_PI,
    coul_kernel,
    lj_kernel,
)
from constant_ph_tpu_torch.state import min_image
from constant_ph_tpu_torch.tiled import cuda_ww
from constant_ph_tpu_torch.tiled.layout import (
    SoluteTables,
    TileParams,
    WaterModel,
)


@functools.lru_cache(maxsize=16)
def _screening_polys(alpha: float, rc: float, deg: int = 10):
    """Host-side Chebyshev fits of the Coulomb screening factors over
    r ∈ [0, rc], returned as ascending power-series coefficients in
    t = 2r/rc − 1 (Horner in t keeps every power in [−1, 1] — stable in
    f32). g1(r) = erfc(αr); g2(r) = erfc(αr) + (2/√π)·αr·exp(−α²r²)."""
    from numpy.polynomial import chebyshev as _Ch

    erfc = np.vectorize(math.erfc)
    nodes = (np.cos(np.pi * (np.arange(deg + 1) + 0.5) / (deg + 1)) + 1) / 2
    r = nodes * rc
    ar = alpha * r
    g1 = erfc(ar)
    g2 = g1 + TWO_OVER_SQRT_PI * ar * np.exp(-ar * ar)
    t = 2 * nodes - 1
    c1 = _Ch.cheb2poly(_Ch.chebfit(t, g1, deg))
    c2 = _Ch.cheb2poly(_Ch.chebfit(t, g2, deg))
    return tuple(float(c) for c in c1), tuple(float(c) for c in c2)


def coulomb_constants(style: str, alpha: float, rc: float):
    """(e_sh, f_sh, c_g1, c_g2) of the screened Coulomb pair term: the DSF
    energy/force shifts (0 for 'cut') and the screening polynomials
    (the constant 1 when α = 0, where there is no screening)."""
    e_sh = f_sh = 0.0
    if style == "dsf":
        erfc_rc = math.erfc(alpha * rc)
        e_sh = erfc_rc / rc
        f_sh = erfc_rc / rc**2 + (TWO_OVER_SQRT_PI * alpha
                                  * math.exp(-((alpha * rc) ** 2)) / rc)
    if alpha > 0.0:
        c_g1, c_g2 = _screening_polys(alpha, rc)
    else:
        c_g1 = c_g2 = (1.0,) + (0.0,) * 10
    return e_sh, f_sh, c_g1, c_g2


def _screened_coulomb(r2, style, rc, consts):
    """(u_r, w_r, inv_r2) per unit charge product for pre-clamped r2. The
    degree-10 fits in t are clamped to t ≤ 1, so parked far-away slots
    stay finite (their in_rc mask is 0)."""
    e_sh, f_sh, c_g1, c_g2 = consts
    inv_r = torch.rsqrt(r2)
    inv_r2 = inv_r * inv_r
    r = r2 * inv_r
    t = torch.clamp(r * (2.0 / rc) - 1.0, max=1.0)
    g1 = c_g1[-1]
    for ck in c_g1[-2::-1]:
        g1 = g1 * t + ck
    g2 = c_g2[-1]
    for ck in c_g2[-2::-1]:
        g2 = g2 * t + ck
    if style == "dsf":
        u_r = g1 * inv_r - e_sh + f_sh * (r - rc)
        w_r = g2 * inv_r2 * inv_r - f_sh * inv_r
    else:
        u_r = g1 * inv_r
        w_r = g2 * inv_r2 * inv_r
    return u_r, w_r, inv_r2


def _pair_block(xi, xj, box, qi, qj, c6p, c12p, eshp, scoulp, weight,
                *, style, alpha, rc):
    """Dense single-sided pair block between atom sets A and B, counted
    from the i side (the full matrix is summed, energies halved).

    xi/xj: 3 per-dim coordinate tensors (..., A) / (..., B). Coefficients
    broadcast to (..., A, B); weight ∈ {0,1} encodes validity +
    exclusions (masked pairs are pushed outside the cutoff).
    Returns (e_lj, e_coul, fi (3 tensors (..., A)), eatom_i, phi_i)."""
    far = rc * rc + 1.0
    dx = []
    r2 = None
    for d in range(3):
        dxd = min_image(xi[d][..., :, None] - xj[d][..., None, :], box[d])
        dx.append(dxd)
        r2 = dxd * dxd if r2 is None else r2 + dxd * dxd
    r2 = torch.where(weight > 0, torch.clamp(r2, min=R2_MIN),
                     torch.full_like(r2, far))
    in_rc = (r2 < rc * rc).to(r2.dtype)
    inv_r2 = 1.0 / r2
    r = torch.sqrt(r2)

    e_lj_p, f_lj = lj_kernel(inv_r2, c6p, c12p, eshp)
    e_lj_p = e_lj_p * in_rc
    f_lj = f_lj * in_rc

    u_r, w_r = coul_kernel(r2, r, inv_r2, scoulp, alpha=alpha, style=style,
                           rc=rc)
    u_r = u_r * in_rc
    w_r = w_r * in_rc
    kqq = units.QQR2E * qi[..., :, None] * qj[..., None, :]
    e_c_p = kqq * u_r
    fpair = f_lj + kqq * w_r
    fi = tuple(torch.sum(fpair * dx[d], dim=-1) for d in range(3))
    eatom_i = 0.5 * torch.sum(e_lj_p + e_c_p, dim=-1)
    phi_i = units.QQR2E * torch.sum(qj[..., None, :] * u_r, dim=-1)
    return (0.5 * torch.sum(e_lj_p), 0.5 * torch.sum(e_c_p), fi, eatom_i,
            phi_i)


def solute_solute(sx, qs, st: SoluteTables, box, *, style, alpha, rc):
    """Dense all-pairs solute block with exact special tables. Returns
    (e_lj, e_coul, f (Ns, 3), eatom (Ns,), phi (Ns,))."""
    Ns = sx.shape[0]
    xi = tuple(sx[:, d] for d in range(3))
    eye = torch.eye(Ns, dtype=sx.dtype, device=sx.device)
    w = st.smask[:, None] * st.smask[None, :] * (1.0 - eye)
    e_lj, e_c, fi, eatom, phi = _pair_block(
        xi, xi, box, qs, qs, st.c6, st.c12, st.eshift, st.scoul, w,
        style=style, alpha=alpha, rc=rc)
    return e_lj, e_c, torch.stack(fi, dim=-1), eatom, phi


def water_solute_fast(wxg, sx, qs, st: SoluteTables, wm: WaterModel,
                      p: TileParams, box, *, style, alpha, rc):
    """Hot-path water×solute block.

    Returns (e_lj, e_coul, f_w (3, gx, gy, gz, A), f_s (Ns, 3),
    phi_s (Ns,)). Images are resolved per CELL (the solute atom's nearest
    image to the cell centre), so parked water slots stay beyond the
    cutoff and no water validity mask is needed; solute pads fold into
    q·smask and the LJ coefficients."""
    W = p.W
    dtype, dev = wxg.dtype, wxg.device
    rc2 = rc * rc
    consts = coulomb_constants(style, alpha, rc)

    # slot patterns made on the device: a host array would be a pageable
    # copy, which synchronises the stream on every force evaluation
    is_o = torch.arange(3 * W, device=dev) % 3 == 0
    q_pat = torch.where(is_o, wm.q_pattern[0], wm.q_pattern[1]).to(dtype)
    lj_pat = is_o.to(dtype)[:, None]                          # O rows only

    qj = qs * st.smask                                        # (Ns,)
    c6p = lj_pat * (st.c6_cross * st.smask)
    c12p = lj_pat * (st.c12_cross * st.smask)
    eshp = lj_pat * (st.eshift_cross * st.smask)

    # per-CELL image resolution: water atoms sit within cell_half +
    # mol_radius of their cell centre, so for every in-cutoff pair the
    # solute atom's nearest image to the cell centre is the right one
    dx = []
    r2 = None
    for d in range(3):
        g = p.grid[d]
        cc = (torch.arange(g, dtype=dtype, device=dev) + 0.5) * (box[d] / g)
        shp = [1, 1, 1]
        shp[d] = g
        cc = cc.reshape(shp + [1])                            # cell centres
        sxd = sx[:, d][None, None, None, :]                   # (1,1,1,Ns)
        img = sxd - box[d] * torch.round((sxd - cc) / box[d])
        dd = wxg[d][..., :, None] - img[..., None, :]         # (...,A,Ns)
        dx.append(dd)
        r2 = dd * dd if r2 is None else r2 + dd * dd
    r2 = torch.clamp(r2, min=R2_MIN)
    in_rc = (r2 < rc2).to(dtype)
    u_r, w_r, inv_r2 = _screened_coulomb(r2, style, rc, consts)
    u_r = u_r * in_rc
    kqq = units.QQR2E * q_pat[:, None] * qj[None, :]
    e_coul = torch.sum(kqq * u_r)
    phi_s = units.QQR2E * torch.sum(q_pat[:, None] * u_r, dim=(0, 1, 2, 3))

    inv_r6 = inv_r2 * inv_r2 * inv_r2
    e_lj = torch.sum(((c12p * inv_r6 - c6p) * inv_r6 - eshp) * in_rc)
    fpair = (kqq * (w_r * in_rc)
             + (12.0 * c12p * inv_r6 - 6.0 * c6p) * inv_r6 * inv_r2 * in_rc)
    f_w = []
    f_s = []
    for d in range(3):
        fd = fpair * dx[d]
        f_w.append(torch.sum(fd, dim=-1))                     # (...,A)
        f_s.append(-torch.sum(fd, dim=(0, 1, 2, 3)))          # (Ns,)
    return e_lj, e_coul, torch.stack(f_w), torch.stack(f_s, dim=-1), phi_s


def _roll_shift(box, grid, off, dtype):
    """Per-cell image shifts for a rolled neighbour tile, (3, gx, gy, gz,
    1). ``torch.roll(x, -off)`` hands cell i the coordinates of cell
    (i + off) mod g; for boundary cells the source wrapped around the box,
    and adding ±L puts the neighbour in its contiguous image, so dx needs
    no per-pair min-image (coordinates are box-wrapped at rebin)."""
    shifts = []
    for d in range(3):
        g = grid[d]
        s = np.zeros(g, dtype=np.float32)
        if off[d] == 1:
            s[g - 1] = 1.0
        elif off[d] == -1:
            s[0] = -1.0
        shape = [1, 1, 1, 1]
        shape[d] = g
        shifts.append(torch.as_tensor(s.reshape(shape), dtype=dtype,
                                      device=box.device) * box[d])
    return torch.stack([torch.broadcast_to(s, tuple(grid) + (1,))
                        for s in shifts])


def water_water_fast_plain(wxg, wm: WaterModel, p: TileParams, box, *,
                           style, alpha, rc):
    """Plain PyTorch version of the hot-path water-water block: forces +
    total energies, no per-atom tallies (mirrors the JAX package's
    ``tiled/forces.water_water_fast``, without its TPU lane-chunk plan).

    wxg: (3, gx, gy, gz, A) with A = 3W; box: (3,). Returns (e_lj, e_coul,
    f (3, gx, gy, gz, A)). Half stencil: each of the 13 neighbour offsets
    is a rolled tile with per-cell image shifts, both sides accumulated
    (the j side rolled back onto its source cells); the self tile
    excludes same-molecule pairs and carries a 0.5. Coulomb on all atom
    pairs with the Chebyshev screening fits; 12-6 shifted LJ on O-O only.
    No validity mask: parked slots fall outside the cutoff."""
    gx, gy, gz = p.grid
    if min(p.grid) < 3:
        raise ValueError("water_water_fast needs grid >= 3 per dim")
    W = p.W
    A = 3 * W
    dtype, dev = wxg.dtype, wxg.device
    rc2 = rc * rc
    consts = coulomb_constants(style, alpha, rc)

    q_pat = np.tile(np.asarray(wm.q_pattern, np.float64), W)
    a_idx = np.arange(A)
    kqq_np = units.QQR2E * q_pat[:, None] * q_pat[None, :]
    nsm = (a_idx[:, None] // 3) != (a_idx[None, :] // 3)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    kqq_nbr = t(kqq_np)
    kqq_self = t(kqq_np * 0.5 * nsm)
    ljm_self = t(0.5 * (1.0 - np.eye(W)))
    c12x12 = 12.0 * wm.c12_OO
    c6x6 = 6.0 * wm.c6_OO

    dims = (1, 2, 3)
    f = torch.zeros_like(wxg)
    fO = torch.zeros_like(wxg[..., 0::3])
    e_coul = torch.zeros((), dtype=dtype, device=dev)
    e_lj = torch.zeros((), dtype=dtype, device=dev)
    for off in list(p.half_stencil) + [None]:
        if off is None:                                      # self tile
            xj, kqq, ljm = wxg, kqq_self, ljm_self
        else:
            xj = (torch.roll(wxg, tuple(-o for o in off), dims=dims)
                  + _roll_shift(box, p.grid, off, dtype))
            kqq, ljm = kqq_nbr, None

        def fold(fi, fj):
            return fi + (fj if off is None
                         else torch.roll(fj, off, dims=dims))

        dx = wxg[..., :, None] - xj[..., None, :]            # (3,...,A,A)
        r2 = torch.clamp(dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2],
                         min=R2_MIN)
        in_rc = (r2 < rc2).to(dtype)
        u_r, w_r, _ = _screened_coulomb(r2, style, rc, consts)
        e_coul = e_coul + torch.sum(kqq * (u_r * in_rc))
        hd = (kqq * (w_r * in_rc))[None] * dx
        f = f + fold(torch.sum(hd, dim=-1), -torch.sum(hd, dim=-2))

        dxo = dx[..., 0::3, 0::3]                            # O-O block
        r2o = torch.clamp(dxo[0] * dxo[0] + dxo[1] * dxo[1]
                          + dxo[2] * dxo[2], min=R2_MIN)
        in_rco = (r2o < rc2).to(dtype)
        if ljm is not None:
            in_rco = ljm * in_rco
        inv_r2 = 1.0 / r2o
        inv_r6 = inv_r2 * inv_r2 * inv_r2
        e_lj = e_lj + torch.sum(
            ((wm.c12_OO * inv_r6 - wm.c6_OO) * inv_r6 - wm.eshift_OO)
            * in_rco)
        fpd = ((c12x12 * inv_r6 - c6x6) * inv_r6 * inv_r2 * in_rco)[None] * dxo
        fO = fO + fold(torch.sum(fpd, dim=-1), -torch.sum(fpd, dim=-2))
    f[..., 0::3] += fO
    return e_lj, e_coul, f


def water_water_fast(wxg, wm: WaterModel, p: TileParams, box, *,
                     style, alpha, rc):
    """Hot-path water-water block (forces + total energies). Launches the
    CUDA kernel for a CUDA tensor and runs the plain version for a CPU
    tensor; see water_water_fast_plain for the contract."""
    if wxg.is_cuda:
        return cuda_ww.water_water_cuda(wxg, wm, p, box, style=style,
                                        alpha=alpha, rc=rc)
    if wxg.device.type != "cpu":
        raise ValueError(f"water_water_fast: no kernel for {wxg.device}")
    return water_water_fast_plain(wxg, wm, p, box, style=style,
                                  alpha=alpha, rc=rc)
