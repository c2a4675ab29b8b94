"""Tiled pair blocks (port of constant_ph_tpu/tiled/forces.py and of the
functions of constant_ph_tpu/tiled/pallas_ww.py): water-water,
water-solute and solute-solute forces and energies, φ on solute atoms for
dU/dλ, and, on the tally path, per-atom energies and φ.

Two water-water contracts have CUDA kernels (tiled/cuda_ww.py); each
dispatcher launches the kernel for a CUDA tensor and runs the plain
PyTorch version of the same function for a CPU tensor:
- ``water_water_fast`` (hot path; the JAX ``water_water_fast`` and its
  Pallas twin ``_chunk_pair_kernel``): csrc/ww_pair.cu /
  ``water_water_fast_plain``;
- ``water_water_tally`` (full tallies; the JAX ``water_water_pallas``,
  kernel ``make_ww_kernel``): csrc/ww_tally.cu /
  ``water_water_tally_plain``.
``water_water`` and ``water_solute`` are the tally-path blocks (any grid).
"""
from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass
class BlockSums:
    """Sums of one dense pair block. The j-side fields are None for a
    single-sided block."""

    e_lj: torch.Tensor
    e_coul: torch.Tensor
    fi: tuple            # 3 tensors (..., A)
    fj: tuple | None     # 3 tensors (..., B)
    eatom_i: torch.Tensor
    eatom_j: torch.Tensor | None
    phi_i: torch.Tensor
    phi_j: torch.Tensor | None


def _pair_block(xi, xj, box, qi, qj, c6p, c12p, eshp, scoulp, weight,
                *, style, alpha, rc, double_sided=False) -> BlockSums:
    """Dense pair block between atom sets A and B.

    xi/xj: 3 per-dim coordinate tensors (..., A) / (..., B). Coefficients
    broadcast to (..., A, B); weight ∈ {0,1} encodes validity +
    exclusions (masked pairs are pushed outside the cutoff). Single-sided
    (the default) counts the full matrix from the i side, so energies are
    halved; double-sided accumulates both sides of each pair once."""
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
    e_p = e_lj_p + e_c_p
    eatom_i = 0.5 * torch.sum(e_p, dim=-1)
    phi_i = units.QQR2E * torch.sum(qj[..., None, :] * u_r, dim=-1)
    if double_sided:
        fj = tuple(-torch.sum(fpair * dx[d], dim=-2) for d in range(3))
        eatom_j = 0.5 * torch.sum(e_p, dim=-2)
        phi_j = units.QQR2E * torch.sum(qi[..., :, None] * u_r, dim=-2)
        scale = 1.0
    else:
        fj = eatom_j = phi_j = None
        scale = 0.5      # full matrix counted once from the i side
    return BlockSums(e_lj=scale * torch.sum(e_lj_p),
                     e_coul=scale * torch.sum(e_c_p), fi=fi, fj=fj,
                     eatom_i=eatom_i, eatom_j=eatom_j, phi_i=phi_i,
                     phi_j=phi_j)


def _water_patterns(wm: WaterModel, W: int, dtype, device):
    """(q_pat (3W,), lj_pat (3W,) = 1 on O slots, not_same_mol (3W, 3W)),
    made on the device: a host array would be a pageable copy, which
    synchronises the stream."""
    a = torch.arange(3 * W, device=device)
    is_o = a % 3 == 0
    q_pat = torch.where(is_o, wm.q_pattern[0], wm.q_pattern[1]).to(dtype)
    mol = a // 3
    return (q_pat, is_o.to(dtype),
            (mol[:, None] != mol[None, :]).to(dtype))


def water_water(wxg, wvalid, wm: WaterModel, p: TileParams, box,
                *, style, alpha, rc):
    """All water-water interactions with per-atom tallies (the tally
    path; any grid). wxg: (3, gx, gy, gz, 3W); wvalid: (gx, gy, gz, W).
    Returns (e_lj, e_coul, f (3, gx, gy, gz, 3W), eatom (gx, gy, gz, 3W),
    phi (gx, gy, gz, 3W)). Self cell as a full single-sided matrix with
    same-molecule pairs excluded; each half-stencil neighbour as a
    double-sided block whose j sums are rolled back onto their cells.
    Per-pair min image and exact erfc (ops.kernels.coul_kernel)."""
    q_pat, lj_pat, not_same_mol = _water_patterns(wm, p.W, wxg.dtype,
                                                  wxg.device)
    vmask = torch.repeat_interleave(wvalid, 3, dim=-1)     # (gx,gy,gz,3W)

    xi = tuple(wxg[d] for d in range(3))
    lj2 = lj_pat[:, None] * lj_pat[None, :]
    c6_ij = wm.c6_OO * lj2
    c12_ij = wm.c12_OO * lj2
    esh_ij = wm.eshift_OO * lj2
    kw = dict(style=style, alpha=alpha, rc=rc)

    # self cell: full matrix, same-molecule pairs excluded, i-side counting
    w_self = (vmask[..., :, None] * vmask[..., None, :]) * not_same_mol
    bs = _pair_block(xi, xi, box, q_pat, q_pat, c6_ij, c12_ij, esh_ij, 1.0,
                     w_self, **kw)
    f = list(bs.fi)
    eatom, phi = bs.eatom_i, bs.phi_i
    e_lj, e_coul = bs.e_lj, bs.e_coul

    # half stencil: each unordered cell pair once, both sides accumulated
    dims = (0, 1, 2)
    for off in p.half_stencil:
        sh = tuple(-o for o in off)
        xj = tuple(torch.roll(wxg[d], sh, dims=dims) for d in range(3))
        vmj = torch.roll(vmask, sh, dims=dims)
        w = vmask[..., :, None] * vmj[..., None, :]
        bs = _pair_block(xi, xj, box, q_pat, q_pat, c6_ij, c12_ij, esh_ij,
                         1.0, w, double_sided=True, **kw)
        for d in range(3):
            f[d] = f[d] + bs.fi[d] + torch.roll(bs.fj[d], off, dims=dims)
        eatom = eatom + bs.eatom_i + torch.roll(bs.eatom_j, off, dims=dims)
        phi = phi + bs.phi_i + torch.roll(bs.phi_j, off, dims=dims)
        e_lj = e_lj + bs.e_lj
        e_coul = e_coul + bs.e_coul
    return e_lj, e_coul, torch.stack(f), eatom, phi


def water_solute(wxg, wvalid, sx, qs, st: SoluteTables, wm: WaterModel,
                 p: TileParams, box, *, style, alpha, rc):
    """Water tiles × dense solute with per-atom tallies. Returns (e_lj,
    e_coul, f_w (3, gx, gy, gz, 3W), f_s (Ns, 3), eatom_w, eatom_s, phi_w,
    phi_s)."""
    q_pat, lj_pat, _ = _water_patterns(wm, p.W, wxg.dtype, wxg.device)
    vmask = torch.repeat_interleave(wvalid, 3, dim=-1)

    xi = tuple(wxg[d] for d in range(3))
    xj = tuple(sx[:, d][None, None, None, :] for d in range(3))
    c6p = lj_pat[:, None] * st.c6_cross[None, :]
    c12p = lj_pat[:, None] * st.c12_cross[None, :]
    eshp = lj_pat[:, None] * st.eshift_cross[None, :]
    w = vmask[..., :, None] * st.smask[None, None, None, None, :]
    bs = _pair_block(xi, xj, box, q_pat, qs, c6p, c12p, eshp, 1.0, w,
                     style=style, alpha=alpha, rc=rc, double_sided=True)
    f_s = torch.stack([torch.sum(bs.fj[d], dim=(0, 1, 2)) for d in range(3)],
                      dim=-1)
    return (bs.e_lj, bs.e_coul, torch.stack(bs.fi), f_s, bs.eatom_i,
            torch.sum(bs.eatom_j, dim=(0, 1, 2)), bs.phi_i,
            torch.sum(bs.phi_j, dim=(0, 1, 2)))


def solute_solute(sx, qs, st: SoluteTables, box, *, style, alpha, rc):
    """Dense all-pairs solute block with exact special tables. Returns
    (e_lj, e_coul, f (Ns, 3), eatom (Ns,), phi (Ns,))."""
    Ns = sx.shape[0]
    xi = tuple(sx[:, d] for d in range(3))
    eye = torch.eye(Ns, dtype=sx.dtype, device=sx.device)
    w = st.smask[:, None] * st.smask[None, :] * (1.0 - eye)
    bs = _pair_block(xi, xi, box, qs, qs, st.c6, st.c12, st.eshift,
                     st.scoul, w, style=style, alpha=alpha, rc=rc)
    return (bs.e_lj, bs.e_coul, torch.stack(bs.fi, dim=-1), bs.eatom_i,
            bs.phi_i)


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


# -- the full-tally water-water kernel (K2) ---------------------------------

def _erfc_pos(x, expmx2):
    """erfc(x) for x ≥ 0 by Abramowitz–Stegun 7.1.26 (|ε| < 1.5e-7), with
    expmx2 = exp(−x²) shared with the Ewald gaussian term: the formula of
    the TPU kernel, which the CUDA kernel repeats."""
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
                + t * (-1.453152027 + t * 1.061405429))))
    return poly * expmx2


def pack_water_tiles(wxg, wvalid, wm: WaterModel, p: TileParams):
    """(3, gx, gy, gz, A) coords + (gx, gy, gz, W) validity → packed
    tiles (gx, gy, gz, 8, A): rows x, y, z, charge (pattern × valid), LJ
    mask (valid O slots), validity, and two zero rows."""
    q_pat, lj_pat, _ = _water_patterns(wm, p.W, wxg.dtype, wxg.device)
    vm = torch.repeat_interleave(wvalid, 3, dim=-1)          # (gx,gy,gz,A)
    zero = torch.zeros_like(vm)
    return torch.stack([wxg[0], wxg[1], wxg[2], q_pat * vm, lj_pat * vm,
                        vm, zero, zero], dim=3).contiguous()


_STENCIL27 = tuple((ox, oy, oz) for ox in (-1, 0, 1) for oy in (-1, 0, 1)
                  for oz in (-1, 0, 1))                    # self at 13


def water_water_tally_plain(wt, box, wm: WaterModel, p: TileParams, *,
                            style, alpha, rc):
    """Plain PyTorch version of the full-tally water-water kernel (the
    TPU kernel pallas_ww.make_ww_kernel; CUDA csrc/ww_tally.cu).

    wt: packed tiles (gx, gy, gz, 8, A) (pack_water_tiles); box (3,).
    Returns out (gx, gy, gz, 8, A): per slot force x, y, z, eatom_lj,
    eatom_coul and φ, then two zero rows. Full 27-offset stencil with
    i-side-only sums; per-pair min image (round half to even);
    validity weights, and on the self offset the same-molecule mask;
    masked pairs are pushed to r² = rc² + 1 before 1/r²; LJ on O rows by
    mask; Coulomb with the Abramowitz–Stegun erfc in DSF or 'cut' style.
    Needs grid ≥ 3 per dim (the 27 offsets must be distinct cells)."""
    if min(p.grid) < 3:
        raise ValueError("the full-tally water-water kernel needs grid >= 3 "
                         "per dim; use tiled.forces.water_water")
    A = 3 * p.W
    rc2 = rc * rc
    dtype, dev = wt.dtype, wt.device
    e_sh, f_sh, _, _ = coulomb_constants(style, alpha, rc)
    _, _, not_same_mol = _water_patterns(wm, p.W, dtype, dev)
    inv_l = 1.0 / box
    xi = [wt[..., d, :] for d in range(3)]
    qi, lji, vi = wt[..., 3, :], wt[..., 4, :], wt[..., 5, :]
    out = torch.zeros_like(wt)
    for k, off in enumerate(_STENCIL27):
        tile = torch.roll(wt, tuple(-o for o in off), dims=(0, 1, 2))
        dx = []
        r2 = None
        for d in range(3):
            dd = xi[d][..., :, None] - tile[..., d, :][..., None, :]
            dd = dd - box[d] * torch.round(dd * inv_l[d])
            dx.append(dd)
            r2 = dd * dd if r2 is None else r2 + dd * dd
        w = vi[..., :, None] * tile[..., 5, :][..., None, :]
        if k == 13:
            w = w * not_same_mol
        r2 = torch.where(w > 0, torch.clamp(r2, min=R2_MIN),
                         torch.full_like(r2, rc2 + 1.0))
        in_rc = (r2 < rc2).to(dtype)
        inv_r2 = 1.0 / r2
        r = torch.sqrt(r2)

        ljp = lji[..., :, None] * tile[..., 4, :][..., None, :]
        inv_r6 = inv_r2 * inv_r2 * inv_r2
        e_lj_p = (((wm.c12_OO * inv_r6 - wm.c6_OO) * inv_r6 - wm.eshift_OO)
                  * ljp * in_rc)
        f_lj = ((12.0 * wm.c12_OO * inv_r6 - 6.0 * wm.c6_OO) * inv_r6
                * inv_r2 * ljp * in_rc)
        if alpha > 0.0:
            ar = alpha * r
            expmx2 = torch.exp(-ar * ar)
            erfc_ar = _erfc_pos(ar, expmx2)
            gauss = TWO_OVER_SQRT_PI * ar * expmx2
        else:
            erfc_ar = torch.ones_like(r)
            gauss = torch.zeros_like(r)
        if style == "dsf":
            u_r = erfc_ar / r - e_sh + f_sh * (r - rc)
            w_r = (erfc_ar + gauss) * inv_r2 / r - f_sh / r
        else:
            u_r = erfc_ar / r
            w_r = (erfc_ar + gauss) * inv_r2 / r
        u_r = u_r * in_rc
        w_r = w_r * in_rc
        qj = tile[..., 3, :][..., None, :]
        kqq = units.QQR2E * qi[..., :, None] * qj
        fpair = f_lj + kqq * w_r
        out[..., :6, :] += torch.stack(
            [torch.sum(fpair * dx[0], dim=-1),
             torch.sum(fpair * dx[1], dim=-1),
             torch.sum(fpair * dx[2], dim=-1),
             0.5 * torch.sum(e_lj_p, dim=-1),
             0.5 * torch.sum(kqq * u_r, dim=-1),
             units.QQR2E * torch.sum(qj * u_r, dim=-1)], dim=-2)
    return out


def water_water_tally(wxg, wvalid, wm: WaterModel, p: TileParams, box, *,
                      style, alpha, rc):
    """The full-tally water-water block through K2 (the counterpart of
    the JAX package's ``pallas_ww.water_water_pallas``, a drop-in for
    :func:`water_water` at grid ≥ 3): packs the tiles, launches the CUDA
    kernel for a CUDA tensor or runs the plain version for a CPU tensor,
    and returns (e_lj, e_coul, f (3, gx, gy, gz, A), eatom, phi)."""
    wt = pack_water_tiles(wxg, wvalid, wm, p)
    kw = dict(style=style, alpha=alpha, rc=rc)
    if wt.is_cuda:
        out = cuda_ww.water_water_tally_cuda(wt, box, wm, p, **kw)
    elif wt.device.type == "cpu":
        out = water_water_tally_plain(wt, box, wm, p, **kw)
    else:
        raise ValueError(f"water_water_tally: no kernel for {wt.device}")
    f = torch.movedim(out[..., :3, :], -2, 0)
    return (torch.sum(out[..., 3, :]), torch.sum(out[..., 4, :]), f,
            out[..., 3, :] + out[..., 4, :], out[..., 5, :])


def water_intra_ewald_correction(wm: WaterModel, n_waters, alpha: float):
    """Constant energy correction for rigid-water intra-molecular pairs
    under Ewald: the same-molecule mask removes the real-space −erf
    compensation that the reciprocal sum needs. Rigid geometry makes it a
    constant; its internal forces do no work on a rigid body."""
    qO, qH = wm.q_pattern[0], wm.q_pattern[1]
    e = (2.0 * qO * qH * math.erf(alpha * wm.d_OH) / wm.d_OH
         + qH * qH * math.erf(alpha * wm.d_HH) / wm.d_HH)
    return -units.QQR2E * e * n_waters
