"""Tiled pair blocks (port of constant_ph_tpu/tiled/forces.py and of the
functions of constant_ph_tpu/tiled/pallas_ww.py): water-water,
water-solute and solute-solute forces and energies, φ on solute atoms for
dU/dλ, and, on the tally path, per-atom energies and φ.

Every function is written over a leading replica axis R on each tensor
argument (coordinates, validity, solute charges, box (R, 3)); one
replica's arrays run as a batch of one (batching.replica_batched), so the
shapes in the docstrings are one replica's.

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

On an x-slab of the grid (parallel/spatial.py) both dispatchers take
``x_first``, the slab entry: tiles of a rank's owned x-layers between two
ghost layers in, the owned cells' outputs out. The plain versions there,
``water_water_slab_plain`` and ``water_water_tally_plain`` with
``x_first``, sum every pair on the i side over the full 27-cell stencil,
as the kernels do, so a rank writes nothing into its ghosts and sends
nothing back.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from constant_ph_tpu_torch import units
from constant_ph_tpu_torch.batching import bview, replica_batched
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

    xi/xj: 3 per-dim coordinate tensors (R, ..., A) / (R, ..., B); box: 3
    per-dim box lengths that broadcast against (R, ..., A, B).
    Coefficients broadcast to (R, ..., A, B); weight ∈ {0,1} encodes
    validity + exclusions (masked pairs are pushed outside the cutoff).
    Single-sided (the default) counts the full matrix from the i side, so
    energies are halved; double-sided accumulates both sides of each pair
    once. Energies are (R,)."""
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
    return BlockSums(e_lj=scale * torch.sum(e_lj_p.flatten(1), dim=-1),
                     e_coul=scale * torch.sum(e_c_p.flatten(1), dim=-1),
                     fi=fi, fj=fj,
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


def _box_dims(box, ndim):
    """The three per-replica box lengths of box (R, 3), each shaped to
    broadcast against (R, …) arrays of ``ndim`` dims."""
    return tuple(bview(box[:, d], ndim) for d in range(3))


@replica_batched(5)
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

    xi = tuple(wxg[:, d] for d in range(3))
    bx = _box_dims(box, 6)
    lj2 = lj_pat[:, None] * lj_pat[None, :]
    c6_ij = wm.c6_OO * lj2
    c12_ij = wm.c12_OO * lj2
    esh_ij = wm.eshift_OO * lj2
    kw = dict(style=style, alpha=alpha, rc=rc)

    # self cell: full matrix, same-molecule pairs excluded, i-side counting
    w_self = (vmask[..., :, None] * vmask[..., None, :]) * not_same_mol
    bs = _pair_block(xi, xi, bx, q_pat, q_pat, c6_ij, c12_ij, esh_ij, 1.0,
                     w_self, **kw)
    f = list(bs.fi)
    eatom, phi = bs.eatom_i, bs.phi_i
    e_lj, e_coul = bs.e_lj, bs.e_coul

    # half stencil: each unordered cell pair once, both sides accumulated
    dims = (1, 2, 3)
    for off in p.half_stencil:
        sh = tuple(-o for o in off)
        xj = tuple(torch.roll(wxg[:, d], sh, dims=dims) for d in range(3))
        vmj = torch.roll(vmask, sh, dims=dims)
        w = vmask[..., :, None] * vmj[..., None, :]
        bs = _pair_block(xi, xj, bx, q_pat, q_pat, c6_ij, c12_ij, esh_ij,
                         1.0, w, double_sided=True, **kw)
        for d in range(3):
            f[d] = f[d] + bs.fi[d] + torch.roll(bs.fj[d], off, dims=dims)
        eatom = eatom + bs.eatom_i + torch.roll(bs.eatom_j, off, dims=dims)
        phi = phi + bs.phi_i + torch.roll(bs.phi_j, off, dims=dims)
        e_lj = e_lj + bs.e_lj
        e_coul = e_coul + bs.e_coul
    return e_lj, e_coul, torch.stack(f, dim=1), eatom, phi


@replica_batched(5)
def water_solute(wxg, wvalid, sx, qs, st: SoluteTables, wm: WaterModel,
                 p: TileParams, box, *, style, alpha, rc):
    """Water tiles × dense solute with per-atom tallies. Returns (e_lj,
    e_coul, f_w (3, gx, gy, gz, 3W), f_s (Ns, 3), eatom_w, eatom_s, phi_w,
    phi_s)."""
    q_pat, lj_pat, _ = _water_patterns(wm, p.W, wxg.dtype, wxg.device)
    vmask = torch.repeat_interleave(wvalid, 3, dim=-1)

    xi = tuple(wxg[:, d] for d in range(3))
    xj = tuple(sx[:, None, None, None, :, d] for d in range(3))
    qj = qs[:, None, None, None, :]
    c6p = lj_pat[:, None] * st.c6_cross[None, :]
    c12p = lj_pat[:, None] * st.c12_cross[None, :]
    eshp = lj_pat[:, None] * st.eshift_cross[None, :]
    w = vmask[..., :, None] * st.smask[None, None, None, None, :]
    bs = _pair_block(xi, xj, _box_dims(box, 6), q_pat, qj, c6p, c12p, eshp,
                     1.0, w, style=style, alpha=alpha, rc=rc,
                     double_sided=True)
    cells = (1, 2, 3)
    f_s = torch.stack([torch.sum(bs.fj[d], dim=cells) for d in range(3)],
                      dim=-1)
    return (bs.e_lj, bs.e_coul, torch.stack(bs.fi, dim=1), f_s, bs.eatom_i,
            torch.sum(bs.eatom_j, dim=cells), bs.phi_i,
            torch.sum(bs.phi_j, dim=cells))


@replica_batched(2)
def solute_solute(sx, qs, st: SoluteTables, box, *, style, alpha, rc):
    """Dense all-pairs solute block with exact special tables. Returns
    (e_lj, e_coul, f (Ns, 3), eatom (Ns,), phi (Ns,))."""
    Ns = sx.shape[-2]
    xi = tuple(sx[..., d] for d in range(3))
    eye = torch.eye(Ns, dtype=sx.dtype, device=sx.device)
    w = st.smask[:, None] * st.smask[None, :] * (1.0 - eye)
    bs = _pair_block(xi, xi, _box_dims(box, 3), qs, qs, st.c6, st.c12,
                     st.eshift, st.scoul, w, style=style, alpha=alpha, rc=rc)
    return (bs.e_lj, bs.e_coul, torch.stack(bs.fi, dim=-1), bs.eatom_i,
            bs.phi_i)


@replica_batched(5)
def water_solute_fast(wxg, sx, qs, st: SoluteTables, wm: WaterModel,
                      p: TileParams, box, *, style, alpha, rc, x_first=0):
    """Hot-path water×solute block.

    Returns (e_lj, e_coul, f_w (3, gx, gy, gz, A), f_s (Ns, 3),
    phi_s (Ns,)). Images are resolved per CELL (the solute atom's nearest
    image to the cell centre), so parked water slots stay beyond the
    cutoff and no water validity mask is needed; solute pads fold into
    q·smask and the LJ coefficients. On an x-slab wxg holds the owned
    x-layers from global layer ``x_first`` on, and the sums cover them."""
    W = p.W
    dtype, dev = wxg.dtype, wxg.device
    rc2 = rc * rc
    consts = coulomb_constants(style, alpha, rc)

    # slot patterns made on the device: a host array would be a pageable
    # copy, which synchronises the stream on every force evaluation
    is_o = torch.arange(3 * W, device=dev) % 3 == 0
    q_pat = torch.where(is_o, wm.q_pattern[0], wm.q_pattern[1]).to(dtype)
    lj_pat = is_o.to(dtype)[:, None]                          # O rows only

    R = wxg.shape[0]
    qj = (qs * st.smask)[:, None, None, None, None, :]        # (R,..,1,Ns)
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
        n = wxg.shape[2 + d]                  # the cells held (a slab: n)
        first = x_first if d == 0 else 0
        bd = bview(box[:, d], 5)                              # (R,1,1,1,1)
        shp = [R, 1, 1, 1, 1]
        shp[1 + d] = n
        cc = ((torch.arange(first, first + n, dtype=dtype, device=dev)
               + 0.5) * (box[:, d:d + 1] / g)).reshape(shp)   # cell centres
        sxd = sx[:, None, None, None, :, d]                   # (R,1,1,1,Ns)
        img = sxd - bd * torch.round((sxd - cc) / bd)
        dd = wxg[:, d][..., :, None] - img[..., None, :]      # (R,...,A,Ns)
        dx.append(dd)
        r2 = dd * dd if r2 is None else r2 + dd * dd
    r2 = torch.clamp(r2, min=R2_MIN)
    in_rc = (r2 < rc2).to(dtype)
    u_r, w_r, inv_r2 = _screened_coulomb(r2, style, rc, consts)
    u_r = u_r * in_rc
    kqq = units.QQR2E * q_pat[:, None] * qj
    cells_a = (1, 2, 3, 4)
    e_coul = torch.sum((kqq * u_r).flatten(1), dim=-1)
    phi_s = units.QQR2E * torch.sum(q_pat[:, None] * u_r, dim=cells_a)

    inv_r6 = inv_r2 * inv_r2 * inv_r2
    e_lj = torch.sum((((c12p * inv_r6 - c6p) * inv_r6 - eshp)
                      * in_rc).flatten(1), dim=-1)
    fpair = (kqq * (w_r * in_rc)
             + (12.0 * c12p * inv_r6 - 6.0 * c6p) * inv_r6 * inv_r2 * in_rc)
    f_w = []
    f_s = []
    for d in range(3):
        fd = fpair * dx[d]
        f_w.append(torch.sum(fd, dim=-1))                     # (R,...,A)
        f_s.append(-torch.sum(fd, dim=cells_a))               # (R,Ns)
    return (e_lj, e_coul, torch.stack(f_w, dim=1),
            torch.stack(f_s, dim=-1), phi_s)


@replica_batched(1)
def _roll_shift(box, grid, off, dtype, x_first=0, n=None):
    """Per-cell image shifts for a rolled neighbour tile, (3, gx, gy, gz,
    1). ``torch.roll(x, -off)`` hands cell i the coordinates of cell
    (i + off) mod g; for boundary cells the source wrapped around the box,
    and adding ±L puts the neighbour in its contiguous image, so dx needs
    no per-pair min-image (coordinates are box-wrapped at rebin). On an
    x-slab (n owned x-layers from global layer ``x_first`` on) the shifts
    of the owned cells, (3, n, gy, gz, 1), from the neighbours' global x
    indices."""
    cells = (grid[0] if n is None else n,) + tuple(grid[1:])
    shifts = []
    for d in range(3):
        g = grid[d]
        c = np.arange(cells[d]) + (x_first if d == 0 else 0) + off[d]
        s = np.where(c < 0, -1.0, np.where(c >= g, 1.0, 0.0)).astype(
            np.float32)
        shape = [1, 1, 1, 1, 1]
        shape[1 + d] = cells[d]
        shifts.append(torch.as_tensor(s.reshape(shape), dtype=dtype,
                                      device=box.device)
                      * bview(box[:, d], 5))
    R = box.shape[0]
    return torch.stack([torch.broadcast_to(s, (R,) + cells + (1,))
                        for s in shifts], dim=1)


# the plain versions' dense pair blocks: a block of G·A² floats above
# _BLOCK_WHOLE (the hewl tiles at W 208, the hard tiles padded to it) is
# taken in runs of (x, y) cell rows of at most _BLOCK_PART, so that no
# temporary reaches hundreds of MB; below it (the PME and campaign
# production tiles) the block is one piece
_BLOCK_WHOLE = 32 << 20
_BLOCK_PART = 8 << 20
# on the CPU, a block taken in runs of cell rows is also taken in runs of
# i slots whose temporaries stay near _SLOT_PART, so that they fit in
# cache (~3x faster on the hard tiles at W 208). The full-tally sums all
# run along j, so its outputs are bitwise those of the whole rows; the
# hot-path block's j-side sums and energy totals add the runs' partial
# sums, float32 sums in another order
_SLOT_PART = 256 << 10


def _slot_chunks(chunks, R, gz, A, itemsize, dev, unit=1):
    """Slices over the A i slots (whole runs of ``unit`` slots) of one run
    of cell rows: the whole axis, or on the CPU where the block is taken in
    runs of rows, runs of about _SLOT_PART bytes a temporary."""
    if dev.type != "cpu" or len(chunks) == 1:
        return [slice(0, A)]
    rows = chunks[0].stop - chunks[0].start
    step = unit * max(1, _SLOT_PART // (unit * R * rows * gz * A * itemsize))
    return [slice(i, min(i + step, A)) for i in range(0, A, step)]


def _row_chunks(grid, A, itemsize, R=1):
    """Slices over the gx·gy cell rows that split an (R, G, A, A)
    block."""
    gx, gy, gz = grid
    rows = gx * gy
    row_bytes = R * gz * A * A * itemsize
    if rows * row_bytes <= _BLOCK_WHOLE:
        return [slice(0, rows)]
    step = max(1, _BLOCK_PART // row_bytes)
    return [slice(r, min(r + step, rows)) for r in range(0, rows, step)]


@replica_batched(5)
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

    dims = (2, 3, 4)
    R = wxg.shape[0]
    rows_n = gx * gy
    f = torch.zeros_like(wxg)
    fO = torch.zeros_like(wxg[..., 0::3])
    e_coul = torch.zeros((R,), dtype=dtype, device=dev)
    e_lj = torch.zeros((R,), dtype=dtype, device=dev)
    wx4 = wxg.reshape(R, 3, rows_n, gz, A)
    chunks = _row_chunks(p.grid, A, wxg.element_size(), R)
    # runs of whole molecules, so that 0::3 picks each run's O atoms
    slots = _slot_chunks(chunks, R, gz, A, wxg.element_size(), dev, unit=3)

    def total(t):                                    # per-replica sum
        return torch.sum(t.flatten(1), dim=-1)

    for off in list(p.half_stencil) + [None]:
        if off is None:                                      # self tile
            xj, kqq, ljm = wxg, kqq_self, ljm_self
        else:
            xj = (torch.roll(wxg, tuple(-o for o in off), dims=dims)
                  + _roll_shift(box, p.grid, off, dtype))
            kqq, ljm = kqq_nbr, None
        xj4 = xj.reshape(R, 3, rows_n, gz, A)
        # i-side and j-side sums of the whole tile, filled run by run
        fi, fj = torch.empty_like(wx4), torch.empty_like(wx4)
        fiO, fjO = (torch.empty_like(wx4[..., 0::3]),
                    torch.empty_like(wx4[..., 0::3]))
        for rows in chunks:
            xi_r, xj_r = wx4[:, :, rows], xj4[:, :, rows]
            fj_runs, fjO_runs = [], []
            for i in slots:
                iO = slice(i.start // 3, i.stop // 3)
                dx = xi_r[..., i, None] - xj_r[..., None, :]  # (R,3,...,a,A)
                r2 = torch.clamp(dx[:, 0] * dx[:, 0] + dx[:, 1] * dx[:, 1]
                                 + dx[:, 2] * dx[:, 2], min=R2_MIN)
                in_rc = (r2 < rc2).to(dtype)
                u_r, w_r, _ = _screened_coulomb(r2, style, rc, consts)
                e_coul = e_coul + total(kqq[i] * (u_r * in_rc))
                hd = (kqq[i] * (w_r * in_rc))[:, None] * dx
                fi[:, :, rows, ..., i] = torch.sum(hd, dim=-1)
                fj_runs.append(torch.sum(hd, dim=-2))

                dxo = dx[..., 0::3, 0::3]                    # O-O block
                r2o = torch.clamp(dxo[:, 0] * dxo[:, 0]
                                  + dxo[:, 1] * dxo[:, 1]
                                  + dxo[:, 2] * dxo[:, 2], min=R2_MIN)
                in_rco = (r2o < rc2).to(dtype)
                if ljm is not None:
                    in_rco = ljm[iO] * in_rco
                inv_r2 = 1.0 / r2o
                inv_r6 = inv_r2 * inv_r2 * inv_r2
                e_lj = e_lj + total(
                    ((wm.c12_OO * inv_r6 - wm.c6_OO) * inv_r6
                     - wm.eshift_OO) * in_rco)
                fpd = ((c12x12 * inv_r6 - c6x6) * inv_r6 * inv_r2
                       * in_rco)[:, None] * dxo
                fiO[:, :, rows, ..., iO] = torch.sum(fpd, dim=-1)
                fjO_runs.append(torch.sum(fpd, dim=-2))
            fj[:, :, rows] = -sum(fj_runs[1:], fj_runs[0])
            fjO[:, :, rows] = -sum(fjO_runs[1:], fjO_runs[0])

        def fold(fi_, fj_):
            fi_, fj_ = (t.reshape(t.shape[:2] + p.grid + t.shape[-1:])
                        for t in (fi_, fj_))
            return fi_ + (fj_ if off is None
                          else torch.roll(fj_, off, dims=dims))

        f = f + fold(fi, fj)
        fO = fO + fold(fiO, fjO)
    f[..., 0::3] += fO
    return e_lj, e_coul, f


@replica_batched(5)
def water_pairs_in_cutoff(wxg, p: TileParams, box, rc):
    """The water atom pairs the hot-path function needs: unordered pairs
    of different molecules with r² < rc², over the half stencil plus half
    the self tile, masked exactly as water_water_fast_plain masks them
    (same rolled tiles and shifts, r² clamped at R2_MIN). A 0-d int64
    tensor on wxg's device, (R,) for a batch; it sets the work in K1's
    bound."""
    if min(p.grid) < 3:
        raise ValueError("water_pairs_in_cutoff needs grid >= 3 per dim")
    dims = (2, 3, 4)
    rc2 = rc * rc

    def n_in(xj, mask=None):
        dx = wxg[..., :, None] - xj[..., None, :]          # (R,3,...,A,A)
        r2 = torch.clamp(dx[:, 0] * dx[:, 0] + dx[:, 1] * dx[:, 1]
                         + dx[:, 2] * dx[:, 2], min=R2_MIN)
        inside = r2 < rc2
        return torch.sum((inside if mask is None else inside & mask)
                         .flatten(1), dim=-1)

    n = sum(n_in(torch.roll(wxg, tuple(-o for o in off), dims=dims)
                 + _roll_shift(box, p.grid, off, wxg.dtype))
            for off in p.half_stencil)
    mol = torch.arange(3 * p.W, device=wxg.device) // 3
    # the self tile holds each pair twice, with bitwise-equal r²
    return n + n_in(wxg, mol[:, None] != mol[None, :]) // 2


@replica_batched(5)
def water_water_fast(wxg, wm: WaterModel, p: TileParams, box, *,
                     style, alpha, rc, x_first=None):
    """Hot-path water-water block (forces + total energies). Launches the
    CUDA kernel for a CUDA tensor and runs the plain version for a CPU
    tensor; see water_water_fast_plain for the contract. With
    ``x_first``, K1's slab entry: wxg holds a rank's owned x-layers
    between two ghost layers (water_water_slab_plain)."""
    kw = dict(style=style, alpha=alpha, rc=rc)
    if wxg.is_cuda:
        return cuda_ww.water_water_cuda(wxg, wm, p, box, x_first=x_first,
                                        **kw)
    if wxg.device.type != "cpu":
        raise ValueError(f"water_water_fast: no kernel for {wxg.device}")
    if x_first is None:
        return water_water_fast_plain(wxg, wm, p, box, **kw)
    return water_water_slab_plain(wxg, wm, p, box, x_first=x_first, **kw)


def _slab_neighbour(t, off, x_axis):
    """The owned cells' neighbour tiles at stencil offset ``off`` of a
    slab's tile array t: one ghost layer on each side of the owned ones
    along ``x_axis`` (read without a wrap), y and z the next two axes
    (periodic, rolled)."""
    n = t.shape[x_axis] - 2
    nb = t.narrow(x_axis, 1 + off[0], n)
    return torch.roll(nb, (-off[1], -off[2]), dims=(x_axis + 1, x_axis + 2))


def _check_slab_grid(p: TileParams, name):
    if min(p.grid) < 3:
        raise ValueError(f"{name} needs the global grid >= 3 per dim")


@replica_batched(5)
def water_water_slab_plain(wxh, wm: WaterModel, p: TileParams, box, *,
                           x_first, style, alpha, rc):
    """Plain PyTorch version of K1's slab entry: the hot-path water-water
    block on a rank's x-slab. wxh: (3, n + 2, gy, gz, A), the n owned
    x-layers of the global grid p.grid (the first at global x ``x_first``)
    between two ghost layers; box: (3,). Returns (e_lj, e_coul, f (3, n,
    gy, gz, A)) of the owned cells: each owned atom's force from every
    pair, and every pair with an owned i atom counted with 0.5 (its other
    half belongs to the owner of j).

    i-side sums over the full 27-cell stencil (each pair from both of its
    molecules, as the kernel computes it, so nothing is written into the
    ghosts); the neighbour's image shift comes from its global x index
    and enters after the difference, dx = (x_i − x_j) − s, as in the
    kernel. Coulomb on all atom pairs with the Chebyshev screening fits;
    12-6 shifted LJ on O-O only; the self tile excludes same-molecule
    pairs."""
    _check_slab_grid(p, "water_water_slab_plain")
    W = p.W
    A = 3 * W
    R = wxh.shape[0]
    n = wxh.shape[2] - 2
    gy, gz = p.grid[1:]
    dtype, dev = wxh.dtype, wxh.device
    rc2 = rc * rc
    consts = coulomb_constants(style, alpha, rc)
    q_pat = np.tile(np.asarray(wm.q_pattern, np.float64), W)
    a_idx = np.arange(A)
    kqq_np = units.QQR2E * q_pat[:, None] * q_pat[None, :]
    nsm = (a_idx[:, None] // 3) != (a_idx[None, :] // 3)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    kqq_nbr, kqq_self = t(kqq_np), t(kqq_np * nsm)
    ljm_self = t(1.0 - np.eye(W))

    def total(x):                                    # per-replica sum
        return torch.sum(x.flatten(1), dim=-1)

    rows_n = n * gy
    xi4 = wxh.narrow(2, 1, n).reshape(R, 3, rows_n, gz, A)
    f = torch.zeros((R, 3, rows_n, gz, A), dtype=dtype, device=dev)
    fO = torch.zeros_like(f[..., 0::3])
    e_coul = torch.zeros((R,), dtype=dtype, device=dev)
    e_lj = torch.zeros((R,), dtype=dtype, device=dev)
    chunks = _row_chunks((n, gy, gz), A, wxh.element_size(), R)
    for off in _STENCIL27:
        own = off == (0, 0, 0)
        kqq = kqq_self if own else kqq_nbr
        xj4 = _slab_neighbour(wxh, off, 2).reshape(R, 3, rows_n, gz, A)
        sh4 = _roll_shift(box, p.grid, off, dtype, x_first, n).reshape(
            R, 3, rows_n, gz, 1, 1)
        for rows in chunks:
            dx = ((xi4[:, :, rows, :, :, None] - xj4[:, :, rows, :, None, :])
                  - sh4[:, :, rows])                      # (R,3,r,gz,A,A)
            r2 = torch.clamp(dx[:, 0] * dx[:, 0] + dx[:, 1] * dx[:, 1]
                             + dx[:, 2] * dx[:, 2], min=R2_MIN)
            in_rc = (r2 < rc2).to(dtype)
            u_r, w_r, _ = _screened_coulomb(r2, style, rc, consts)
            e_coul = e_coul + 0.5 * total(kqq * (u_r * in_rc))
            f[:, :, rows] += torch.sum((kqq * (w_r * in_rc))[:, None] * dx,
                                       dim=-1)
            dxo = dx[..., 0::3, 0::3]                     # O-O block
            r2o = torch.clamp(dxo[:, 0] * dxo[:, 0] + dxo[:, 1] * dxo[:, 1]
                              + dxo[:, 2] * dxo[:, 2], min=R2_MIN)
            in_rco = (r2o < rc2).to(dtype)
            if own:
                in_rco = ljm_self * in_rco
            inv_r2 = 1.0 / r2o
            inv_r6 = inv_r2 * inv_r2 * inv_r2
            e_lj = e_lj + 0.5 * total(
                ((wm.c12_OO * inv_r6 - wm.c6_OO) * inv_r6 - wm.eshift_OO)
                * in_rco)
            fO[:, :, rows] += torch.sum(
                ((12.0 * wm.c12_OO * inv_r6 - 6.0 * wm.c6_OO) * inv_r6
                 * inv_r2 * in_rco)[:, None] * dxo, dim=-1)
    f[..., 0::3] += fO
    return e_lj, e_coul, f.reshape(R, 3, n, gy, gz, A)


# -- the full-tally water-water kernel (K2) ---------------------------------

def _erfc_pos(x, expmx2):
    """erfc(x) for x ≥ 0 by Abramowitz–Stegun 7.1.26 (|ε| < 1.5e-7), with
    expmx2 = exp(−x²) shared with the Ewald gaussian term: the formula of
    the TPU kernel, which the CUDA kernel repeats."""
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
                + t * (-1.453152027 + t * 1.061405429))))
    return poly * expmx2


@replica_batched(5)
def pack_water_tiles(wxg, wvalid, wm: WaterModel, p: TileParams):
    """(3, gx, gy, gz, A) coords + (gx, gy, gz, W) validity → packed
    tiles (gx, gy, gz, 8, A): rows x, y, z, charge (pattern × valid), LJ
    mask (valid O slots), validity, and two zero rows."""
    q_pat, lj_pat, _ = _water_patterns(wm, p.W, wxg.dtype, wxg.device)
    vm = torch.repeat_interleave(wvalid, 3, dim=-1)          # (gx,gy,gz,A)
    zero = torch.zeros_like(vm)
    return torch.stack([wxg[:, 0], wxg[:, 1], wxg[:, 2], q_pat * vm,
                        lj_pat * vm, vm, zero, zero], dim=4).contiguous()


_STENCIL27 = tuple((ox, oy, oz) for ox in (-1, 0, 1) for oy in (-1, 0, 1)
                  for oz in (-1, 0, 1))                    # self at 13


@replica_batched(5)
def water_water_tally_plain(wt, box, wm: WaterModel, p: TileParams, *,
                            style, alpha, rc, x_first=None):
    """Plain PyTorch version of the full-tally water-water kernel (the
    TPU kernel pallas_ww.make_ww_kernel; CUDA csrc/ww_tally.cu), on the
    whole grid or on a rank's x-slab.

    wt: packed tiles (gx, gy, gz, 8, A) (pack_water_tiles); box (3,).
    Returns out (gx, gy, gz, 8, A): per slot force x, y, z, eatom_lj,
    eatom_coul and φ, then two zero rows. Full 27-offset stencil with
    i-side-only sums; per-pair min image (round half to even);
    validity weights, and on the self offset the same-molecule mask;
    masked pairs are pushed to r² = rc² + 1 before 1/r²; LJ on O rows by
    mask; Coulomb with the Abramowitz–Stegun erfc in DSF or 'cut' style.
    Needs grid ≥ 3 per dim (the 27 offsets must be distinct cells).

    With ``x_first`` (K2's slab entry), wt holds (n + 2, gy, gz, 8, A):
    the n owned x-layers of the global grid p.grid, the first at global x
    ``x_first``, between two ghost layers, and out is the owned cells'
    (n, gy, gz, 8, A). The whole grid is the slab of every layer with its
    periodic neighbours as ghosts, and runs as one: the neighbour tiles
    are read from the slab along x (no wrap) and rolled along y and z,
    and the per-pair min image on the global box makes the ghosts' raw
    coordinates give the whole grid's bits. ``x_first`` places the slab
    and does not enter the arithmetic."""
    if min(p.grid) < 3:
        raise ValueError("the full-tally water-water kernel needs grid >= 3 "
                         "per dim; use tiled.forces.water_water")
    if x_first is None:              # the whole grid: its x wrap as ghosts
        wt = torch.cat([wt[:, -1:], wt, wt[:, :1]], dim=1)
    A = 3 * p.W
    rc2 = rc * rc
    dtype, dev = wt.dtype, wt.device
    e_sh, f_sh, _, _ = coulomb_constants(style, alpha, rc)
    _, _, not_same_mol = _water_patterns(wm, p.W, dtype, dev)
    R = wt.shape[0]
    n = wt.shape[1] - 2
    gy, gz = p.grid[1:]
    bx = _box_dims(box, 5)
    inv_l = _box_dims(1.0 / box, 5)
    wt4 = wt.narrow(1, 1, n).reshape(R, n * gy, gz, 8, A)
    out = torch.zeros((R, n, gy, gz, 8, A), dtype=dtype, device=dev)
    out4 = out.view(R, n * gy, gz, 8, A)
    chunks = _row_chunks((n, gy, gz), A, wt.element_size(), R)
    slots = _slot_chunks(chunks, R, gz, A, wt.element_size(), dev)
    for k, off in enumerate(_STENCIL27):
        tile4 = _slab_neighbour(wt, off, 1).reshape(R, n * gy, gz, 8, A)
        for rows in chunks:
            for i in slots:
                out4[:, rows, ..., :6, i] += _tally_block(
                    wt4[:, rows, ..., i], tile4[:, rows], k == 13, bx,
                    inv_l, rc, rc2, e_sh, f_sh, alpha, style, wm,
                    not_same_mol[i])
    return out


def _tally_block(wt, tile, self_offset, box, inv_l, rc, rc2, e_sh, f_sh,
                 alpha, style, wm, not_same_mol):
    """The six per-slot sums (R, ..., 6, A) of packed tiles wt against one
    offset's tiles ``tile`` (water_water_tally_plain); box and inv_l are
    per-dim box lengths and inverses shaped to broadcast."""
    dtype = wt.dtype
    xi = [wt[..., d, :] for d in range(3)]
    qi, lji, vi = wt[..., 3, :], wt[..., 4, :], wt[..., 5, :]
    dx = []
    r2 = None
    for d in range(3):
        dd = xi[d][..., :, None] - tile[..., d, :][..., None, :]
        dd = dd - box[d] * torch.round(dd * inv_l[d])
        dx.append(dd)
        r2 = dd * dd if r2 is None else r2 + dd * dd
    w = vi[..., :, None] * tile[..., 5, :][..., None, :]
    if self_offset:
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
    return torch.stack(
        [torch.sum(fpair * dx[0], dim=-1),
         torch.sum(fpair * dx[1], dim=-1),
         torch.sum(fpair * dx[2], dim=-1),
         0.5 * torch.sum(e_lj_p, dim=-1),
         0.5 * torch.sum(kqq * u_r, dim=-1),
         units.QQR2E * torch.sum(qj * u_r, dim=-1)], dim=-2)


@replica_batched(5)
def water_pairs_in_cutoff_tally(wt, box, p: TileParams, rc):
    """The water atom pairs the full-tally function needs: unordered
    pairs of different molecules with weight > 0 and minimum-image
    r² < rc², masked exactly as water_water_tally_plain masks them (same
    rolled tiles, min image, weights and R2_MIN clamp). The 27 offsets
    hold each such pair twice, once from each atom, with bitwise-equal r².
    A 0-d int64 tensor on wt's device, (R,) for a batch; it sets the work
    in K2's bound."""
    if min(p.grid) < 3:
        raise ValueError("water_pairs_in_cutoff_tally needs grid >= 3 per "
                         "dim")
    rc2 = rc * rc
    R = wt.shape[0]
    bx = _box_dims(box, 6)
    inv_l = _box_dims(1.0 / box, 6)
    mol = torch.arange(3 * p.W, device=wt.device) // 3
    n = torch.zeros((R,), dtype=torch.int64, device=wt.device)
    for k, off in enumerate(_STENCIL27):
        tile = torch.roll(wt, tuple(-o for o in off), dims=(1, 2, 3))
        r2 = None
        for d in range(3):
            dd = wt[..., d, :, None] - tile[..., d, :][..., None, :]
            dd = dd - bx[d] * torch.round(dd * inv_l[d])
            r2 = dd * dd if r2 is None else r2 + dd * dd
        w = wt[..., 5, :, None] * tile[..., 5, :][..., None, :]
        live = w > 0
        if k == 13:
            live = live & (mol[:, None] != mol[None, :])
        n = n + torch.sum((live & (torch.clamp(r2, min=R2_MIN) < rc2))
                          .flatten(1), dim=-1)
    return n // 2


@replica_batched(5)
def water_water_tally(wxg, wvalid, wm: WaterModel, p: TileParams, box, *,
                      style, alpha, rc, x_first=None):
    """The full-tally water-water block through K2 (the counterpart of
    the JAX package's ``pallas_ww.water_water_pallas``, a drop-in for
    :func:`water_water` at grid ≥ 3): packs the tiles, launches the CUDA
    kernel for a CUDA tensor or runs the plain version for a CPU tensor,
    and returns (e_lj, e_coul, f (3, gx, gy, gz, A), eatom, phi). With
    ``x_first``, K2's slab entry: wxg (3, n + 2, gy, gz, A) and wvalid
    (n + 2, gy, gz, W) hold a rank's n owned x-layers between two ghost
    layers, and the outputs are the owned cells', the energies counting
    each pair with an owned atom half."""
    wt = pack_water_tiles(wxg, wvalid, wm, p)
    kw = dict(style=style, alpha=alpha, rc=rc, x_first=x_first)
    if wt.is_cuda:
        out = cuda_ww.water_water_tally_cuda(wt, box, wm, p, **kw)
    elif wt.device.type == "cpu":
        out = water_water_tally_plain(wt, box, wm, p, **kw)
    else:
        raise ValueError(f"water_water_tally: no kernel for {wt.device}")
    f = torch.movedim(out[..., :3, :], -2, 1)
    return (torch.sum(out[..., 3, :].flatten(1), dim=-1),
            torch.sum(out[..., 4, :].flatten(1), dim=-1), f,
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
