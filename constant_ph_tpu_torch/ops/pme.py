"""Smooth particle-mesh Ewald (PME) on the cell-tile layout (port of
constant_ph_tpu/ops/pme.py).

The mesh is aligned to the cell grid (M_d = g_d · m), so:

  - spreading: each cell computes an EXTENDED local mesh block (m + 2h
    per dim) from its own atoms by separable B-spline factor products,
    Q_ext = Bx @ (By ⊙ Bz ⊙ q): batched matmuls, no scatter;
  - the extended blocks overlap-add into the global mesh with three
    slices per dimension (h ≤ m, so only ±1 cells overlap);
  - the convolution with the influence function is one rfftn/irfftn pair;
  - interpolation (forces, and φ = ∂U/∂q for dU/dλ) is the exact
    transpose: extract extended blocks, contract with the (B, dB) factors.

B-splines are evaluated branchlessly in the clamped truncated-power form:
clipping the argument to [0, p] makes out-of-support arguments, parked
invalid slots at 10⁴ Å included, evaluate to exactly 0.

Energy convention as the JAX package's ops/ewald: U_rec = C·2π/V Σ_{k≠0}
e^{−k²/4α²}/k² |S(k)|², with the same self-energy and neutralising
background terms.

Precision: the JAX package asks for Precision.HIGH on the spreading and
interpolation contractions; here every matmul and einsum runs in full
float32, with TF32 off (make_pme_params and the tiled engine set
``torch.backends.cuda.matmul.allow_tf32 = False``), and the FFTs are
float32 (cuFFT on the GPU). PME has no hand kernel: it is PyTorch ops.

``pme_recip_tiled`` takes a batch of R replicas (a leading R on the
tiles, solute arrays and live box; one mesh and one FFT pair a replica,
all in the same launches); one replica's arrays run as a batch of one.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from constant_ph_tpu_torch import resolve_device, units
from constant_ph_tpu_torch.batching import bview, replica_batched
from constant_ph_tpu_torch.parallel import comm

_SQRT_PI = 1.7724538509055159


@dataclasses.dataclass
class PMEParams:
    alpha: float
    grid: tuple          # cell grid (gx, gy, gz)
    m: tuple             # mesh points per cell per dim
    p: int               # B-spline order
    h: tuple             # halo (mesh points)
    mesh: tuple          # (Mx, My, Mz)
    volume: float
    spacing: tuple
    Ahat: torch.Tensor   # (Mx, My, Mz//2+1) single-count influence incl |b|⁻²
    box: torch.Tensor    # (3,)
    # live-box (NPT) support: the box-independent pieces of Âhat — the
    # B-spline Euler factors and the integer mesh frequencies
    binv: torch.Tensor   # (Mx, My, Mz//2+1) 1/(|bx|²|by|²|bz|²)
    nx: torch.Tensor     # (Mx,) integer FFT frequencies
    ny: torch.Tensor     # (My,)
    nzr: torch.Tensor    # (Mz//2+1,) rfft frequencies


def _bspline_phi2(p: int, M: int) -> np.ndarray:
    """|b(k)|² Euler factors of the cardinal B-spline, length M."""
    k = np.arange(M)
    denom = np.zeros(M, dtype=np.complex128)
    for j in range(p - 1):
        denom += _bspline_np(np.array([j + 1.0]), p)[0] * np.exp(
            2j * np.pi * k * j / M)
    # for even p the denominator never vanishes; clamp anyway
    return np.maximum(np.abs(denom) ** 2, 1e-14)


def _bspline_np(u, p: int):
    """Cardinal B-spline M_p(u) on [0, p] (host-side, for |b|²)."""
    out = np.zeros_like(u, dtype=np.float64)
    for k in range(p + 1):
        out += ((-1.0) ** k * math.comb(p, k)
                * np.maximum(u - k, 0.0) ** (p - 1))
    return out / math.factorial(p - 1)


def make_pme_params(box, cell_grid, alpha: float, *, spacing: float = 0.9,
                    p: int = 6, slack: float | None = None,
                    skin: float = 2.0, mol_radius: float = 1.0,
                    device="cuda") -> PMEParams:
    """Host-side PME setup (float64 numpy, cast to float32 once).

    ``cell_grid`` is the tile grid (TileParams.grid); the mesh per dim is
    the smallest even m with g·m ≥ L/spacing. ``slack`` bounds how far an
    atom can sit outside its bin cell and sizes the halo h = p/2 +
    ceil(slack/spacing); by default mol_radius + skin, the worst case the
    tile layout accepts. Turns TF32 off, as the tiled engine does."""
    if p % 2 != 0:
        # odd orders have b(k) = 0 at the Nyquist frequency of an even
        # mesh, where the influence function blows up
        raise ValueError(f"PME B-spline order must be even, got p={p}")
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if slack is None:
        slack = mol_radius + skin
    box = np.asarray(box, dtype=np.float64)
    V = float(np.prod(box))
    g = tuple(int(x) for x in cell_grid)
    m = tuple(int(2 * math.ceil(L / (spacing * gd * 2))) for L, gd in
              zip(box, g))
    M = tuple(gd * md for gd, md in zip(g, m))
    sp = tuple(float(L / Md) for L, Md in zip(box, M))
    h = tuple(int(p // 2 + math.ceil(slack / s)) for s in sp)
    for hd, md in zip(h, m):
        if hd > md:
            raise ValueError(
                f"PME halo {h} exceeds per-cell mesh {m}; increase mesh "
                f"resolution (smaller spacing) or cell size")

    kx = 2 * np.pi * np.fft.fftfreq(M[0], d=1.0) * M[0] / box[0]
    ky = 2 * np.pi * np.fft.fftfreq(M[1], d=1.0) * M[1] / box[1]
    kz = 2 * np.pi * np.fft.rfftfreq(M[2], d=1.0) * M[2] / box[2]
    KX, KY, KZ = np.meshgrid(kx, ky, kz, indexing="ij")
    k2 = KX**2 + KY**2 + KZ**2
    with np.errstate(divide="ignore", invalid="ignore"):
        A = np.where(k2 > 1e-12,
                     np.exp(-k2 / (4 * alpha * alpha)) / k2, 0.0)
    A *= units.QQR2E * 2.0 * np.pi / V
    bx = _bspline_phi2(p, M[0])
    by = _bspline_phi2(p, M[1])
    bz = _bspline_phi2(p, M[2])[: M[2] // 2 + 1]
    binv = 1.0 / (bx[:, None, None] * by[None, :, None] * bz[None, None, :])
    A *= binv

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)

    return PMEParams(
        alpha=float(alpha), grid=g, m=m, p=int(p), h=h, mesh=M,
        volume=V, spacing=sp, Ahat=t(A), box=t(box), binv=t(binv),
        nx=t(np.rint(np.fft.fftfreq(M[0]) * M[0])),
        ny=t(np.rint(np.fft.fftfreq(M[1]) * M[1])),
        nzr=t(np.rint(np.fft.rfftfreq(M[2]) * M[2])),
    )


def pme_influence(pp: PMEParams, box):
    """(Âhat, mesh spacing, volume) from the LIVE box (device math; the
    NPT path). The mesh shape (grid, m, p, h) stays the build-time one.
    box (…, 3) with leading replica axes gives one Âhat (…, Mx, My,
    Mz//2+1), spacing and volume (…,) a replica."""
    V = box[..., 0] * box[..., 1] * box[..., 2]
    kx = (2.0 * math.pi) * pp.nx / box[..., 0:1]
    ky = (2.0 * math.pi) * pp.ny / box[..., 1:2]
    kz = (2.0 * math.pi) * pp.nzr / box[..., 2:3]
    k2 = ((kx * kx)[..., :, None, None] + (ky * ky)[..., None, :, None]
          + (kz * kz)[..., None, None, :])
    A = torch.where(k2 > 1e-12,
                    torch.exp(-k2 / (4.0 * pp.alpha * pp.alpha))
                    / torch.clamp(k2, min=1e-12), 0.0)
    A = A * (units.QQR2E * 2.0 * math.pi / V)[..., None, None, None] \
        * pp.binv
    sp = tuple(box[..., d] / pp.mesh[d] for d in range(3))
    return A.to(pp.Ahat.dtype), sp, V


def _mp_and_deriv(t, p: int):
    """Branchless M_p(t) and M_p'(t); t clipped to [0, p] so out-of-support
    arguments (parked slots included) give exactly (0, 0)."""
    t = torch.clamp(t, 0.0, float(p))
    mp = torch.zeros_like(t)
    dmp = torch.zeros_like(t)
    inv_fac = 1.0 / math.factorial(p - 1)
    for k in range(p + 1):
        c = ((-1.0) ** k) * math.comb(p, k)
        tk = torch.clamp(t - k, min=0.0)
        tkp = tk ** (p - 3)            # shared power
        mp = mp + c * tkp * tk * tk
        dmp = dmp + c * (p - 1) * tkp * tk
    return mp * inv_fac, dmp * inv_fac


def _cell_factors(wxg, sp, g, m, h, p, x_first=0):
    """B-spline factors between each cell's extended-block mesh indices
    and its atoms, for the three dimensions at once (one evaluation over
    the blocks of all axes, concatenated along the mesh axis: the same
    arithmetic per element, a third of the launches).

    wxg: (R, 3, gx, gy, gz, A) atom coords; sp: per-dim spacings (numbers,
    or (R,) tensors on a live box). Returns (Bd, dBd): per dimension d,
    (R, gx, gy, gz, ext_d, A) with ext_d = m_d + 2·h_d. On an x-slab wxg
    holds the cells of the x-layers from global layer ``x_first`` on."""
    dtype, dev = wxg.dtype, wxg.device
    R = wxg.shape[0]
    cells = tuple(wxg.shape[2:5])
    ts = []
    for d in range(3):
        u = wxg[:, d] / bview(sp[d], 5)
        first = x_first if d == 0 else 0
        base = (torch.arange(first, first + cells[d], dtype=dtype,
                             device=dev) * m[d])[:, None]
        jgrid = base + torch.arange(-h[d], m[d] + h[d], dtype=dtype,
                                    device=dev)[None, :]
        shape = [1, 1, 1, jgrid.shape[1], 1]
        shape[d] = cells[d]
        ts.append((u[..., None, :] - jgrid.reshape(shape) + p / 2.0)
                  .expand(R, *cells, jgrid.shape[1], u.shape[-1]))
    ext = [m[d] + 2 * h[d] for d in range(3)]
    B, dB = _mp_and_deriv(torch.cat(ts, dim=4), p)
    return torch.split(B, ext, dim=4), torch.split(dB, ext, dim=4)


def _overlap_add(Qext, g, m, h):
    """(R, gx, gy, gz, ex, ey, ez) extended blocks → (R, Mx, My, Mz) mesh
    (periodic). Each block's halo tail lands on the head of the next
    cell's block and its halo head on the tail of the previous one."""
    out = Qext
    for d in range(3):
        cell_ax, mesh_ax = 1 + d, 4 + d
        own = out.narrow(mesh_ax, h[d], m[d])
        tail = torch.roll(out.narrow(mesh_ax, m[d] + h[d], h[d]), 1,
                          dims=cell_ax)
        head = torch.roll(out.narrow(mesh_ax, 0, h[d]), -1, dims=cell_ax)
        # (own + tail padded at the end) + head padded at the start, as
        # the JAX package adds them; the sums go into a fresh copy
        res = own.clone()
        res.narrow(mesh_ax, 0, h[d]).add_(tail)
        res.narrow(mesh_ax, m[d] - h[d], h[d]).add_(head)
        out = res
    gx, gy, gz = g
    out = out.permute(0, 1, 4, 2, 5, 3, 6)
    return out.reshape(out.shape[0], gx * m[0], gy * m[1], gz * m[2])


def _extract_blocks(mesh, g, m, h):
    """(R, Mx, My, Mz) mesh → (R, gx, gy, gz, ex, ey, ez) extended blocks
    (periodic)."""
    gx, gy, gz = g
    blk = mesh.reshape(mesh.shape[0], gx, m[0], gy, m[1], gz, m[2]).permute(
        0, 1, 3, 5, 2, 4, 6)
    for d in range(3):
        cell_ax, mesh_ax = 1 + d, 4 + d
        prev_tail = torch.roll(blk, 1, dims=cell_ax).narrow(
            mesh_ax, m[d] - h[d], h[d])
        next_head = torch.roll(blk, -1, dims=cell_ax).narrow(mesh_ax, 0, h[d])
        blk = torch.cat([prev_tail, blk, next_head], dim=mesh_ax)
    return blk


def _solute_factors(s_mod, M, p):
    """Per dimension d, (R, M_d, Ns) B-spline factors of the solute atoms
    against the full mesh, with the periodic images at ±M_d; s_mod: (R,
    3, Ns) coords in mesh units. The three dimensions and three images go
    through one evaluation; the images are added in the order −M, 0, +M."""
    dtype, dev = s_mod.dtype, s_mod.device
    t = torch.cat([s_mod[:, d, None, :]
                   - torch.arange(M[d], dtype=dtype, device=dev)[:, None]
                   + p / 2.0 for d in range(3)], dim=1)   # (R, ΣM_d, Ns)
    shift = torch.cat([torch.full((M[d], 1), float(M[d]), dtype=dtype,
                                  device=dev) for d in range(3)])
    mp, dmp = _mp_and_deriv(torch.stack([t - shift, t, t + shift]), p)
    b = torch.split(mp[0] + mp[1] + mp[2], M, dim=1)
    db = torch.split(dmp[0] + dmp[1] + dmp[2], M, dim=1)
    return b, db


@replica_batched(5)
def pme_recip_tiled(wxg, wq, sx, qs, pp: PMEParams, *,
                    need_water_phi: bool = False, box=None, slab=None):
    """Reciprocal + self + background electrostatics on tiles + solute.

    One replica's shapes below; a batch adds a leading R to each array
    and to ``box`` (R, 3), and returns e (R,).

    wxg: (3, gx, gy, gz, A) water coords (box-wrapped; parked pads OK);
    wq: (gx, gy, gz, A) water charges (0 on invalid slots); sx: (Ns, 3)
    solute coords; qs: (Ns,) masked solute charges. ``box``: the LIVE box
    (NPT), from which the influence function, spacing and volume are
    derived on the device; None uses the params' build-time box. Returns
    (e, fw (3, gx, gy, gz, A), fs (Ns, 3), phi_s (Ns,), phi_w (gx, gy, gz,
    A) or None).

    On an x-slab of the cell grid (``slab``, a parallel.spatial.Slab) wxg
    and wq hold a rank's n owned x-layers, the first at global layer
    slab.x_first: each rank spreads its own cells into the full (R, Mx,
    My, Mz) mesh, the water mesh and the water charge sums are summed over
    slab.group in one all-reduce, and every rank adds the solute, runs the
    FFT and the influence function, and interpolates onto its own cells
    and the solute. fw and phi_w are the
    owned cells'; e, fs and phi_s are every rank's alike."""
    g, m, h, p = pp.grid, pp.m, pp.h, pp.p
    gx, gy, gz = g
    M = pp.mesh
    R = wxg.shape[0]
    n = wxg.shape[2]                                  # x-layers held
    x_first = 0 if slab is None else slab.x_first
    if box is None:
        sp, Ahat, volume = pp.spacing, pp.Ahat, pp.volume
        boxv = pp.box.expand(R, 3)
    else:
        Ahat, sp, volume = pme_influence(pp, box)
        boxv = box

    # ---- water spreading: per-cell extended blocks via factor matmuls ----
    Bd, dBd = _cell_factors(wxg, sp, g, m, h, p, x_first)
    ex, ey, ez = (m[d] + 2 * h[d] for d in range(3))
    A_at = wq.shape[-1]

    # (By ⊙ Bz) ⊙ q, the largest intermediate (R·G·ey·ez·A floats), made
    # once and scaled by q in place
    tyz_q = Bd[1][..., :, None, :] * Bd[2][..., None, :, :]  # (...,ey,ez,A)
    tyz_q.mul_(wq[..., None, None, :])
    tyz_q = tyz_q.reshape(R, n, gy, gz, ey * ez, A_at)
    Qext = torch.matmul(Bd[0], tyz_q.transpose(-1, -2))      # (...,ex,ey*ez)
    Qext = Qext.reshape(R, n, gy, gz, ex, ey, ez)
    if n != gx:                      # a slab: its blocks in the full grid
        full = Qext.new_zeros((R, gx, gy, gz, ex, ey, ez))
        full[:, x_first:x_first + n] = Qext
        Qext = full
    Q = _overlap_add(Qext, g, m, h)
    qsum_w = torch.sum(wq.flatten(1), dim=-1)
    q2sum_w = torch.sum((wq * wq).flatten(1), dim=-1)
    if slab is not None:
        red = comm.all_reduce_sum(torch.cat(
            [Q.reshape(R, -1), qsum_w[:, None], q2sum_w[:, None]], dim=1),
            slab.group)
        Q = red[:, :-2].reshape(Q.shape)
        qsum_w, q2sum_w = red[:, -2], red[:, -1]

    # ---- solute spreading (dense over the full mesh; Ns is small) ----
    Ns = qs.shape[-1]
    sb, sdb = _solute_factors(torch.stack(
        [torch.remainder(sx[..., d], boxv[:, d:d + 1]) / bview(sp[d], 2)
         for d in range(3)], dim=1), M, p)
    tyz_s = (sb[1][:, :, None, :] * sb[2][:, None, :, :]).reshape(
        R, M[1] * M[2], Ns)
    Qs = torch.matmul(sb[0] * qs[:, None, :],
                      tyz_s.transpose(-1, -2)).reshape(R, M[0], M[1], M[2])
    Q = Q + Qs

    # ---- k-space convolution: φ_mesh = ∂E/∂Q = 2·M³·irfftn(Ahat ⊙ Q̂) ----
    mesh_dims = (-3, -2, -1)
    Qhat = torch.fft.rfftn(Q, dim=mesh_dims)
    n_mesh = M[0] * M[1] * M[2]
    phi_mesh = (2.0 * n_mesh) * torch.fft.irfftn(Ahat * Qhat, s=M,
                                                 dim=mesh_dims)
    e_rec = 0.5 * torch.sum(Q * phi_mesh, dim=mesh_dims)

    # ---- interpolation: forces (+ φ where needed) ----
    blk2 = _extract_blocks(phi_mesh, g, m, h).narrow(1, x_first, n).reshape(
        R, n, gy, gz, ex, ey * ez)
    V0 = torch.matmul(Bd[0].transpose(-1, -2), blk2)        # (...,A,ey*ez)
    V1 = torch.matmul(dBd[0].transpose(-1, -2), blk2)
    V0 = V0.reshape(R, n, gy, gz, A_at, ey, ez)
    V1 = V1.reshape(R, n, gy, gz, A_at, ey, ez)
    W00 = torch.einsum("...ya,...ayz->...az", Bd[1], V0)
    W10 = torch.einsum("...ya,...ayz->...az", Bd[1], V1)
    W01 = torch.einsum("...ya,...ayz->...az", dBd[1], V0)
    sx_sum = torch.einsum("...za,...az->...a", Bd[2], W10)
    sy_sum = torch.einsum("...za,...az->...a", Bd[2], W01)
    sz_sum = torch.einsum("...za,...az->...a", dBd[2], W00)
    fw = torch.stack([-wq * sx_sum / bview(sp[0], 5),
                      -wq * sy_sum / bview(sp[1], 5),
                      -wq * sz_sum / bview(sp[2], 5)], dim=1)
    phi_w = None
    if need_water_phi:
        phi_w = torch.einsum("...za,...az->...a", Bd[2], W00)

    # solute interpolation
    phi_flat = phi_mesh.reshape(R, M[0], M[1] * M[2])
    U0 = torch.matmul(sb[0].transpose(-1, -2), phi_flat).reshape(
        R, Ns, M[1], M[2])
    U1 = torch.matmul(sdb[0].transpose(-1, -2), phi_flat).reshape(
        R, Ns, M[1], M[2])
    R00 = torch.einsum("rya,rayz->raz", sb[1], U0)
    R10 = torch.einsum("rya,rayz->raz", sb[1], U1)
    R01 = torch.einsum("rya,rayz->raz", sdb[1], U0)
    phi_s = torch.einsum("rza,raz->ra", sb[2], R00)
    fs = torch.stack([
        -qs * torch.einsum("rza,raz->ra", sb[2], R10) / bview(sp[0], 2),
        -qs * torch.einsum("rza,raz->ra", sb[2], R01) / bview(sp[1], 2),
        -qs * torch.einsum("rza,raz->ra", sdb[2], R00) / bview(sp[2], 2),
    ], dim=-1)

    # ---- self energy + neutralising background (as in ops.ewald) ----
    C = units.QQR2E
    qsum = qsum_w + torch.sum(qs, dim=-1)
    q2sum = q2sum_w + torch.sum(qs * qs, dim=-1)
    e_self = -C * pp.alpha / _SQRT_PI * q2sum
    e_bg = -C * math.pi / (2.0 * pp.alpha**2 * volume) * qsum * qsum
    corr0 = -2.0 * C * pp.alpha / _SQRT_PI
    corr1 = -C * math.pi / (pp.alpha**2 * volume) * qsum
    phi_s = phi_s + corr0 * qs + bview(corr1, 2)
    if need_water_phi:
        phi_w = phi_w + corr0 * wq + bview(corr1, 5)

    return e_rec + e_self + e_bg, fw, fs, phi_s, phi_w
