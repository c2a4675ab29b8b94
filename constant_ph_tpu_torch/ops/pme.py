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
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from constant_ph_tpu_torch import resolve_device, units

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
    NPT path). The mesh shape (grid, m, p, h) stays the build-time one."""
    V = box[0] * box[1] * box[2]
    kx = (2.0 * math.pi) * pp.nx / box[0]
    ky = (2.0 * math.pi) * pp.ny / box[1]
    kz = (2.0 * math.pi) * pp.nzr / box[2]
    k2 = ((kx * kx)[:, None, None] + (ky * ky)[None, :, None]
          + (kz * kz)[None, None, :])
    A = torch.where(k2 > 1e-12,
                    torch.exp(-k2 / (4.0 * pp.alpha * pp.alpha))
                    / torch.clamp(k2, min=1e-12), 0.0)
    A = A * (units.QQR2E * 2.0 * math.pi / V) * pp.binv
    sp = tuple(box[d] / pp.mesh[d] for d in range(3))
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


def _cell_factors(wxg, sp, g, m, h, p):
    """B-spline factors between each cell's extended-block mesh indices
    and its atoms, for the three dimensions at once (one evaluation over
    the blocks of all axes, concatenated along the mesh axis: the same
    arithmetic per element, a third of the launches).

    wxg: (3, gx, gy, gz, A) atom coords. Returns (Bd, dBd): per dimension
    d, (gx, gy, gz, ext_d, A) with ext_d = m_d + 2·h_d."""
    dtype, dev = wxg.dtype, wxg.device
    ts = []
    for d in range(3):
        u = wxg[d] / sp[d]
        base = (torch.arange(g[d], dtype=dtype, device=dev) * m[d])[:, None]
        jgrid = base + torch.arange(-h[d], m[d] + h[d], dtype=dtype,
                                    device=dev)[None, :]
        shape = [1, 1, 1, jgrid.shape[1], 1]
        shape[d] = g[d]
        ts.append((u[..., None, :] - jgrid.reshape(shape) + p / 2.0)
                  .expand(*g, jgrid.shape[1], u.shape[-1]))
    ext = [m[d] + 2 * h[d] for d in range(3)]
    B, dB = _mp_and_deriv(torch.cat(ts, dim=3), p)
    return torch.split(B, ext, dim=3), torch.split(dB, ext, dim=3)


def _overlap_add(Qext, g, m, h):
    """(gx, gy, gz, ex, ey, ez) extended blocks → (Mx, My, Mz) mesh
    (periodic). Each block's halo tail lands on the head of the next
    cell's block and its halo head on the tail of the previous one."""
    out = Qext
    for d in range(3):
        cell_ax, mesh_ax = d, 3 + d
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
    out = out.permute(0, 3, 1, 4, 2, 5)
    return out.reshape(gx * m[0], gy * m[1], gz * m[2])


def _extract_blocks(mesh, g, m, h):
    """(Mx, My, Mz) mesh → (gx, gy, gz, ex, ey, ez) extended blocks
    (periodic)."""
    gx, gy, gz = g
    blk = mesh.reshape(gx, m[0], gy, m[1], gz, m[2]).permute(
        0, 2, 4, 1, 3, 5)
    for d in range(3):
        cell_ax, mesh_ax = d, 3 + d
        prev_tail = torch.roll(blk, 1, dims=cell_ax).narrow(
            mesh_ax, m[d] - h[d], h[d])
        next_head = torch.roll(blk, -1, dims=cell_ax).narrow(mesh_ax, 0, h[d])
        blk = torch.cat([prev_tail, blk, next_head], dim=mesh_ax)
    return blk


def _solute_factors(s_mod, M, p):
    """Per dimension d, (M_d, Ns) B-spline factors of the solute atoms
    against the full mesh, with the periodic images at ±M_d; s_mod: (3,
    Ns) coords in mesh units. The three dimensions and three images go
    through one evaluation; the images are added in the order −M, 0, +M."""
    dtype, dev = s_mod.dtype, s_mod.device
    t = torch.cat([s_mod[d][None, :]
                   - torch.arange(M[d], dtype=dtype, device=dev)[:, None]
                   + p / 2.0 for d in range(3)])          # (ΣM_d, Ns)
    shift = torch.cat([torch.full((M[d], 1), float(M[d]), dtype=dtype,
                                  device=dev) for d in range(3)])
    mp, dmp = _mp_and_deriv(torch.stack([t - shift, t, t + shift]), p)
    b = torch.split(mp[0] + mp[1] + mp[2], M)
    db = torch.split(dmp[0] + dmp[1] + dmp[2], M)
    return b, db


def pme_recip_tiled(wxg, wq, sx, qs, pp: PMEParams, *,
                    need_water_phi: bool = False, box=None):
    """Reciprocal + self + background electrostatics on tiles + solute.

    wxg: (3, gx, gy, gz, A) water coords (box-wrapped; parked pads OK);
    wq: (gx, gy, gz, A) water charges (0 on invalid slots); sx: (Ns, 3)
    solute coords; qs: (Ns,) masked solute charges. ``box``: the LIVE box
    (NPT), from which the influence function, spacing and volume are
    derived on the device; None uses the params' build-time box. Returns
    (e, fw (3, gx, gy, gz, A), fs (Ns, 3), phi_s (Ns,), phi_w (gx, gy, gz,
    A) or None)."""
    g, m, h, p = pp.grid, pp.m, pp.h, pp.p
    gx, gy, gz = g
    M = pp.mesh
    if box is None:
        sp, Ahat, volume, boxv = pp.spacing, pp.Ahat, pp.volume, pp.box
    else:
        Ahat, sp, volume = pme_influence(pp, box)
        boxv = box

    # ---- water spreading: per-cell extended blocks via factor matmuls ----
    Bd, dBd = _cell_factors(wxg, sp, g, m, h, p)
    ex, ey, ez = (m[d] + 2 * h[d] for d in range(3))
    A_at = wq.shape[-1]

    # (By ⊙ Bz) ⊙ q, the largest intermediate (G·ey·ez·A floats), made once
    # and scaled by q in place
    tyz_q = Bd[1][..., :, None, :] * Bd[2][..., None, :, :]  # (...,ey,ez,A)
    tyz_q.mul_(wq[..., None, None, :])
    tyz_q = tyz_q.reshape(gx, gy, gz, ey * ez, A_at)
    Qext = torch.matmul(Bd[0], tyz_q.transpose(-1, -2))      # (...,ex,ey*ez)
    Q = _overlap_add(Qext.reshape(gx, gy, gz, ex, ey, ez), g, m, h)

    # ---- solute spreading (dense over the full mesh; Ns is small) ----
    Ns = qs.shape[0]
    sb, sdb = _solute_factors(torch.stack(
        [torch.remainder(sx[:, d], boxv[d]) / sp[d] for d in range(3)]),
        M, p)
    tyz_s = (sb[1][:, None, :] * sb[2][None, :, :]).reshape(M[1] * M[2], Ns)
    Qs = torch.matmul(sb[0] * qs[None, :], tyz_s.T).reshape(M[0], M[1], M[2])
    Q = Q + Qs

    # ---- k-space convolution: φ_mesh = ∂E/∂Q = 2·M³·irfftn(Ahat ⊙ Q̂) ----
    Qhat = torch.fft.rfftn(Q)
    n_mesh = M[0] * M[1] * M[2]
    phi_mesh = (2.0 * n_mesh) * torch.fft.irfftn(Ahat * Qhat, s=M)
    e_rec = 0.5 * torch.sum(Q * phi_mesh)

    # ---- interpolation: forces (+ φ where needed) ----
    blk2 = _extract_blocks(phi_mesh, g, m, h).reshape(gx, gy, gz, ex,
                                                      ey * ez)
    V0 = torch.matmul(Bd[0].transpose(-1, -2), blk2)        # (...,A,ey*ez)
    V1 = torch.matmul(dBd[0].transpose(-1, -2), blk2)
    V0 = V0.reshape(gx, gy, gz, A_at, ey, ez)
    V1 = V1.reshape(gx, gy, gz, A_at, ey, ez)
    W00 = torch.einsum("...ya,...ayz->...az", Bd[1], V0)
    W10 = torch.einsum("...ya,...ayz->...az", Bd[1], V1)
    W01 = torch.einsum("...ya,...ayz->...az", dBd[1], V0)
    sx_sum = torch.einsum("...za,...az->...a", Bd[2], W10)
    sy_sum = torch.einsum("...za,...az->...a", Bd[2], W01)
    sz_sum = torch.einsum("...za,...az->...a", dBd[2], W00)
    fw = torch.stack([-wq * sx_sum / sp[0], -wq * sy_sum / sp[1],
                      -wq * sz_sum / sp[2]])
    phi_w = None
    if need_water_phi:
        phi_w = torch.einsum("...za,...az->...a", Bd[2], W00)

    # solute interpolation
    phi_flat = phi_mesh.reshape(M[0], M[1] * M[2])
    U0 = torch.matmul(sb[0].T, phi_flat).reshape(Ns, M[1], M[2])
    U1 = torch.matmul(sdb[0].T, phi_flat).reshape(Ns, M[1], M[2])
    R00 = torch.einsum("ya,ayz->az", sb[1], U0)
    R10 = torch.einsum("ya,ayz->az", sb[1], U1)
    R01 = torch.einsum("ya,ayz->az", sdb[1], U0)
    phi_s = torch.einsum("za,az->a", sb[2], R00)
    fs = torch.stack([
        -qs * torch.einsum("za,az->a", sb[2], R10) / sp[0],
        -qs * torch.einsum("za,az->a", sb[2], R01) / sp[1],
        -qs * torch.einsum("za,az->a", sdb[2], R00) / sp[2],
    ], dim=-1)

    # ---- self energy + neutralising background (as in ops.ewald) ----
    C = units.QQR2E
    qsum = torch.sum(wq) + torch.sum(qs)
    q2sum = torch.sum(wq * wq) + torch.sum(qs * qs)
    e_self = -C * pp.alpha / _SQRT_PI * q2sum
    e_bg = -C * math.pi / (2.0 * pp.alpha**2 * volume) * qsum * qsum
    corr0 = -2.0 * C * pp.alpha / _SQRT_PI
    corr1 = -C * math.pi / (pp.alpha**2 * volume) * qsum
    phi_s = phi_s + corr0 * qs + corr1
    if need_water_phi:
        phi_w = phi_w + corr0 * wq + corr1

    return e_rec + e_self + e_bg, fw, fs, phi_s, phi_w
