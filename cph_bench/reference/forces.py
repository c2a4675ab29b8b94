"""The plain reference of the port's force field, in float64 PyTorch.

It reads only the benchmark's own inputs (the numpy dicts of
cph_bench/inputs) and the configuration, and never imports the port. Per
replica, from positions in atom order, λ and pH, it gives every energy
term, the forces (−∂E/∂x by autograd), the electrostatic potential on
each atom (∂E/∂q by autograd) and the λ force. The terms and their
conventions:

- pairs: every unordered atom pair within the cutoff once (all pairs,
  in blocks of rows), LJ 12-6 shifted to 0 at the cutoff, Coulomb 'cut'
  (plain, or Ewald real space erfc(αr)/r) or 'dsf' (Fennell–Gezelter);
- special pairs (1-2, 1-3, 1-4 of the bond graph): LJ scaled by
  SPECIAL_LJ; Coulomb scaled by SPECIAL_COUL under 'dsf', and under
  'cut' given (erfc(αr) − (1 − s))/r, which with α > 0 removes what the
  reciprocal sum adds for an excluded pair. The one exception is a water
  of the tiles (rigid, no λ charge): its three internal pairs carry no
  term at all, and with k-space the constant −C Σ q q erf(αr)/r of its
  rigid geometry is added to the energy (it does no work on a rigid
  body);
- k-space: smooth PME (Essmann et al. 1995) of order p on the stated
  mesh, the Euler factors |b(k)|², U = C·2π/V Σ_{k≠0} e^{−k²/4α²}/k²
  |S(k)|², plus the self term −Cα/√π Σq² and the neutralising background
  −Cπ/(2α²V) (Σq)²;
- bonded: harmonic bonds and angles, CHARMM dihedrals;
- λ: q(λ) = q0 + Σ λ_s Δq_s; the pH term f(λ)(kT ln10 (pK − pH) −
  ΔG_ref) with f = sigmoid(50(λ − ½)); the Donnini–Ullmann bias; and, in a
  metadynamics cell, the bias tables of cph_bench/reference/metad.py.

``Precision("tf32")`` is the control: the same arithmetic in float32
with every operand of the pair, spline and mesh products rounded to
TF32's 10-bit mantissa, as a tensor-core matmul rounds its inputs.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from cph_bench.inputs import common as c

QQR2E = 332.06371
LN10 = 2.302585092994046
TWO_OVER_SQRT_PI = 2.0 / math.sqrt(math.pi)
# Donnini–Ullmann bias constants (kcal/mol; λ dimensionless) and the
# slope of the switching sigmoid
BIAS = dict(w=200.0, s=0.3, k=2.533, a=0.034041, b=0.005238, r=16.458,
            m=0.1507, d=2.0, slope=50.0)


def tf32_round(t):
    """float32 → the nearest value with a 10-bit mantissa (ties away)."""
    i = t.to(torch.float32).contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str = "float64"

    @property
    def dtype(self):
        return torch.float64 if self.name == "float64" else torch.float32

    def r(self, t):
        """t rounded to this precision's operands; the gradient passes
        through the rounding."""
        if self.name != "tf32":
            return t
        return t + (tf32_round(t.detach()) - t.detach())


@dataclasses.dataclass
class Topology:
    """What the reference needs of one system, as tensors on a device:
    charges, LJ tables, special pairs, bonded terms, sites, the rigid
    waters of the tiles and of the solute, and the atom order of the
    tiles (the port's split: waters that carry no λ charge go to the
    tiles, in builder order; everything else is solute, in id order)."""

    q0: torch.Tensor
    types: torch.Tensor
    c6: torch.Tensor
    c12: torch.Tensor
    esh: torch.Tensor
    mass: torch.Tensor
    pairs_i: torch.Tensor       # special pairs, i < j
    pairs_j: torch.Tensor
    pairs_code: torch.Tensor
    pairs_rigid: torch.Tensor   # 1 where both atoms are one tiled water
    bonded: dict
    site_idx: torch.Tensor
    site_dq: torch.Tensor
    site_mask: torch.Tensor
    pK: torch.Tensor
    tiled_waters: np.ndarray    # (Mw, 3) atom ids, the tiles' wid order
    buffer_waters: np.ndarray   # (Mb, 3)
    solute_ids: np.ndarray      # sorted
    cutoff: float
    alpha: float
    style: str
    n_atoms: int


def topology(d, device, dtype=torch.float64):
    ff = d["ff"]
    pair = ff["pair"]
    n = len(ff["mass"])
    site_atoms = set(np.asarray(d["spec"]["atom_idx"])[
        np.asarray(d["spec"]["atom_mask"]) > 0].tolist())
    trip = np.asarray(d["constraints"]["triplets"], np.int64)
    buf = np.array([bool(site_atoms & set(t.tolist())) for t in trip])
    tiled, buffer = trip[~buf], trip[buf]
    in_tiles = np.zeros(n, bool)
    in_tiles[tiled.reshape(-1)] = True
    mol = np.full(n, -1, np.int64)
    mol[tiled.reshape(-1)] = np.repeat(np.arange(len(tiled)), 3)

    ei, ec = np.asarray(ff["excl_idx"]), np.asarray(ff["excl_code"])
    ii, ss = np.nonzero(ei >= 0)
    jj = ei[ii, ss].astype(np.int64)
    keep = ii < jj
    ii, jj, code = ii[keep], jj[keep], ec[ii, ss][keep]
    rigid = (mol[ii] >= 0) & (mol[ii] == mol[jj])

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)

    def i(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    b = d["bonded"]
    bonded = {k: (i(v) if k.endswith("_idx") else f(v)) for k, v in b.items()}
    sp = d["spec"]
    return Topology(
        q0=f(ff["q0"]), types=i(ff["type"]), c6=f(pair["c6"]),
        c12=f(pair["c12"]), esh=f(pair["e_shift"]), mass=f(ff["mass"]),
        pairs_i=i(ii), pairs_j=i(jj), pairs_code=i(code),
        pairs_rigid=f(rigid), bonded=bonded, site_idx=i(sp["atom_idx"]),
        site_dq=f(sp["dq"]), site_mask=f(sp["atom_mask"]), pK=f(sp["pK"]),
        tiled_waters=tiled, buffer_waters=buffer,
        solute_ids=np.nonzero(~in_tiles)[0], cutoff=float(pair["cutoff"]),
        alpha=float(pair["alpha"]), style=str(pair["coul_style"]),
        n_atoms=n)


def _min_image(dx, box):
    return dx - box * torch.round(dx / box)


def _coulomb_u(r, s, style, alpha, rc):
    """Energy per unit C·qq of a pair at distance r with special scale s
    (1 for a normal pair)."""
    erfc = torch.special.erfc(alpha * r) if alpha > 0 else torch.ones_like(r)
    if style == "dsf":
        e_rc = math.erfc(alpha * rc)
        f_sh = e_rc / rc**2 + (TWO_OVER_SQRT_PI * alpha
                               * math.exp(-(alpha * rc) ** 2) / rc)
        return s * (erfc / r - e_rc / rc + f_sh * (r - rc))
    return (erfc - (1.0 - s)) / r


def _pair_energy(dx, ti, tj, qi, qj, top, s_lj, s_c, prec, c_mult=1.0):
    """Σ of LJ and Coulomb over pairs with displacement dx (…, 3), inside
    the cutoff: (E_lj, E_coul). s_lj and s_c are the special scales,
    c_mult a factor on the whole Coulomb term."""
    dx = prec.r(dx)
    r2 = torch.sum(dx * dx, dim=-1)
    rc = top.cutoff
    inside = r2 < rc * rc
    r2 = torch.where(inside, r2, torch.full_like(r2, rc * rc))
    r = torch.sqrt(r2)
    inv6 = 1.0 / (r2 * r2 * r2)
    c6 = top.c6[ti, tj].to(r.dtype)
    c12 = top.c12[ti, tj].to(r.dtype)
    esh = top.esh[ti, tj].to(r.dtype)
    e_lj = s_lj * ((c12 * inv6 - c6) * inv6 - esh)
    e_c = QQR2E * prec.r(qi * qj) * _coulomb_u(r, s_c, top.style, top.alpha,
                                              rc) * c_mult
    zero = torch.zeros_like(r2)
    return (torch.sum(torch.where(inside, e_lj, zero)),
            torch.sum(torch.where(inside, e_c, zero)))


def real_space(x, q, box, top, prec, rows=1024):
    """Pair energies with their gradients by x and q, one block of rows
    at a time (each block's graph is freed before the next). Returns
    (e_lj, e_coul, dE/dx, dE/dq)."""
    n = x.shape[0]
    gx = torch.zeros_like(x)
    gq = torch.zeros_like(q)
    e_lj = e_c = 0.0
    ar = torch.arange(n, device=x.device)
    for a in range(0, n, rows):
        b = min(n, a + rows)
        xs = x.detach().requires_grad_(True)
        qs = q.detach().requires_grad_(True)
        dx = _min_image(xs[a:b, None, :] - xs[None, :, :], box)
        upper = ar[None, :] > ar[a:b, None]              # each pair once
        dx = torch.where(upper[..., None], dx,
                         torch.full_like(dx, 2.0 * top.cutoff))
        el, ec = _pair_energy(dx, top.types[a:b, None], top.types[None, :],
                              qs[a:b, None], qs[None, :], top, 1.0, 1.0,
                              prec)
        g = torch.autograd.grad(el + ec, (xs, qs))
        gx += g[0]
        gq += g[1]
        e_lj += float(el.detach())
        e_c += float(ec.detach())
    # special pairs: take the normal term off, put the special one on
    xs = x.detach().requires_grad_(True)
    qs = q.detach().requires_grad_(True)
    i, j = top.pairs_i, top.pairs_j
    dx = _min_image(xs[i] - xs[j], box)
    ti, tj, qi, qj = top.types[i], top.types[j], qs[i], qs[j]
    sl = torch.as_tensor(c.SPECIAL_LJ, dtype=x.dtype,
                         device=x.device)[top.pairs_code]
    sc = torch.as_tensor(c.SPECIAL_COUL, dtype=x.dtype,
                         device=x.device)[top.pairs_code]
    keep = 1.0 - top.pairs_rigid.to(x.dtype)     # tiled waters: no term
    el0, ec0 = _pair_energy(dx, ti, tj, qi, qj, top, 1.0, 1.0, prec)
    el1, ec1 = _pair_energy(dx, ti, tj, qi, qj, top, sl * keep, sc, prec,
                            c_mult=keep)
    de = (el1 - el0) + (ec1 - ec0)
    g = torch.autograd.grad(de, (xs, qs))
    return (e_lj + float((el1 - el0).detach()),
            e_c + float((ec1 - ec0).detach()), gx + g[0],
            gq + g[1])


def _bspline(t, p):
    """Cardinal B-spline M_p(t) on [0, p] (truncated powers; float64)."""
    out = torch.zeros_like(t)
    for k in range(p + 1):
        out = out + ((-1.0) ** k * math.comb(p, k)
                     * torch.clamp(t - k, min=0.0) ** (p - 1))
    return out / math.factorial(p - 1)


def _euler_b2(p, M):
    k = np.arange(M)
    den = np.zeros(M, np.complex128)
    for j in range(p - 1):
        t = float(j + 1)
        mp = sum((-1.0) ** a * math.comb(p, a) * max(t - a, 0.0) ** (p - 1)
                 for a in range(p + 1)) / math.factorial(p - 1)
        den += mp * np.exp(2j * np.pi * k * j / M)
    return np.abs(den) ** 2


def pme_energy(x, q, box, alpha, mesh, p, prec):
    """Reciprocal, self and background energy of smooth PME, a
    differentiable function of x and q."""
    M = [int(m) for m in mesh]
    dev, dt = x.device, x.dtype
    u = torch.remainder(x / box, 1.0) * torch.as_tensor(M, dtype=dt,
                                                         device=dev)
    u = prec.r(u)
    base = torch.floor(u)
    frac = u - base
    ks = torch.arange(p, dtype=dt, device=dev)
    w = prec.r(_bspline(frac[:, :, None] + ks, p))          # (N, 3, p)
    idx = [torch.remainder(base[:, d, None].long() - ks.long(), M[d])
           for d in range(3)]                               # (N, p) each
    flat = ((idx[0][:, :, None, None] * M[1] + idx[1][:, None, :, None])
            * M[2] + idx[2][:, None, None, :])
    vals = (q[:, None, None, None] * w[:, 0, :, None, None]
            * w[:, 1, None, :, None] * w[:, 2, None, None, :])
    Q = torch.zeros(M[0] * M[1] * M[2], dtype=dt, device=dev).index_add(
        0, flat.reshape(-1), prec.r(vals).reshape(-1)).reshape(M)
    S = torch.fft.fftn(Q)
    V = float(box[0] * box[1] * box[2])
    freqs = [torch.fft.fftfreq(M[d], d=1.0 / M[d], dtype=torch.float64,
                               device=dev) * (2 * math.pi / float(box[d]))
             for d in range(3)]
    k2 = (freqs[0][:, None, None] ** 2 + freqs[1][None, :, None] ** 2
          + freqs[2][None, None, :] ** 2)
    b2 = [torch.as_tensor(_euler_b2(p, M[d]), device=dev) for d in range(3)]
    A = torch.where(k2 > 0, torch.exp(-k2 / (4 * alpha * alpha))
                    / torch.where(k2 > 0, k2, torch.ones_like(k2)),
                    torch.zeros_like(k2))
    A = A * (QQR2E * 2 * math.pi / V) / (b2[0][:, None, None]
                                          * b2[1][None, :, None]
                                          * b2[2][None, None, :])
    e_rec = torch.sum(A.to(dt) * (S.real ** 2 + S.imag ** 2))
    qsum = torch.sum(q)
    e_self = -QQR2E * alpha / math.sqrt(math.pi) * torch.sum(q * q)
    e_bg = -QQR2E * math.pi / (2 * alpha * alpha * V) * qsum * qsum
    return e_rec + e_self + e_bg


def bonded_energy(x, box, b):
    def at(k):
        return x[k]

    e = x.new_zeros(())
    if b["bond_idx"].shape[0]:
        dx = _min_image(at(b["bond_idx"][:, 0]) - at(b["bond_idx"][:, 1]),
                        box)
        r = torch.sqrt(torch.sum(dx * dx, dim=-1))
        e = e + torch.sum(b["bond_k"] * (r - b["bond_r0"]) ** 2
                          * b["bond_mask"])
    if b["angle_idx"].shape[0]:
        xj = at(b["angle_idx"][:, 1])
        r1 = _min_image(at(b["angle_idx"][:, 0]) - xj, box)
        r2 = _min_image(at(b["angle_idx"][:, 2]) - xj, box)
        th = torch.atan2(torch.linalg.norm(torch.linalg.cross(r1, r2), dim=-1),
                         torch.sum(r1 * r2, dim=-1))
        e = e + torch.sum(b["angle_k"] * (th - b["angle_t0"]) ** 2
                          * b["angle_mask"])
    if b["dihedral_idx"].shape[0]:
        ix = b["dihedral_idx"]
        b1 = _min_image(at(ix[:, 1]) - at(ix[:, 0]), box)
        b2 = _min_image(at(ix[:, 2]) - at(ix[:, 1]), box)
        b3 = _min_image(at(ix[:, 3]) - at(ix[:, 2]), box)
        n1 = torch.linalg.cross(b1, b2)
        n2 = torch.linalg.cross(b2, b3)
        m1 = torch.linalg.cross(n1, b2 / torch.linalg.norm(b2, dim=-1,
                                                            keepdim=True))
        phi = torch.atan2(torch.sum(m1 * n2, -1), torch.sum(n1 * n2, -1))
        e = e + torch.sum(b["dihedral_k"] * (1.0 + torch.cos(
            b["dihedral_n"] * phi - b["dihedral_d"])) * b["dihedral_mask"])
    return e


def switching(lam):
    f = torch.sigmoid(BIAS["slope"] * (lam - 0.5))
    return f


def bias_energy(lam):
    p = BIAS
    a2, s2 = p["a"] ** 2, p["s"] ** 2
    u = (-p["k"] * torch.exp(-(lam - 1.0 - p["b"]) ** 2 / (2 * a2))
         - p["k"] * torch.exp(-(lam + p["b"]) ** 2 / (2 * a2))
         + p["d"] * torch.exp(-(lam - 0.5) ** 2 / (2 * s2))
         + 0.5 * p["w"] * (1.0 - torch.erf(p["r"] * (lam + p["m"])))
         + 0.5 * p["w"] * (1.0 + torch.erf(p["r"] * (lam - 1.0 - p["m"]))))
    return u


@dataclasses.dataclass
class Evaluation:
    e_lj: float
    e_coul: float
    e_kspace: float
    e_bonded: float
    e_site: float
    f_short: torch.Tensor     # (N, 3): pairs and bonded
    f_recip: torch.Tensor     # (N, 3): k-space
    f_lam: torch.Tensor       # (S,)
    du_elec: torch.Tensor     # (S,)
    e_metad: float            # the bias tables' part of e_site

    @property
    def e_pot(self):
        return (self.e_lj + self.e_coul + self.e_kspace + self.e_bonded
                + self.e_site)

    @property
    def scale(self):
        return (abs(self.e_lj) + abs(self.e_coul) + abs(self.e_kspace)
                + abs(self.e_bonded) + abs(self.e_site))


def evaluate(x, box, lam, pH, top, *, T, dG_ref, pme=None, metad=None,
             prec=Precision(), rows=1024):
    """Everything of one replica. x (N, 3) in atom order, box (3,), lam
    (S,), pH a float; ``pme`` a dict (alpha, mesh, p) or None; ``metad``
    (params, V, dV) or None."""
    dt = prec.dtype
    x = prec.r(x.to(dt))
    box = box.to(dt)
    lam = lam.to(torch.float64).detach().requires_grad_(True)
    dq = top.site_dq * top.site_mask
    q = top.q0.index_add(0, top.site_idx.reshape(-1),
                         (lam[:, None] * dq).reshape(-1))
    qd = prec.r(q.detach().to(dt))
    e_lj, e_c, gx, gq = real_space(x, qd, box, top, prec, rows)
    e_k = 0.0
    f_rec = torch.zeros_like(x)
    if pme is not None:
        xs = x.detach().requires_grad_(True)
        qs = qd.detach().requires_grad_(True)
        ek = pme_energy(xs, qs, box, pme["alpha"], pme["mesh"], pme["p"],
                        prec)
        g = torch.autograd.grad(ek, (xs, qs))
        f_rec = -g[0]
        gq = gq + g[1]
        e_k = float(ek.detach()) - QQR2E * len(top.tiled_waters) \
            * c.ewald_intra(pme["alpha"])
    xs = x.detach().to(torch.float64).requires_grad_(True)
    eb = bonded_energy(xs, box.to(torch.float64), top.bonded)
    gb = torch.autograd.grad(eb, xs)[0] if eb.requires_grad else \
        torch.zeros_like(xs)
    # dU_elec/dλ_s = Σ_i φ_i Δq_is, φ = ∂E/∂q
    du = torch.sum(gq.to(torch.float64)[top.site_idx] * dq, dim=-1)
    kT = c.BOLTZ * T
    u_site = (switching(lam) * (kT * LN10 * (top.pK - pH) - dG_ref)
              + bias_energy(lam))
    if metad is not None:
        from cph_bench.reference.metad import lookup
        mp, V, dV = metad
        v, dv = lookup(V, dV, lam.detach(), mp)
        e_meta = float(torch.sum(v))
    else:
        dv = torch.zeros_like(lam)
        e_meta = 0.0
    g_site = torch.autograd.grad(torch.sum(u_site), lam)[0]
    f_lam = -(du + g_site) - dv
    return Evaluation(
        e_lj=e_lj, e_coul=e_c, e_kspace=e_k, e_bonded=float(eb.detach()),
        e_site=float(torch.sum(u_site).detach()) + e_meta,
        f_short=(-gx.to(torch.float64) - gb), f_recip=f_rec.to(torch.float64),
        f_lam=f_lam.detach(), du_elec=du.detach(), e_metad=e_meta)
