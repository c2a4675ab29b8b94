"""Real-space pair interactions, LJ + Coulomb, over padded neighbour lists
(port of constant_ph_tpu/ops/pair.py).

Full (double-counted) lists: every atom reduces over its own (K,) row, so
forces are row sums with no scatter, and pair energies are halved per
atom (the eatom half-share convention). φ_i = ∂U_elec/∂q_i comes out of
the same pass, so dU/dλ = Σ φ·dq/dλ is exact. One Coulomb formula covers
cut, Ewald real space and DSF (ops/kernels.coul_kernel).

This is the reference engine's semantic oracle; the hot path is the
tiled cell stencil (tiled/forces.py).
"""
from __future__ import annotations

import dataclasses

import torch

from constant_ph_tpu_torch import units
from constant_ph_tpu_torch.forcefield import PairParams
from constant_ph_tpu_torch.neighbors import NeighborList
from constant_ph_tpu_torch.ops.kernels import R2_MIN, coul_kernel
from constant_ph_tpu_torch.state import min_image


@dataclasses.dataclass
class PairResult:
    force: torch.Tensor    # (N, 3) kcal/mol/Å
    eatom: torch.Tensor    # (N,) per-atom energy half-shares
    phi: torch.Tensor      # (N,) ∂U_elec/∂q_i, kcal/mol/e
    e_lj: torch.Tensor     # () total LJ energy
    e_coul: torch.Tensor   # () total real-space Coulomb energy
    virial: torch.Tensor   # () scalar virial Σ r·f


def pair_forces(x, q, types, box, nbr: NeighborList,
                pp: PairParams) -> PairResult:
    n = x.shape[0]
    j = nbr.idx                                   # (N, K)
    jc = torch.clamp(j, max=n - 1)
    valid = j < n

    # one (N,) → (N, K) gather per coordinate, never an (N, K, 3) array
    dx = []
    r2 = None
    for d in range(3):
        xd = x[:, d]
        dxd = min_image(xd[:, None] - xd[jc], box[d])          # j → i
        dx.append(dxd)
        r2 = dxd * dxd if r2 is None else r2 + dxd * dxd
    # padding pairs go outside every cutoff, so nothing divides by ~0
    far = max(pp.cutoff, pp.coul_cutoff) ** 2 + 1.0
    r2 = torch.where(valid, torch.clamp(r2, min=R2_MIN), far)
    r = torch.sqrt(r2)
    inv_r2 = 1.0 / r2

    ti = types[:, None]
    tj = types[jc]
    c12 = pp.c12[ti, tj]
    c6 = pp.c6[ti, tj]
    eshift = pp.e_shift[ti, tj]
    slj = pp.special_lj[nbr.code]
    scoul = pp.special_coul[nbr.code]

    in_lj = (r2 < pp.cutoff * pp.cutoff).to(x.dtype)
    inv_r6 = inv_r2 * inv_r2 * inv_r2
    wlj = in_lj * slj
    e_lj_pair = ((c12 * inv_r6 - c6) * inv_r6 - eshift) * wlj
    f_lj = (12.0 * c12 * inv_r6 - 6.0 * c6) * inv_r6 * inv_r2 * wlj

    qj = q[jc]
    in_c = (r2 < pp.coul_cutoff * pp.coul_cutoff).to(x.dtype)
    u_r, w_r = coul_kernel(r2, r, inv_r2, scoul, alpha=pp.alpha,
                           style=pp.coul_style, rc=pp.coul_cutoff)
    kqq = units.QQR2E * q[:, None] * qj
    e_c_pair = kqq * u_r * in_c
    f_c = kqq * w_r * in_c
    # φ from the same kernel, so Σᵢ qᵢφᵢ = 2·E_coul exactly
    phi_pair = units.QQR2E * qj * u_r * in_c

    fpair = f_lj + f_c                            # force/r along dx
    force = torch.stack([torch.sum(fpair * dx[d], dim=1) for d in range(3)],
                        dim=-1)
    return PairResult(
        force=force,
        eatom=0.5 * torch.sum(e_lj_pair + e_c_pair, dim=1),
        phi=torch.sum(phi_pair, dim=1),
        e_lj=0.5 * torch.sum(e_lj_pair),
        e_coul=0.5 * torch.sum(e_c_pair),
        virial=0.5 * torch.sum(fpair * r2),
    )


def pair_energy(x, q, types, box, nbr, pp: PairParams):
    """Total pair energy only."""
    res = pair_forces(x, q, types, box, nbr, pp)
    return res.e_lj + res.e_coul
