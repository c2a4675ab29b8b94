"""Bonded interactions: harmonic bonds/angles, CHARMM dihedrals, impropers
(port of constant_ph_tpu/ops/bonded.py). Energies from min-image
displacements; forces = −∇E by torch.autograd; per-atom energies split
evenly among each term's atoms. Coordinates may carry leading replica axes
(x (…, N, 3), box (…, 3)); each replica's energy is its own."""
from __future__ import annotations

import math

import torch

from constant_ph_tpu_torch.forcefield import BondedParams
from constant_ph_tpu_torch.state import min_image


def _at(x, idx):
    """Atoms idx (K,) of x (…, N, 3) → (…, K, 3)."""
    return x[..., idx, :]


def _bond_energies(x, box, bp: BondedParams):
    dx = min_image(_at(x, bp.bond_idx[:, 0]) - _at(x, bp.bond_idx[:, 1]), box)
    r = torch.sqrt(torch.sum(dx * dx, dim=-1) + 1e-12)
    return bp.bond_k * (r - bp.bond_r0) ** 2 * bp.bond_mask


def _angle_energies(x, box, bp: BondedParams):
    xj = _at(x, bp.angle_idx[:, 1])   # vertex
    r1 = min_image(_at(x, bp.angle_idx[:, 0]) - xj, box)
    r2 = min_image(_at(x, bp.angle_idx[:, 2]) - xj, box)
    cross = torch.linalg.cross(r1, r2, dim=-1)
    sin_t = torch.sqrt(torch.sum(cross * cross, dim=-1) + 1e-12)
    cos_t = torch.sum(r1 * r2, dim=-1)
    theta = torch.atan2(sin_t, cos_t)
    return bp.angle_k * (theta - bp.angle_t0) ** 2 * bp.angle_mask


def _dihedral_angle(x, box, idx):
    """Proper dihedral φ about the j-k axis (standard atan2 form)."""
    xi, xj, xk, xl = (_at(x, idx[:, c]) for c in range(4))
    b1 = min_image(xj - xi, box)
    b2 = min_image(xk - xj, box)
    b3 = min_image(xl - xk, box)
    n1 = torch.linalg.cross(b1, b2, dim=-1)
    n2 = torch.linalg.cross(b2, b3, dim=-1)
    b2n = torch.sqrt(torch.sum(b2 * b2, dim=-1) + 1e-12)
    m1 = torch.linalg.cross(n1, b2 / b2n[..., None], dim=-1)
    return torch.atan2(torch.sum(m1 * n2, dim=-1), torch.sum(n1 * n2, dim=-1))


def _dihedral_energies(x, box, bp: BondedParams):
    phi = _dihedral_angle(x, box, bp.dihedral_idx)
    return (bp.dihedral_k * (1.0 + torch.cos(bp.dihedral_n * phi
                                              - bp.dihedral_d))
            * bp.dihedral_mask)


def _improper_energies(x, box, bp: BondedParams):
    d = _dihedral_angle(x, box, bp.improper_idx) - bp.improper_x0
    d = d - 2.0 * math.pi * torch.round(d / (2.0 * math.pi))
    return bp.improper_k * d * d * bp.improper_mask


_TERMS = (  # (energy fn, index field)
    (_bond_energies, "bond_idx"),
    (_angle_energies, "angle_idx"),
    (_dihedral_energies, "dihedral_idx"),
    (_improper_energies, "improper_idx"),
)


def bonded_forces(x, box, bp: BondedParams):
    """(E_total, F = −∇E, eatom) for all bonded terms; E_total per replica
    where x carries replica axes."""
    box = box[..., None, :]                 # against (…, K, 3) vectors
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        terms = [fn(xg, box, bp) for fn, _ in _TERMS]
        e_total = sum(torch.sum(e, dim=-1) for e in terms)
        # replicas are independent: the gradient of their sum is each
        # replica's own
        (grad,) = torch.autograd.grad(torch.sum(e_total), xg)
    eatom = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for e, (_, field) in zip(terms, _TERMS):
        idx = getattr(bp, field)
        e = e.detach() / idx.shape[1]
        for c in range(idx.shape[1]):
            eatom = eatom.index_add(-1, idx[:, c], e)
    return e_total.detach(), -grad, eatom
