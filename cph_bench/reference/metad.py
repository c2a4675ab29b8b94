"""Well-tempered λ-metadynamics bias tables, plain float64: the reference
recomputes every table the program carries from the hill centres (the λ
of each walker at each stride, as the program's observables record them)
in the order the mix merges them."""
from __future__ import annotations

import dataclasses

import torch

BOLTZ = 0.0019872067


@dataclasses.dataclass(frozen=True)
class Params:
    lo: float
    hi: float
    nbins: int
    sigma: float
    h0: float
    gamma: float
    T: float

    @property
    def dx(self):
        return (self.hi - self.lo) / (self.nbins - 1)

    def grid(self, device):
        return self.lo + self.dx * torch.arange(
            self.nbins, dtype=torch.float64, device=device)


def lookup(V, dV, lam, p):
    """Linear interpolation of V and dV/dλ per site (…, S); λ outside
    [lo, hi] takes the edge value of V and a zero slope."""
    u = (lam - p.lo) / p.dx
    i0 = torch.clamp(torch.floor(u).long(), 0, p.nbins - 2)
    f = torch.clamp(u - i0.to(lam.dtype), 0.0, 1.0)

    def take(A, i):
        return torch.gather(A, -1, i[..., None])[..., 0]

    v = take(V, i0) * (1 - f) + take(V, i0 + 1) * f
    dv = take(dV, i0) * (1 - f) + take(dV, i0 + 1) * f
    inside = (lam >= p.lo) & (lam <= p.hi)
    return v, torch.where(inside, dv, torch.zeros_like(dv))


def deposit(V, dV, lam, p):
    """One hill a site at λ (S,), its height damped by the table there."""
    v_at, _ = lookup(V, dV, lam, p)
    h = p.h0 * torch.exp(-v_at / ((p.gamma - 1.0) * BOLTZ * p.T))
    x = p.grid(V.device) - lam[:, None]
    g = torch.exp(-x * x / (2 * p.sigma * p.sigma))
    return V + h[:, None] * g, dV + h[:, None] * (-x / p.sigma**2) * g


def tables(hills, S, p, device):
    """Tables (S, nbins) after depositing ``hills`` (K, S) in order."""
    V = torch.zeros((S, p.nbins), dtype=torch.float64, device=device)
    dV = torch.zeros_like(V)
    for lam in hills:
        V, dV = deposit(V, dV, lam.to(torch.float64), p)
    return V, dV
