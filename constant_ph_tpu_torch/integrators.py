"""Kinetic energy, velocity initialisation, the Langevin O-step of the
reference engine and the Nosé–Hoover chain (port of
constant_ph_tpu/integrators.py). The tiled engine's O-step lives inline in
tiled/engine.py; both engines draw their noise through ``replica_randn``.
Random numbers come from the caller's torch.Generator, one a replica of a
batch."""
from __future__ import annotations

import math

import torch

from constant_ph_tpu_torch import units


def kinetic_energy(v, mass):
    """½ Σ m v² in kcal/mol (v in Å/fs, m in g/mol); v (…, N, 3) gives
    one energy a replica, (…)."""
    return 0.5 * units.MVV2E * torch.sum(mass * torch.sum(v * v, dim=-1),
                                         dim=-1)


def replica_randn(like, generators):
    """Standard normal noise shaped like the batch ``like``: replica r's
    slice drawn from generators[r], the numbers a run of that replica
    alone draws (one small launch a replica)."""
    noise = torch.empty_like(like)
    for r, gen in enumerate(generators):
        noise[r].normal_(generator=gen)
    return noise


def langevin_o_step(generators, v, mass, T, gamma, dt):
    """Ornstein–Uhlenbeck exact update v ← c1·v + c2·ξ (gamma in 1/fs) of
    a batch: v is (R, N, 3) with mass (N,), or (R, S) with mass (S,);
    replica r's ξ is drawn from ``generators[r]``."""
    c1 = math.exp(-gamma * dt)
    c2 = torch.sqrt((1.0 - c1 * c1) * units.BOLTZ * T / (mass * units.MVV2E))
    noise = replica_randn(v, generators)
    if v.ndim == 3:
        return c1 * v + c2[:, None] * noise
    return c1 * v + c2 * noise


def maxwell_boltzmann(generator: torch.Generator, mass, T,
                      zero_momentum=True):
    """Velocities (N, 3) from the Maxwell–Boltzmann distribution at T,
    drawn from ``generator`` (on mass's device, in mass's dtype)."""
    n = mass.shape[0]
    sigma = torch.sqrt(units.BOLTZ * T / (mass * units.MVV2E))[:, None]
    v = sigma * torch.randn((n, 3), generator=generator, dtype=mass.dtype,
                            device=mass.device)
    if zero_momentum:
        p = torch.sum(mass[:, None] * v, dim=0) / torch.sum(mass)
        v = v - p[None, :]
    return v


def _chain_masses(xi, ndof, kT, tau):
    # built on the device from scalars: item assignment of a Python float
    # into a CUDA tensor would synchronise
    first = torch.arange(xi.shape[-1], device=xi.device) == 0
    return torch.where(first, ndof * kT * tau * tau,
                       kT * tau * tau).to(xi.dtype)


def nhc_halfstep(xi, ke2, ndof, kT, tau, dt):
    """Advance an M-link Nosé–Hoover chain a half step; return
    (scale, xi'). xi: (M,) chain velocities (1/fs); ke2 = 2·KE of the
    coupled DOFs. Q1 = ndof·kT·τ², Qk = kT·τ². With leading replica axes,
    xi (…, M) and ke2 (…): one chain a replica, scale (…)."""
    M = xi.shape[-1]
    Q = _chain_masses(xi, ndof, kT, tau)
    dt2 = 0.5 * dt
    dt4 = 0.25 * dt

    def G(k, ke2_now, x):
        prev = ke2_now if k == 0 else Q[k - 1] * x[k - 1] ** 2
        target = ndof * kT if k == 0 else kT
        return (prev - target) / Q[k]

    def update(k, ke2_now, x):
        g = G(k, ke2_now, x)
        if k == M - 1:
            x[k] = x[k] + dt4 * g
        else:
            f = torch.exp(-dt4 * 0.5 * x[k + 1])
            x[k] = f * (f * x[k] + dt4 * g)

    xs = list(xi.unbind(-1))
    for k in range(M - 1, -1, -1):
        update(k, ke2, xs)
    scale = torch.exp(-dt2 * xs[0])
    ke2 = ke2 * scale * scale
    for k in range(M):
        update(k, ke2, xs)
    return scale, torch.stack(xs, dim=-1)


def nhc_energy(xi, ndof, kT, tau):
    """Thermostat kinetic contribution ½ Σ Q ξ² to the conserved
    quantity."""
    Q = _chain_masses(xi, ndof, kT, tau)
    return 0.5 * torch.sum(Q * xi * xi, dim=-1)
