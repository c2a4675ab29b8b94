"""λ-dynamics: the constant-pH physics module (port of
constant_ph_tpu/lambda_dyn.py; same formulas, same sign and derivative
corrections).

- switching f(λ) = sigmoid(slope·(λ − ½)) and df/dλ = slope·f·(1 − f)
- Donnini–Ullmann bias U(λ) and its analytic dU/dλ
- pH driving term f(λ)·[kT·ln10·(pK − pH) − ΔG_ref]
- charges q(λ) = q0 + Σ_s λ_s·dq_s (buffer atoms keep each site neutral)
- exact dU_elec/dλ = Σ_i φ_i·dq_i/dλ
- multi-site tables from single-site specs (``stack_sites``)
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from constant_ph_tpu_torch import resolve_device, units


@dataclasses.dataclass(frozen=True)
class BiasParams:
    """Donnini–Ullmann bias-potential constants (kcal/mol; λ
    dimensionless). ``switch_slope`` is the 50 of the switching sigmoid."""

    w: float = 200.0
    s: float = 0.3
    k: float = 2.533
    a: float = 0.034041
    b: float = 0.005238
    r: float = 16.458
    m: float = 0.1507
    d: float = 2.0
    # `h` is unused in U(λ); kept for config parity with the reference
    h: float = 4.0
    switch_slope: float = 50.0


def switching(lam, p: BiasParams):
    """f(λ) = 1/(1+exp(−slope·(λ−1/2))) and df/dλ = slope·f·(1−f)."""
    f = torch.sigmoid(p.switch_slope * (lam - 0.5))
    df = p.switch_slope * f * (1.0 - f)
    return f, df


def bias(lam, p: BiasParams):
    """Bias potential U(λ) and analytic dU/dλ (element-wise over sites):
    two Gaussian end-state wells, a central Gaussian barrier, two erf
    outer walls."""
    a2 = p.a * p.a
    s2 = p.s * p.s
    sqrt_pi = math.sqrt(math.pi)

    x1 = lam - 1.0 - p.b
    x2 = lam + p.b
    x3 = lam - 0.5
    u1 = -p.k * torch.exp(-x1 * x1 / (2.0 * a2))
    u2 = -p.k * torch.exp(-x2 * x2 / (2.0 * a2))
    u3 = p.d * torch.exp(-x3 * x3 / (2.0 * s2))
    u4 = 0.5 * p.w * (1.0 - torch.erf(p.r * (lam + p.m)))
    u5 = 0.5 * p.w * (1.0 + torch.erf(p.r * (lam - 1.0 - p.m)))

    du1 = -(x1 / a2) * u1
    du2 = -(x2 / a2) * u2
    du3 = -(x3 / s2) * u3
    du4 = -0.5 * p.w * p.r * (2.0 / sqrt_pi) * torch.exp(
        -(p.r * (lam + p.m)) ** 2)
    du5 = 0.5 * p.w * p.r * (2.0 / sqrt_pi) * torch.exp(
        -(p.r * (lam - 1.0 - p.m)) ** 2)

    return u1 + u2 + u3 + u4 + u5, du1 + du2 + du3 + du4 + du5


@dataclasses.dataclass
class LambdaSpec:
    """Static description of the titratable sites. S = sites, P = padded
    atoms-per-site capacity; each site lists the atoms whose charge changes
    on deprotonation, including its charge-compensation buffer atoms."""

    pK: torch.Tensor          # (S,) site reference pKa
    dG_ref: torch.Tensor      # (S,) reference deprotonation ΔG (kcal/mol)
    m_lambda: torch.Tensor    # (S,) fictitious λ mass, (g/mol)·Å²
    atom_idx: torch.Tensor    # (S, P) int64 atom indices (pads → 0, mask 0)
    dq: torch.Tensor          # (S, P) q_B − q_A per listed atom (e)
    atom_mask: torch.Tensor   # (S, P) 1.0 for real entries

    @property
    def n_sites(self) -> int:
        return self.pK.shape[0]


def make_single_site(atom_idx, q_prot, q_deprot, pK: float, *,
                     buffer_idx=None, m_lambda: float = 20.0,
                     dG_ref: float = 0.0, dtype=torch.float32,
                     device="cuda") -> LambdaSpec:
    """A one-site LambdaSpec. ``buffer_idx`` atoms share −Σdq equally, so
    Σ_i dq_i = 0 over the site."""
    dev = resolve_device(device)
    atom_idx = np.asarray(atom_idx, dtype=np.int64)
    dq = np.asarray(q_deprot, dtype=np.float64) - np.asarray(q_prot, np.float64)
    if buffer_idx is not None:
        buffer_idx = np.asarray(buffer_idx, dtype=np.int64)
        comp = -dq.sum() / buffer_idx.shape[0]
        atom_idx = np.concatenate([atom_idx, buffer_idx])
        dq = np.concatenate([dq, np.full(buffer_idx.shape[0], comp)])
    P = atom_idx.shape[0]

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    return LambdaSpec(
        pK=t([pK]), dG_ref=t([dG_ref]), m_lambda=t([m_lambda]),
        atom_idx=torch.as_tensor(atom_idx, device=dev).reshape(1, P),
        dq=torch.as_tensor(dq, dtype=dtype, device=dev).reshape(1, P),
        atom_mask=torch.ones((1, P), dtype=dtype, device=dev),
    )


def stack_sites(specs: list) -> LambdaSpec:
    """Stack single-site specs into one multi-site table (pads P to the
    largest; pad entries get atom 0 and mask 0)."""
    P = max(int(s.atom_idx.shape[1]) for s in specs)

    def pad(name):
        return torch.cat([torch.nn.functional.pad(
            getattr(s, name), (0, P - int(s.atom_idx.shape[1])))
            for s in specs])

    return LambdaSpec(
        pK=torch.cat([s.pK for s in specs]),
        dG_ref=torch.cat([s.dG_ref for s in specs]),
        m_lambda=torch.cat([s.m_lambda for s in specs]),
        atom_idx=pad("atom_idx"), dq=pad("dq"), atom_mask=pad("atom_mask"))


def charges(q0, spec: LambdaSpec, lam):
    """q(λ) = q0 + Σ_s λ_s·dq_s (q0 is the all-protonated charge vector)."""
    contrib = (lam[:, None] * spec.dq * spec.atom_mask).reshape(-1)
    return q0.index_add(0, spec.atom_idx.reshape(-1), contrib.to(q0.dtype))


def dq_dlambda_dot(spec: LambdaSpec, phi):
    """Exact electrostatic dU/dλ_s = Σ_i φ_i·dq_i/dλ_s per site (φ is
    ∂U_elec/∂q_i)."""
    return torch.sum(phi[spec.atom_idx] * spec.dq * spec.atom_mask, dim=-1)


def ph_energy(lam, spec: LambdaSpec, pH, T: float, p: BiasParams):
    """pH driving free energy per site and its λ-derivative."""
    f, df = switching(lam, p)
    scale = units.BOLTZ * T * units.LN10 * (spec.pK - pH) - spec.dG_ref
    return f * scale, df * scale


def lambda_force(lam, dU_elec_dlam, spec: LambdaSpec, pH, T: float,
                 p: BiasParams):
    """F_λ = −∂H/∂λ per site, and the site potential energy."""
    U_ph, dU_ph = ph_energy(lam, spec, pH, T, p)
    U_bias, dU_bias = bias(lam, p)
    return -(dU_elec_dlam + dU_ph + dU_bias), U_ph + U_bias


def analytic_lambda_force(lam, spec: LambdaSpec, pH, T: float,
                          p: BiasParams):
    """The closed-form (stiff) part of F_λ: −(dU_pH + dU_bias). The λ-RESPA
    inner loop sub-steps λ against it (tiled/engine.py _lam_drift)."""
    _, dU_ph = ph_energy(lam, spec, pH, T, p)
    _, dU_bias = bias(lam, p)
    return -(dU_ph + dU_bias)


def lambda_kinetic(v_lambda, spec: LambdaSpec):
    """Σ ½ m_λ v_λ² in kcal/mol (v_λ in 1/fs, m_λ in (g/mol)·Å²)."""
    return 0.5 * units.MVV2E * torch.sum(spec.m_lambda * v_lambda * v_lambda)


def lambda_temperature(v_lambda, spec: LambdaSpec):
    """Instantaneous λ temperature."""
    ke = lambda_kinetic(v_lambda, spec)
    return 2.0 * ke / (spec.n_sites * units.BOLTZ)
