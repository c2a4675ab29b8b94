"""Force-field parameters as dataclasses of tensors (port of
constant_ph_tpu/forcefield.py). Exclusions come from the port's native
C++ builder (native/topology.cpp) where g++ is available, else from the
Python walk of the bond graph."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from constant_ph_tpu_torch import resolve_device


@dataclasses.dataclass
class PairParams:
    """LJ + Coulomb real-space parameters. ``alpha`` = 0 ⇒ plain cut
    Coulomb; 'dsf' is damped-shifted-force Coulomb."""

    c12: torch.Tensor        # (T, T) 4εσ¹² mixed table
    c6: torch.Tensor         # (T, T) 4εσ⁶ mixed table
    e_shift: torch.Tensor    # (T, T) LJ energy shift at the cutoff
    cutoff: float = 10.0
    coul_cutoff: float = 10.0
    alpha: float = 0.0
    coul_style: str = "cut"
    # special-bonds scale factors by neighbour code 0..3
    # (0 = normal, 1 = 1-2, 2 = 1-3, 3 = 1-4)
    special_lj: torch.Tensor = None
    special_coul: torch.Tensor = None


def make_pair_params(epsilon, sigma, cutoff: float, *,
                     coul_cutoff: float | None = None, alpha: float = 0.0,
                     coul_style: str = "cut", shift: bool = True,
                     special_lj=(1.0, 0.0, 0.0, 0.0),
                     special_coul=(1.0, 0.0, 0.0, 0.0),
                     dtype=torch.float32, device="cuda") -> PairParams:
    """Mixed LJ tables from per-type ε, σ (Lorentz–Berthelot), built in
    float64 on the host and cast once."""
    dev = resolve_device(device)
    eps = np.asarray(epsilon, dtype=np.float64)
    sig = np.asarray(sigma, dtype=np.float64)
    eps_ij = np.sqrt(eps[:, None] * eps[None, :])
    sig_ij = 0.5 * (sig[:, None] + sig[None, :])
    c12 = 4.0 * eps_ij * sig_ij**12
    c6 = 4.0 * eps_ij * sig_ij**6
    if shift:
        e_shift = c12 / cutoff**12 - c6 / cutoff**6
    else:
        e_shift = np.zeros_like(c12)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    return PairParams(
        c12=t(c12), c6=t(c6), e_shift=t(e_shift), cutoff=float(cutoff),
        coul_cutoff=float(coul_cutoff if coul_cutoff is not None else cutoff),
        alpha=float(alpha), coul_style=coul_style,
        special_lj=t(special_lj), special_coul=t(special_coul),
    )


@dataclasses.dataclass
class BondedParams:
    """Harmonic bonds/angles + CHARMM-style dihedrals/impropers; index
    arrays are int64, each term family has a 0/1 mask."""

    bond_idx: torch.Tensor      # (NB, 2)
    bond_k: torch.Tensor        # (NB,) E = k (r − r0)²
    bond_r0: torch.Tensor
    bond_mask: torch.Tensor
    angle_idx: torch.Tensor     # (NA, 3) i-j-k, j = vertex
    angle_k: torch.Tensor
    angle_t0: torch.Tensor
    angle_mask: torch.Tensor
    dihedral_idx: torch.Tensor  # (ND, 4)
    dihedral_k: torch.Tensor
    dihedral_n: torch.Tensor
    dihedral_d: torch.Tensor
    dihedral_mask: torch.Tensor
    improper_idx: torch.Tensor  # (NI, 4)
    improper_k: torch.Tensor
    improper_x0: torch.Tensor
    improper_mask: torch.Tensor


@dataclasses.dataclass
class ForceField:
    """Everything static about the interactions of one system."""

    mass: torch.Tensor       # (N,) g/mol
    q0: torch.Tensor         # (N,) all-protonated (λ=0) charges, e
    type: torch.Tensor       # (N,) int64 atom type
    pair: PairParams
    bonded: BondedParams
    excl_idx: np.ndarray     # (N, KE) int32 special partners, −1 padded
    excl_code: np.ndarray    # (N, KE) int32: 1 = 1-2, 2 = 1-3, 3 = 1-4

    @property
    def n_atoms(self) -> int:
        return self.mass.shape[0]


def build_exclusions(n_atoms: int, bonds, *, max_excl: int = 16):
    """1-2/1-3/1-4 special-pair tables (host numpy, int32) from the bond
    graph: the native builder (the JAX package's order: partners in the
    order its walk first reaches them, grouped by code) when g++ is on
    PATH, else the Python one (partners sorted by id within each code).
    The two hold the same (partner, code) set in every row. The path taken
    is recorded in ``build_exclusions.last_path`` ("native" or
    "python"). A bond naming an atom outside [0, n_atoms) raises (the C++
    builder would write out of bounds; Python would wrap a negative id)."""
    bonds = np.asarray(bonds, dtype=np.int64).reshape(-1, 2)
    if bonds.size and (bonds.min() < 0 or bonds.max() >= n_atoms):
        raise ValueError(f"bond atom index out of range [0, {n_atoms}): "
                         f"{int(bonds.min())}..{int(bonds.max())}")
    out = _build_exclusions_native(n_atoms, bonds, max_excl)
    build_exclusions.last_path = "native"
    if out is None:
        out = _build_exclusions_python(n_atoms, bonds, max_excl)
        build_exclusions.last_path = "python"
    return out


build_exclusions.last_path = None


def _build_exclusions_native(n_atoms: int, bonds, max_excl: int):
    """The C++ builder (None without g++)."""
    import ctypes

    from constant_ph_tpu_torch.native.build import load_library

    lib = load_library("topology")
    if lib is None:
        return None
    bonds = np.ascontiguousarray(np.asarray(bonds, dtype=np.int64)
                                 .reshape(-1, 2))
    excl_idx = np.full((n_atoms, max_excl), -1, dtype=np.int64)
    excl_code = np.zeros((n_atoms, max_excl), dtype=np.int64)
    lib.build_exclusions.restype = ctypes.c_int64
    ret = lib.build_exclusions(
        ctypes.c_int64(n_atoms), ctypes.c_int64(bonds.shape[0]),
        bonds.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(max_excl),
        excl_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        excl_code.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if ret != 0:
        raise ValueError(
            f"exclusion capacity {max_excl} exceeded (need {ret}); "
            "raise max_excl")
    return excl_idx.astype(np.int32), excl_code.astype(np.int32)


def _build_exclusions_python(n_atoms: int, bonds, max_excl: int):
    """The pure-Python builder (no toolchain; the tests' oracle)."""
    adj: list[set[int]] = [set() for _ in range(n_atoms)]
    for i, j in np.asarray(bonds, dtype=np.int64).reshape(-1, 2):
        adj[i].add(int(j))
        adj[j].add(int(i))
    excl_idx = np.full((n_atoms, max_excl), -1, dtype=np.int32)
    excl_code = np.zeros((n_atoms, max_excl), dtype=np.int32)
    overflow = 0
    for i in range(n_atoms):
        one2 = adj[i]
        one3 = set()
        for j in one2:
            one3 |= adj[j]
        one3 -= one2 | {i}
        one4 = set()
        for k in one3:
            one4 |= adj[k]
        one4 -= one2 | one3 | {i}
        entries = [(j, 1) for j in sorted(one2)]
        entries += [(j, 2) for j in sorted(one3)]
        entries += [(j, 3) for j in sorted(one4)]
        if len(entries) > max_excl:
            overflow = max(overflow, len(entries))
            entries = entries[:max_excl]
        for s, (j, code) in enumerate(entries):
            excl_idx[i, s] = j
            excl_code[i, s] = code
    if overflow:
        raise ValueError(
            f"exclusion capacity {max_excl} exceeded (need {overflow}); "
            "raise max_excl")
    return excl_idx, excl_code
