"""Carry another implementation's data into the port's types.

Every function takes plain numpy data — dicts of field name →
``np.ndarray`` (or a Python scalar / tuple for static fields), nested for
sub-objects — and returns the port's dataclasses on ``device``. The parity
tests flatten the JAX package's objects to such dicts, so both packages
compute on identical inputs; this module never sees a JAX type.

Field names are those of the port's dataclasses; unknown keys (a JAX
state's PRNG key) are ignored. A tiled state's host step counter is taken
from its ``step``, and its metadynamics tables (``metad_v``,
``metad_dv``) are carried, (0, 0) when metadynamics is off.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from constant_ph_tpu_torch import resolve_device
from constant_ph_tpu_torch.forcefield import (
    BondedParams,
    ForceField,
    PairParams,
)
from constant_ph_tpu_torch.lambda_dyn import LambdaSpec
from constant_ph_tpu_torch.neighbors import NeighborList, NeighborParams
from constant_ph_tpu_torch.ops.constraints import RigidTriatomic
from constant_ph_tpu_torch.ops.ewald import EwaldParams
from constant_ph_tpu_torch.ops.pme import PMEParams
from constant_ph_tpu_torch.state import SystemState
from constant_ph_tpu_torch.systems.base import System
from constant_ph_tpu_torch.tiled.layout import (
    SoluteTables,
    TiledState,
    TiledSystem,
    TileParams,
    WaterModel,
)

# fields that hold integers; everything else is float32
_INT64 = {"atom_idx", "bond_idx", "angle_idx", "dihedral_idx", "improper_idx"}
_INT32 = {"wid", "step"}


def _tensors(cls, d: dict, dev, **given):
    """cls from the arrays of ``d``; fields in ``given`` are passed as
    they are."""
    out = dict(given)
    for f in dataclasses.fields(cls):
        if f.name in given:
            continue
        a = np.array(d[f.name])          # a writable copy
        if f.name in _INT64:
            out[f.name] = torch.as_tensor(a.astype(np.int64), device=dev)
        elif f.name in _INT32:
            out[f.name] = torch.as_tensor(a.astype(np.int32), device=dev)
        else:
            out[f.name] = torch.as_tensor(a, dtype=torch.float32, device=dev)
    return cls(**out)


def lambda_spec(d: dict, device="cuda") -> LambdaSpec:
    return _tensors(LambdaSpec, d, resolve_device(device))


def bonded_params(d: dict, device="cuda") -> BondedParams:
    return _tensors(BondedParams, d, resolve_device(device))


# fields a JAX checkpoint may lack and that restart as scalar zeros
# (cumulative diagnostics appended after the format was set, not
# dynamics: constant_ph_tpu/checkpoint.py _SCALAR_FILL_FIELDS). Any other
# missing field is a layout mismatch and is refused.
_SCALAR_FILL_FIELDS = frozenset({"ext_work"})


def system_state(d: dict, device="cuda") -> SystemState:
    """SystemState from a JAX SystemState flattened to numpy (its ``key``
    dropped) or a checkpoint's leaves (checkpoint.load)."""
    d = dict(d)
    for f in dataclasses.fields(SystemState):
        if f.name in d or f.name == "step_host":
            continue
        if f.name not in _SCALAR_FILL_FIELDS:
            raise KeyError(
                f"missing non-optional field '{f.name}' — not a known "
                f"append-after-save scalar ({sorted(_SCALAR_FILL_FIELDS)}); "
                "refusing to silently zero-fill it")
        d[f.name] = np.zeros((), np.float32)
    return _tensors(SystemState, d, resolve_device(device),
                    step_host=int(d["step"]))


def tiled_state(d: dict, device="cuda") -> TiledState:
    return _tensors(TiledState, d, resolve_device(device),
                    step_host=int(d["step"]))


def neighbor_params(d: dict) -> NeighborParams:
    """NeighborParams from its static fields (host values only)."""
    return NeighborParams(
        cutoff=float(d["cutoff"]), skin=float(d["skin"]),
        capacity=int(d["capacity"]),
        grid=tuple(int(g) for g in d["grid"]),
        cell_capacity=int(d["cell_capacity"]),
        stencil=tuple(tuple(int(o) for o in off) for off in d["stencil"]),
        use_cells=bool(d["use_cells"]))


def neighbor_list(d: dict, device="cuda") -> NeighborList:
    """NeighborList from idx, code (int64 on the port's side), x_ref and
    overflow."""
    dev = resolve_device(device)
    return NeighborList(
        idx=torch.as_tensor(np.asarray(d["idx"], np.int64), device=dev),
        code=torch.as_tensor(np.asarray(d["code"], np.int64), device=dev),
        x_ref=torch.as_tensor(np.array(d["x_ref"]), dtype=torch.float32,
                              device=dev),
        overflow=torch.as_tensor(bool(d["overflow"]), device=dev))


def ewald_params(d: dict, device="cuda") -> EwaldParams:
    """EwaldParams from its static fields (alpha, nmax, volume) and its
    tables (kx, ky, kz, A float32; ky_idx, kz_idx int64)."""
    dev = resolve_device(device)

    def f(k):
        return torch.as_tensor(np.array(d[k]), dtype=torch.float32,
                               device=dev)

    def i(k):
        return torch.as_tensor(np.asarray(d[k], np.int64), device=dev)

    return EwaldParams(
        alpha=float(d["alpha"]), nmax=tuple(int(n) for n in d["nmax"]),
        kx=f("kx"), ky=f("ky"), kz=f("kz"), A=f("A"), ky_idx=i("ky_idx"),
        kz_idx=i("kz_idx"), volume=float(d["volume"]))


def pme_params(d: dict, device="cuda") -> PMEParams:
    """PMEParams from its static fields (alpha, grid, m, p, h, mesh,
    volume, spacing) and its arrays (Ahat, box, binv, nx, ny, nzr)."""
    dev = resolve_device(device)

    def ints(k):
        return tuple(int(v) for v in np.asarray(d[k]).reshape(-1))

    return PMEParams(
        alpha=float(d["alpha"]), grid=ints("grid"), m=ints("m"),
        p=int(d["p"]), h=ints("h"), mesh=ints("mesh"),
        volume=float(d["volume"]),
        spacing=tuple(float(v) for v in np.asarray(d["spacing"])),
        **{k: torch.as_tensor(np.array(d[k]), dtype=torch.float32,
                              device=dev)
           for k in ("Ahat", "box", "binv", "nx", "ny", "nzr")})


def pair_params(d: dict, device="cuda") -> PairParams:
    """PairParams from its tables (c12, c6, e_shift, special_lj,
    special_coul) and static fields (cutoff, coul_cutoff, alpha,
    coul_style)."""
    dev = resolve_device(device)

    def f(k):
        return torch.as_tensor(np.array(d[k]), dtype=torch.float32,
                               device=dev)

    return PairParams(
        c12=f("c12"), c6=f("c6"), e_shift=f("e_shift"),
        cutoff=float(d["cutoff"]), coul_cutoff=float(d["coul_cutoff"]),
        alpha=float(d["alpha"]), coul_style=str(d["coul_style"]),
        special_lj=f("special_lj"), special_coul=f("special_coul"))


def force_field(d: dict, device="cuda") -> ForceField:
    """ForceField from mass, q0, type, the "pair" and "bonded" sub-dicts
    and the exclusion tables (kept as host int32 arrays)."""
    dev = resolve_device(device)
    return ForceField(
        mass=torch.as_tensor(np.array(d["mass"]), dtype=torch.float32,
                             device=dev),
        q0=torch.as_tensor(np.array(d["q0"]), dtype=torch.float32,
                           device=dev),
        type=torch.as_tensor(np.asarray(d["type"], np.int64), device=dev),
        pair=pair_params(d["pair"], dev),
        bonded=bonded_params(d["bonded"], dev),
        excl_idx=np.asarray(d["excl_idx"], np.int32),
        excl_code=np.asarray(d["excl_code"], np.int32))


def system(d: dict, device="cuda") -> System:
    """A whole System from {"ff", "state", "nbr_params"} and the optional
    "bonded", "spec", "constraints" and "groupH_mask" (each may be None).
    "constraints" holds the rigid-water "triplets", the per-atom
    "masses", "d01" and "d12"."""
    dev = resolve_device(device)
    c = d.get("constraints")
    gh = d.get("groupH_mask")
    return System(
        ff=force_field(d["ff"], dev),
        state=system_state(d["state"], dev),
        nbr_params=neighbor_params(d["nbr_params"]),
        bonded=(None if d.get("bonded") is None
                else bonded_params(d["bonded"], dev)),
        constraints=None if c is None else RigidTriatomic(
            c["triplets"], np.asarray(c["masses"]), float(c["d01"]),
            float(c["d12"]), device=dev),
        spec=None if d.get("spec") is None else lambda_spec(d["spec"], dev),
        groupH_mask=(None if gh is None else
                     torch.as_tensor(np.array(gh, bool), device=dev)))


def tiled_system(d: dict, device="cuda") -> TiledSystem:
    """TiledSystem from {"params", "water", "solute", "spec", "bonded",
    "solute_constraints"} sub-dicts (spec, bonded and solute_constraints
    may be None) plus "groupH_mask", "water_atom_ids", "solute_ids",
    "n_atoms", "coul_style", "alpha", "cutoff". "solute_constraints" holds
    the rigid buffer-water "triplets" (solute-local), "masses", "d01" and
    "d12"."""
    dev = resolve_device(device)
    p = d["params"]
    params = TileParams(
        grid=tuple(int(g) for g in p["grid"]), W=int(p["W"]),
        half_stencil=tuple(tuple(int(o) for o in off)
                           for off in p["half_stencil"]),
        cutoff=float(p["cutoff"]), skin=float(p["skin"]))
    water = WaterModel(**{k: float(v) for k, v in d["water"].items()})
    sc = d["solute_constraints"]
    return TiledSystem(
        params=params, water=water,
        solute_tables=_tensors(SoluteTables, d["solute"], dev),
        spec=None if d["spec"] is None else lambda_spec(d["spec"], dev),
        bonded=None if d["bonded"] is None else bonded_params(d["bonded"],
                                                              dev),
        groupH_mask=torch.as_tensor(np.array(d["groupH_mask"], bool),
                                    device=dev),
        water_atom_ids=np.asarray(d["water_atom_ids"], np.int64),
        solute_ids=np.asarray(d["solute_ids"], np.int64),
        n_atoms=int(d["n_atoms"]),
        solute_constraints=None if sc is None else RigidTriatomic(
            sc["triplets"], np.asarray(sc["masses"]), float(sc["d01"]),
            float(sc["d12"]), device=dev),
        coul_style=str(d["coul_style"]), alpha=float(d["alpha"]),
        cutoff=float(d["cutoff"]), device=dev,
    )
