"""NPT through a Monte-Carlo barostat on the tiled engine (port of
constant_ph_tpu/tiled/npt.py).

Isotropic MC volume moves between MD chunks, the hybrid MD/MC-barostat
scheme. Rigid molecules, so molecular scaling:
  - propose V' = V·e^δ, δ ~ U(−Δ, Δ) (ln-V random walk);
  - scale MOLECULE centres of mass by s = (V'/V)^{1/3}: rigid-water
    geometry is kept exactly, buffer waters in the solute set scale as
    their own molecules, the rest of the solute as one molecule;
  - accept with min(1, exp(−β[ΔU + P·ΔV] + (N_mol + 1)·ln(V'/V))), the +1
    the ln-V proposal Jacobian, N_mol the rigid bodies;
  - U is the full tiled potential at the scaled configuration (the cell
    tiles stay valid: atoms move ≤ (s−1)·cell relative to their equally
    scaled cells).

A move costs two force evaluations (K1 twice on the card). Its two
uniforms come from a torch.Generator or are passed in as ``u`` (the parity
tests feed the JAX move's own draws); accept or reject is a torch.where
on the device. k-space composes only as PME with cfg.kspace_live_box=True
(the influence function follows the state box, ops/pme.py); baked-box
reciprocal parameters are refused.

On an engine on x-slabs (TiledEngine(spatial=group)) a state is the
rank's slab: each rank scales its own molecules, the molecule count is
summed over the ranks, and the energies come summed from compute_forces.
The move's two uniforms and the decision's inputs (the two energies and
the molecule count) are rank 0's on every rank, broadcast, so every rank
takes the same decision and keeps the same box by construction.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from constant_ph_tpu_torch import units
from constant_ph_tpu_torch.lambda_dyn import BiasParams
from constant_ph_tpu_torch.parallel import comm
from constant_ph_tpu_torch.tiled.elastic import _run_elastic
from constant_ph_tpu_torch.tiled.engine import TiledEngine
from constant_ph_tpu_torch.tiled.layout import TiledState


def _solute_groups(ts):
    """(Ns, n_groups) one-hot molecule matrix for the solute set: group 0
    is the (single-molecule) solute; each rigid buffer-water triple is its
    own group. Padding slots get weight 0 via smask at use time."""
    Ns = int(ts.solute.q0.shape[0])
    gid = np.zeros(Ns, dtype=np.int64)
    n_g = 1
    if ts.solute_constraints is not None:
        trips = ts.solute_constraints.triplets.cpu().numpy()
        for m, t in enumerate(trips):
            gid[t] = m + 1
        n_g = 1 + trips.shape[0]
    onehot = np.zeros((Ns, n_g), dtype=np.float32)
    onehot[np.arange(Ns), gid] = 1.0
    return onehot, n_g


def _check_npt_kspace(eng: TiledEngine) -> None:
    """Volume moves need box-consistent reciprocal energies: PME with
    cfg.kspace_live_box derives the influence function, spacing and volume
    from the state box (ops/pme.py), so U(s·x, s·box) is exact. Baked-box
    k-space params would evaluate the scaled configuration with a stale
    influence function — refuse."""
    if eng.kspace_ep is None:
        return
    if not eng.cfg.kspace_live_box:
        raise NotImplementedError(
            "NPT with k-space needs cfg.kspace_live_box=True (PME params "
            "re-derive the influence function from the live box); baked-box "
            "reciprocal params would be evaluated stale after volume moves")


class _Scaler:
    """Molecular centre-of-mass scaling of a tiled state (a slab's own
    molecules on x-slabs), and the molecule count of the ideal-gas term
    (summed over the slabs)."""

    def __init__(self, eng: TiledEngine):
        self.eng = eng
        ts = eng.ts
        dev = ts.device
        self.W = ts.params.W
        self.mass_pat = torch.as_tensor(
            np.asarray(ts.water.mass_pattern, np.float32), device=dev)
        self.m_tot_w = float(np.sum(ts.water.mass_pattern))
        onehot, n_g = _solute_groups(ts)
        # group COM weights: mass * smask (padding excluded)
        m_s = (ts.solute.mass * ts.solute.smask).cpu().numpy()
        m_g = np.maximum(onehot.T @ m_s, 1e-30)                # (n_g,)
        self.onehot = torch.as_tensor(onehot, device=dev)
        self.w_com = torch.as_tensor((m_s[:, None] * onehot) / m_g[None, :],
                                     dtype=torch.float32, device=dev)
        n_mol_solute = 1 if float(ts.solute.smask.sum()) else 0
        self.n_mol_static = float(n_g - 1 + n_mol_solute)

    def __call__(self, tst: TiledState, s) -> TiledState:
        G = tst.wx.shape[1]
        wx_m = tst.wx.reshape(3, G, self.W, 3)
        com = torch.einsum("dgwa,a->dgw", wx_m, self.mass_pat) / self.m_tot_w
        wx_new = (wx_m + (s - 1.0) * com[..., None]).reshape(tst.wx.shape)
        com_g = torch.einsum("ia,id->ad", self.w_com, tst.sx)  # (n_g, 3)
        sx_new = tst.sx + (s - 1.0) * (self.onehot @ com_g)
        return dataclasses.replace(tst, wx=wx_new, sx=sx_new,
                                   box=tst.box * s)

    def n_mol(self, tst: TiledState):
        return self.eng.slab_total(torch.sum(tst.wvalid)) + self.n_mol_static


def _from_rank0(eng: TiledEngine, *values):
    """The 0-d tensors ``values`` as rank 0 of the engine's slabs holds
    them, on every rank (one broadcast); themselves off slabs."""
    if eng.slab is None:
        return values
    return comm.broadcast(torch.stack(values), eng.slab.group).unbind()


def make_mc_barostat(eng: TiledEngine, *, pressure_atm: float, T: float,
                     max_dlnV: float = 2e-3):
    """An MC volume move: move(tst, generator=None, u=None) → (tst',
    accepted), ``accepted`` a 0-d bool tensor on the device. The two
    uniforms (proposal, acceptance) come from ``u`` when given, else from
    ``generator`` (default: the engine's).

    ``max_dlnV`` is the half-width of the ln-V proposal; tune for ~40-60%
    acceptance (2e-3 ≈ ±0.07% in box length for liquid water boxes).
    On x-slabs every rank calls it on its slab and gets the same
    decision."""
    _check_npt_kspace(eng)
    scale = _Scaler(eng)
    kT = units.BOLTZ * T
    p_kcal = pressure_atm * units.ATM_A3_TO_KCAL    # kcal/mol per Å³

    def move(tst: TiledState, generator=None, u=None):
        dev, dtype = tst.box.device, tst.box.dtype
        if u is None:
            gen = eng.generator if generator is None else generator
            u = torch.rand((2,), generator=gen, dtype=dtype, device=dev)
        u_prop, u_acc = _from_rank0(
            eng, *(torch.as_tensor(v, dtype=dtype, device=dev) for v in u))
        v0 = tst.box[0] * tst.box[1] * tst.box[2]
        dln = max_dlnV * (2.0 * u_prop - 1.0)
        s = torch.exp(dln / 3.0)
        tst_new = scale(tst, s)
        u0, u1, n_mol = _from_rank0(
            eng, eng.compute_forces(tst).e_pot,
            eng.compute_forces(tst_new).e_pot, scale.n_mol(tst))
        dH = ((u1 - u0) + p_kcal * v0 * (torch.exp(dln) - 1.0)
              - (n_mol + 1.0) * kT * dln)
        accept = u_acc < torch.exp(torch.clamp(-dH / kT, max=0.0))
        out = dataclasses.replace(tst, **{
            f.name: torch.where(accept, getattr(tst_new, f.name),
                                getattr(tst, f.name))
            for f in dataclasses.fields(tst)
            if isinstance(getattr(tst, f.name), torch.Tensor)})
        return out, accept

    return move


def make_pressure_fn(eng: TiledEngine, *, T: float, dlnV: float = 2e-4):
    """Instantaneous MOLECULAR pressure (atm) of a tiled state: P =
    N_mol·kT/V − ∂U/∂V at fixed molecular fractional coordinates, ∂U/∂V by
    central difference of the COM-scaled energy the MC barostat uses
    (rigid bodies ⇒ molecular virial). Two force evaluations — a
    diagnostic, not a hot-path term. On x-slabs every rank calls it on
    its slab."""
    _check_npt_kspace(eng)
    scale = _Scaler(eng)
    kT = units.BOLTZ * T

    def pressure(tst: TiledState):
        v = tst.box[0] * tst.box[1] * tst.box[2]
        dl = torch.tensor(dlnV, dtype=tst.box.dtype, device=tst.box.device)
        s_hi = torch.exp(dl / 3.0)
        s_lo = torch.exp(-dl / 3.0)
        dv = v * (torch.exp(dl) - torch.exp(-dl))      # V_hi - V_lo
        du_dv = (eng.compute_forces(scale(tst, s_hi)).e_pot
                 - eng.compute_forces(scale(tst, s_lo)).e_pot) / dv
        p_kcal_a3 = scale.n_mol(tst) * kT / v - du_dv   # kcal/mol per Å³
        return p_kcal_a3 / units.ATM_A3_TO_KCAL         # atm

    return pressure


def npt_elastic_run(ts, tst, cfg, n_steps: int, *, pressure_atm: float,
                    chunk: int = 2000, bias=None, kspace_ep=None,
                    margin_min: int = 6, max_dlnV: float = 2e-3,
                    seed: int = 0, max_box_drift: float = 0.04,
                    on_chunk=None, generator=None, check_sync=False,
                    spatial=None):
    """The elastic production loop (tiled/elastic.py) with one MC volume
    move after each chunk; the move is rebuilt only on a capacity retile.
    The run's noise comes from ``generator`` (as in elastic_run), the
    moves' uniforms from a generator seeded with ``seed``.

    Returns (ts, tst, obs, info, npt_stats); npt_stats holds the moves
    proposed and accepted and the volume after each. The cell grid is
    fixed at build, so the box may drift at most ``max_box_drift``
    (relative, per dimension) from its start; beyond that the run stops
    with an error (re-split the system to continue). With ``spatial``
    (a process group) the run is on x-slabs, as elastic_run's."""
    chunk = -(-chunk // cfg.rebuild_every) * cfg.rebuild_every
    box0 = tst.box.double().cpu().numpy()
    mc_gen = torch.Generator(device=ts.device).manual_seed(seed)
    stats = {"proposed": 0, "accepted": 0, "volume": []}
    moves = {}

    def make_engine(ts_):
        return TiledEngine(ts_, cfg, bias=bias or BiasParams(),
                           kspace_ep=kspace_ep, spatial=spatial)

    def boundary(eng, tst_):
        if eng not in moves:
            moves.clear()
            moves[eng] = make_mc_barostat(eng, pressure_atm=pressure_atm,
                                          T=cfg.T, max_dlnV=max_dlnV)
        tst_, acc = moves[eng](tst_, mc_gen)
        stats["proposed"] += 1
        stats["accepted"] += int(bool(acc))
        box = tst_.box.double().cpu().numpy()
        stats["volume"].append(float(np.prod(box)))
        if np.any(np.abs(box / box0 - 1.0) > max_box_drift):
            raise RuntimeError(
                f"NPT box drifted beyond ±{max_box_drift:.0%} of the build "
                f"box ({box} vs {box0}); re-split the system at the new "
                "density to continue")
        return tst_

    ts, tst, obs, info = _run_elastic(ts, tst, cfg, n_steps, chunk,
                                      make_engine, margin_min, generator,
                                      on_chunk, check_sync, boundary)
    return ts, tst, obs, info, stats
