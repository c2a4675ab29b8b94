"""What decides ``correct``: the timed path's output against the plain
reference (cph_bench/reference/forces.py), replica by replica, at the
state the window ended in.

A driver hands over its judged state (``judged()``) in atom order, the
same for every engine, so that nothing here knows a layout:

- x, v (R, N, 3), box (R, 3), lam (R, S), pH (R,): the state after the
  window's last block;
- f (R, N, 3), f_lam (R, S): the program's force evaluation of that
  state (the function every step of the window calls), k-space in full;
- e_pot (R,): the energy the window's last step recorded, at the pH
  obs_pH (R,) it ran at (before a swap) and with k-space where
  e_has_kspace (R,) says so; against the bias tables it ran against;
- x1 (R, N, 3): the positions after one more step of the program from
  that state, whose k-space force entered × kspace_factor;
- step: dict(dt, gamma, T) of that step;
- metad: None, or dict(params, hills: every merge's hills (G, K, S) in
  order, walkers_per_ph, v (R, S, nbins) each replica's table).

The reference takes the positions and works out everything else itself:
the charges from λ, the forces, energies and λ forces, the bias tables
from the hills, the rigid geometry, and the next positions' centres of
mass. The program's side is read only to be judged.

Numbers, each held to the limit the configuration file gives it:

- force_gap: the widest |F_program − F_reference| over the atoms, over
  the reference's largest |F|, worst replica;
- energy_gap: |e_pot − E_reference| over the sum of the reference's
  |terms|, worst replica;
- lambda_force_gap: the widest |F_λ program − F_λ reference| over the
  sites, over the reference's largest |dU_elec/dλ| (at least 1), worst
  replica;
- table_gap (metadynamics): the widest gap of a walker's bias table to
  the reference's table of its rung, over the largest |V| there;
- constraint_gap: the widest departure, in Å, of a rigid water's O–H or
  H–H distance from the model's, over every water of every replica, at
  the window's last state and after the one more step;
- step_noise_dev: each rigid water's (and each free solute atom's)
  centre of mass moves in one BAOAB step by the deterministic part
  (dt/2)(1 + c1)(v + (dt/2) F/M), which the reference computes with its
  own forces, plus Langevin noise of known deviation
  (dt/2)·√((1 − c1²) kT/M); constraints move no centre of mass. The
  number is the worst replica's |rms(residual / deviation) − 1|: 0 up to
  sampling for a right step, about 1 for a step without noise and far
  above for a step that does not move.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from cph_bench.inputs import common as c
from cph_bench.reference import forces as rf
from cph_bench.reference import metad as rm

NAMES = ("force_gap", "energy_gap", "lambda_force_gap", "table_gap",
         "constraint_gap", "step_noise_dev")


def _constraint_gap(top, X):
    out = 0.0
    for trip in (top.tiled_waters, top.buffer_waters):
        if not len(trip):
            continue
        t = torch.as_tensor(trip, device=X.device)
        o, h1, h2 = X[t[:, 0]], X[t[:, 1]], X[t[:, 2]]
        for a, b, d0 in ((o, h1, c.R_OH), (o, h2, c.R_OH), (h1, h2, c.R_HH)):
            d = torch.linalg.norm(a - b, dim=-1)
            out = _worse(out, float(torch.max(torch.abs(d - d0))))
    return out


def _bodies(top):
    """Rigid waters (atom ids (M, 3)) and free solute atoms (ids (F,)):
    the bodies whose centres of mass the step check follows."""
    waters = np.concatenate([top.tiled_waters, top.buffer_waters])
    in_water = np.zeros(top.n_atoms, bool)
    in_water[waters.reshape(-1)] = True
    return waters, np.nonzero(~in_water)[0]


def _com_moves(top, X0, X1, V0, F, mass, step):
    """(residual / deviation) of every body's centre of mass, flat;
    ``step`` the step's dict(dt, gamma, T)."""
    dt, T = step["dt"], step["T"]
    c1 = math.exp(-step["gamma"] * dt)
    kT = c.BOLTZ * T
    waters, free = _bodies(top)
    zs = []
    for ids in (torch.as_tensor(waters, device=X0.device),
                torch.as_tensor(free, device=X0.device)[:, None]):
        if not ids.numel():
            continue
        m = mass[ids]                                         # (B, k)
        M = m.sum(-1, keepdim=True)

        def com(A):
            return (A[ids] * m[..., None]).sum(1) / M

        v_b = com(V0) + 0.5 * dt * F[ids].sum(1) / (M * c.MVV2E)
        det = com(X0) + 0.5 * dt * (1.0 + c1) * v_b
        dev = 0.5 * dt * torch.sqrt((1.0 - c1 * c1) * kT / (M * c.MVV2E))
        zs.append(((com(X1) - det) / dev).reshape(-1))
    return torch.cat(zs)


def _worse(a, b):
    """The larger of two readings; a NaN reads as inf, never as 0."""
    if math.isnan(a) or math.isnan(b):
        return math.inf
    return max(a, b)


def pme_of(config):
    """The reference's PME settings of a configuration, or None."""
    pc = config.get("pme")
    return pc and dict(alpha=pc["alpha"], mesh=pc["mesh"], p=pc["p"])


def metad_params(md):
    """The reference's bias parameters of a judged state's ``metad``."""
    return rm.Params(**md["params"])


def judge(ctx, J) -> list:
    """[(name, value, limit)] for the numbers this cell compares."""
    config = ctx.config
    limits = config["limits"]
    dev = ctx.device
    top = rf.topology(ctx.inputs, dev)
    X_all, R = J["x"], J["x"].shape[0]
    T = J["step"]["T"]
    pme = pme_of(config)
    md = J["metad"]
    if md is not None:
        mp = metad_params(md)
        hills = torch.cat(md["hills"], dim=1)                 # (G, K, S)
        ref_tables = [rm.tables(hills[g], hills.shape[-1], mp, dev)
                      for g in range(hills.shape[0])]
        # the tables the last block ran against: all but its own hills
        k_last = md["hills"][-1].shape[1]
        ref_before = [rm.tables(hills[g, :-k_last], hills.shape[-1], mp,
                                dev) for g in range(hills.shape[0])]

    out = dict.fromkeys(("force_gap", "energy_gap", "lambda_force_gap",
                         "constraint_gap"), 0.0)
    if md is not None:
        out["table_gap"] = 0.0
    evals = []
    for r in range(R):
        X, lam, pH = X_all[r], J["lam"][r], float(J["pH"][r])
        tab = None
        if md is not None:
            g = r // md["walkers_per_ph"]
            tab = (mp,) + ref_tables[g]
        ev = rf.evaluate(X, J["box"][r], lam, pH, top, T=T,
                         dG_ref=float(config["dG_ref"]), pme=pme,
                         metad=tab, rows=ctx.reference_rows)
        evals.append(ev)
        Fr = ev.f_short + ev.f_recip
        out["force_gap"] = _worse(out["force_gap"], float(
            torch.max(torch.abs(J["f"][r] - Fr)) / torch.max(torch.abs(Fr))))
        e_ref = ev.e_pot if bool(J["e_has_kspace"][r]) \
            else ev.e_pot - ev.e_kspace
        # the energy was recorded at the pH before a swap
        e_ref += float(torch.sum(rf.switching(lam)) * c.BOLTZ * T * rf.LN10
                       * (pH - float(J["obs_pH"][r])))
        if tab is not None:
            V0, dV0 = ref_before[g]
            e_ref += float(torch.sum(rm.lookup(V0, dV0, lam, mp)[0])) \
                - ev.e_metad
        out["energy_gap"] = _worse(out["energy_gap"], abs(
            float(J["e_pot"][r]) - e_ref) / ev.scale)
        scale = max(1.0, float(torch.max(torch.abs(ev.du_elec))))
        out["lambda_force_gap"] = _worse(out["lambda_force_gap"], float(
            torch.max(torch.abs(J["f_lam"][r] - ev.f_lam))) / scale)
        out["constraint_gap"] = _worse(
            out["constraint_gap"], _worse(_constraint_gap(top, X),
                                          _constraint_gap(top, J["x1"][r])))
        if tab is not None:
            out["table_gap"] = _worse(out["table_gap"], float(
                torch.max(torch.abs(md["v"][r] - tab[1]))
                / torch.max(torch.abs(tab[1])).clamp(min=1e-30)))

    k = J["kspace_factor"]
    dev_max = 0.0
    for r, ev in enumerate(evals):
        F = ev.f_short + k * ev.f_recip
        z = _com_moves(top, X_all[r], J["x1"][r], J["v"][r], F, top.mass,
                       J["step"])
        dev_max = _worse(dev_max, abs(float(torch.sqrt(torch.mean(z * z)))
                                      - 1.0))
    out["step_noise_dev"] = dev_max
    return [(name, float(out[name]), float(limits[name])) for name in NAMES
            if name in out]
