"""Energy minimisation (FIRE) on the reference engine (port of
constant_ph_tpu/minimize.py).

The builders place solvent on a jittered lattice with incidental clashes,
so a FIRE relaxation is the usual preamble to dynamics. λ is held fixed.
The tiled engine has its own (TiledEngine.make_minimize).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from constant_ph_tpu_torch import units


def fire_minimize(engine, state, n_steps: int = 200, *,
                  dt_start: float = 0.5, dt_max: float = 2.0,
                  f_inc: float = 1.1, f_dec: float = 0.5,
                  alpha_start: float = 0.1, f_alpha: float = 0.99,
                  n_min: int = 5, max_move: float = 0.1):
    """FIRE minimisation of the atom positions. Displacements are capped
    at ``max_move`` Å a step, and the list is rebuilt at the start of
    every block of min(rebuild_every, ⌊(skin/2) / max_move⌋) steps
    (n_steps rounded up to whole blocks), so no atom moves more than
    skin/2 on one list. With constraints, FIRE works with the force
    tangent to them (the mass-weighted projection RATTLE applies to
    velocities), and every move is projected back onto them.

    Two departures from the JAX package, whose FIRE (a) runs blocks of
    rebuild_every steps, so at skin 0.8 Å and rebuild_every 10 atoms move
    up to 1 Å on one list and pairs go missing, and (b) takes the raw
    force: on rigid water with Ewald real space the excluded-pair erf
    forces along the bonds keep the power f·v positive, so FIRE never
    sees an uphill step and the energy climbs (a 1,537-atom box relaxed
    to −5,086 kcal/mol climbs back to −2,058 in 100 steps; with the
    tangent force it falls to −6,389). Without constraints, and with
    blocks that fit the skin, the two are the same algorithm.

    Returns (state with the relaxed positions, (n_blocks,) energy at each
    block's last step); velocities are the input state's. Nothing is read
    back to the host."""
    reach = math.floor(0.5 * engine.nbr_params.skin / max_move + 1e-9)
    block = max(1, min(engine.cfg.rebuild_every, reach))
    n_blocks = -(-n_steps // block)
    inv_m = units.FTM2V / engine.ff.mass[:, None]
    lam, box, pH = state.lam, state.box, state.pH
    dtype, dev = state.x.dtype, state.x.device

    x = state.x
    v = torch.zeros_like(state.v)
    dt = torch.full((), dt_start, dtype=dtype, device=dev)
    alpha = torch.full((), alpha_start, dtype=dtype, device=dev)
    n_pos = torch.zeros((), dtype=torch.int32, device=dev)
    e_hist = []
    for _ in range(n_blocks):
        nbr = engine.build_neighbors(x, box)
        for _ in range(block):
            frc = engine.compute_forces(x, lam, box, pH, nbr)
            f = frc.f
            if engine.constraints is not None:
                # the force tangent to the constraints (mass-weighted
                # projection, as RATTLE projects velocities)
                f = engine.constraints.velocities(x, f * inv_m, box) / inv_m
            # velocity-Verlet kick with FIRE's velocity mixing
            v = v + dt * f * inv_m
            power = torch.sum(f * v)
            f_norm = torch.sqrt(torch.sum(f * f) + 1e-20)
            v_norm = torch.sqrt(torch.sum(v * v) + 1e-20)
            v_mixed = (1.0 - alpha) * v + alpha * f * (v_norm / f_norm)
            uphill = power < 0.0
            v = torch.where(uphill, 0.0, v_mixed)
            n_pos = torch.where(uphill, 0, n_pos + 1)
            grow = (n_pos > n_min) & ~uphill
            dt = torch.where(grow, torch.clamp(dt * f_inc, max=dt_max),
                             torch.where(uphill, dt * f_dec, dt))
            alpha = torch.where(grow, alpha * f_alpha,
                                torch.where(uphill, alpha_start, alpha))
            dx = dt * v
            step_len = torch.sqrt(torch.sum(dx * dx, dim=-1, keepdim=True))
            dx = dx * torch.clamp(max_move / (step_len + 1e-12), max=1.0)
            x_new = x + dx
            # keep rigid molecules on the constraint manifold at every
            # move, or a constrained H (no LJ core) can dive into a
            # neighbour's Coulomb well
            if engine.constraints is not None:
                x_new, _ = engine.constraints.positions(
                    x, x_new, torch.zeros_like(v), box, 1.0)
            x = x_new
        e_hist.append(frc.e_pot)
    return dataclasses.replace(state, x=x), torch.stack(e_hist)
