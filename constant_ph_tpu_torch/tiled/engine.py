"""TiledEngine: the hot-path engine on cell tiles (port of
constant_ph_tpu/tiled/engine.py, DSF slice).

Per step: tile pair blocks (the water-water block is the CUDA kernel on
the GPU), λ-dynamics with exact dU/dλ, BAOAB Langevin / velocity-Verlet /
NHC integration with the λ-RESPA inner drift, and tile SHAKE/RATTLE.
``make_minimize`` and ``make_run`` return functions that loop over
``rebuild_every``-step blocks in Python (the JAX package's lax.scan),
rebinning at each block start; they never read a device value on the
host, so the caller decides when to synchronise.

Not in this slice (each raises NotImplementedError naming the slice that
brings it): reciprocal space (``kspace_ep``), metadynamics, per-atom
tallies (``need_tally`` / compute_Hs) and grids below 3 cells per dim.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from constant_ph_tpu_torch import lambda_dyn, units
from constant_ph_tpu_torch.engine import EngineConfig, Observables
from constant_ph_tpu_torch.integrators import nhc_halfstep
from constant_ph_tpu_torch.lambda_dyn import BiasParams
from constant_ph_tpu_torch.ops.bonded import bonded_forces
from constant_ph_tpu_torch.tiled import forces as tforces
from constant_ph_tpu_torch.tiled.layout import (
    TiledState,
    TiledSystem,
    rebin,
)
from constant_ph_tpu_torch.tiled.shake import TiledWaterShake


@dataclasses.dataclass
class TiledForces:
    fw: torch.Tensor      # (3, G, 3W)
    fs: torch.Tensor      # (Ns, 3)
    f_lam: torch.Tensor   # (S,)
    e_lj: torch.Tensor
    e_coul: torch.Tensor
    e_bonded: torch.Tensor
    e_kspace: torch.Tensor
    e_site: torch.Tensor
    phi_s: torch.Tensor   # (Ns,) φ on solute atoms
    dUdlam: torch.Tensor  # (S,)

    @property
    def e_pot(self):
        return (self.e_lj + self.e_coul + self.e_bonded + self.e_kspace
                + self.e_site)


class TiledEngine:
    def __init__(self, tsys: TiledSystem, config: EngineConfig = EngineConfig(),
                 bias: BiasParams = BiasParams(), kspace_ep=None,
                 metad=None):
        if kspace_ep is not None:
            raise NotImplementedError(
                "reciprocal space (kspace_ep) comes with the PME slice")
        if metad is not None:
            raise NotImplementedError(
                "metadynamics comes with the campaign-path slice")
        if min(tsys.params.grid) < 3:
            raise NotImplementedError(
                "grids below 3 cells per dim need the tally path "
                "(water_water), which comes with the K2 slice")
        # SHAKE and the force sums need full float32 (no TF32 anywhere)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        self.ts = tsys
        self.cfg = config
        self.bias = bias
        self.device = tsys.device
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed)
        self.shake = TiledWaterShake(tsys.water)
        p = tsys.params
        self.W = p.W
        self.G = p.G
        self.wmass = torch.as_tensor(
            np.tile(tsys.water.mass_pattern, p.W), dtype=torch.float32,
            device=self.device)                                   # (3W,)
        self.n_waters = tsys.water_atom_ids.shape[0]
        self.ns_real = len(tsys.solute_ids)
        self.n_sites = 0 if tsys.spec is None else tsys.spec.n_sites
        n_buf_cons = (tsys.solute_constraints.n_constraints
                      if tsys.solute_constraints is not None else 0)
        self.ndof = (3 * (3 * self.n_waters + self.ns_real) - 3
                     - 3 * self.n_waters - n_buf_cons)

    # -- forces ---------------------------------------------------------------

    def charges_solute(self, lam):
        ts = self.ts
        if ts.spec is None:
            return ts.solute.q0
        return lambda_dyn.charges(ts.solute.q0, ts.spec, lam)

    def compute_forces(self, st: TiledState,
                       need_tally: bool = False) -> TiledForces:
        """Forces + energies on the hot path: water-water (kernel), water-
        solute and solute-solute blocks, bonded terms, and the λ force
        from φ on solute atoms."""
        if need_tally:
            raise NotImplementedError(
                "per-atom tallies (compute_Hs) come with the K2 slice")
        ts = self.ts
        p = ts.params
        gx, gy, gz = p.grid
        W = p.W
        box = st.box
        style, alpha, rc = ts.coul_style, ts.alpha, ts.cutoff

        wxg = st.wx.reshape(3, gx, gy, gz, 3 * W)
        e_lj_ww, e_c_ww, f_ww = tforces.water_water_fast(
            wxg, ts.water, p, box, style=style, alpha=alpha, rc=rc)
        qs = self.charges_solute(st.lam)
        e_lj_ws, e_c_ws, f_w_ws, f_s_ws, phi_s_ws = tforces.water_solute_fast(
            wxg, st.sx, qs, ts.solute, ts.water, p, box,
            style=style, alpha=alpha, rc=rc)
        e_lj_ss, e_c_ss, f_ss, _, phi_ss = tforces.solute_solute(
            st.sx, qs, ts.solute, box, style=style, alpha=alpha, rc=rc)

        fw = (f_ww + f_w_ws).reshape(3, self.G, 3 * W)
        fs = f_s_ws + f_ss
        phi_s = phi_s_ws + phi_ss

        zero = torch.zeros((), dtype=st.sx.dtype, device=st.sx.device)
        e_bonded = zero
        if ts.bonded is not None and int(ts.bonded.bond_idx.shape[0]):
            e_bonded, fb, _ = bonded_forces(st.sx, box, ts.bonded)
            fs = fs + fb

        if ts.spec is not None:
            dUdlam = lambda_dyn.dq_dlambda_dot(ts.spec, phi_s)
            f_lam, u_site = lambda_dyn.lambda_force(
                st.lam, dUdlam, ts.spec, st.pH, self.cfg.T, self.bias)
            e_site = torch.sum(u_site)
        else:
            dUdlam = f_lam = st.sx.new_zeros((0,))
            e_site = zero

        return TiledForces(
            fw=fw, fs=fs, f_lam=f_lam,
            e_lj=e_lj_ww + e_lj_ws + e_lj_ss,
            e_coul=e_c_ww + e_c_ws + e_c_ss,
            e_bonded=e_bonded, e_kspace=zero, e_site=e_site,
            phi_s=phi_s, dUdlam=dUdlam,
        )

    # -- diagnostics ------------------------------------------------------------

    def memory_usage(self) -> dict:
        """Byte accounting of the resident state and tables."""
        A = 3 * self.W
        f4 = 4
        tiles = 2 * 3 * self.G * A * f4            # wx + wv
        masks = self.G * self.W * (f4 + 4)          # wvalid + wid
        Ns = int(self.ts.solute.q0.shape[0])
        solute = 2 * Ns * 3 * f4 + 4 * Ns * Ns * f4  # sx/sv + pair tables
        return {"water_tiles": tiles, "cell_masks": masks,
                "solute": solute, "total": tiles + masks + solute}

    def _ke(self, wvalid, wv, sv):
        vm_atoms = torch.repeat_interleave(wvalid, 3, dim=-1)[None]
        ke_w = 0.5 * units.MVV2E * torch.sum(
            self.wmass[None, None, :] * wv * wv * vm_atoms)
        sol = self.ts.solute
        ke_s = 0.5 * units.MVV2E * torch.sum(
            sol.mass[:, None] * sv * sv * sol.smask[:, None])
        return ke_w + ke_s

    def kinetic_energy(self, st: TiledState):
        return self._ke(st.wvalid, st.wv, st.sv)

    def observe(self, st: TiledState, frc: TiledForces) -> Observables:
        ke = self.kinetic_energy(st)
        temp = 2.0 * ke / (self.ndof * units.BOLTZ)
        if self.ts.spec is not None:
            ke_lam = lambda_dyn.lambda_kinetic(st.v_lam, self.ts.spec)
            temp_lam = lambda_dyn.lambda_temperature(st.v_lam, self.ts.spec)
        else:
            ke_lam = temp_lam = torch.zeros_like(ke)
        return Observables(
            e_pot=frc.e_pot, e_lj=frc.e_lj, e_coul=frc.e_coul,
            e_bonded=frc.e_bonded, e_kspace=frc.e_kspace, e_site=frc.e_site,
            ke=ke, temp=temp, ke_lam=ke_lam, temp_lam=temp_lam,
            h_conserved=frc.e_pot + ke + ke_lam - st.ext_work,
            h_valid=torch.ones((), dtype=torch.bool, device=ke.device),
            ext_work=st.ext_work, lam=st.lam, v_lam=st.v_lam,
            dUdlam=frc.dUdlam,
        )

    # -- integration ------------------------------------------------------------

    def _lam_kick_scale(self, step, offset):
        nev = self.cfg.lambda_nevery
        if nev <= 1 or self.ts.spec is None:
            return 1.0
        active = ((step + offset) % nev) == 0
        return active.to(torch.float32) * float(nev)

    def _reflect_lam(self, lam, v_lam):
        # FOLDING reflection (period-2L sawtooth), not a single mirror: maps
        # ANY λ back into [lo, hi] with the velocity flipped on odd legs.
        # torch.remainder is floor-mod, as jnp.mod (torch.fmod is not)
        lo, hi = self.cfg.lam_min, self.cfg.lam_max
        rng = hi - lo
        y = torch.remainder(lam - lo, 2.0 * rng)
        odd = y > rng
        return (torch.where(odd, 2.0 * rng - y, y) + lo,
                torch.where(odd, -v_lam, v_lam))

    def _lam_drift(self, lam, v_lam, pH, h, inv_ml):
        """λ drift over h — λ-RESPA inner loop: lambda_inner // 2
        velocity-Verlet substeps against the analytic stiff force (bias
        wells + erf walls + pH term); lambda_inner == 1 is a plain drift."""
        m = self.cfg.lambda_inner // 2
        if m <= 0 or self.ts.spec is None:
            return lam + h * v_lam, v_lam
        hs = h / m
        spec, T, bias = self.ts.spec, self.cfg.T, self.bias
        for _ in range(m):
            f = lambda_dyn.analytic_lambda_force(lam, spec, pH, T, bias)
            v_lam = v_lam + (0.5 * hs) * f * inv_ml
            lam = lam + hs * v_lam
            f = lambda_dyn.analytic_lambda_force(lam, spec, pH, T, bias)
            v_lam = v_lam + (0.5 * hs) * f * inv_ml
        return lam, v_lam

    def _lam_slow_force(self, f_lam, lam, pH):
        """Outer-step λ force: total minus the analytic part the inner
        loop integrates."""
        if self.cfg.lambda_inner // 2 <= 0 or self.ts.spec is None:
            return f_lam
        return f_lam - lambda_dyn.analytic_lambda_force(
            lam, self.ts.spec, pH, self.cfg.T, self.bias)

    def _cap_forces(self, frc: TiledForces) -> TiledForces:
        cap = self.cfg.force_cap
        if cap <= 0.0:
            return frc
        wnorm = torch.sqrt(torch.sum(frc.fw * frc.fw, dim=0, keepdim=True)
                           + 1e-12)
        snorm = torch.sqrt(torch.sum(frc.fs * frc.fs, dim=-1, keepdim=True)
                           + 1e-12)
        return dataclasses.replace(
            frc, fw=frc.fw * torch.clamp(cap / wnorm, max=1.0),
            fs=frc.fs * torch.clamp(cap / snorm, max=1.0))

    def _randn(self, like):
        return torch.randn(like.shape, generator=self.generator,
                           dtype=like.dtype, device=like.device)

    def _project_solute(self, sx, sv, box):
        sc = self.ts.solute_constraints
        return sc.velocities(sx, sv, box) if sc is not None else sv

    def step(self, st: TiledState, frc: TiledForces):
        """One BAOAB (or velocity-Verlet / NHC) step; returns the new state
        and the forces at its positions."""
        cfg = self.cfg
        ts = self.ts
        dt = cfg.dt
        has_lam = ts.spec is not None
        move_lam = has_lam and not cfg.lambda_frozen
        frc = self._cap_forces(frc)

        vm_atoms = torch.repeat_interleave(st.wvalid, 3, dim=-1)[None]
        inv_mw = (units.FTM2V / self.wmass)[None, None, :]
        inv_ms = units.FTM2V / ts.solute.mass[:, None]
        inv_ml = units.FTM2V / ts.spec.m_lambda if has_lam else None

        wv, sv, v_lam = st.wv, st.sv, st.v_lam
        wx, sx, lam = st.wx, st.sx, st.lam
        use_nhc = cfg.thermostat == "nhc"
        nhc_xi, nhc_lam_xi = st.nhc_xi, st.nhc_lam_xi
        kT = units.BOLTZ * cfg.T
        # cumulative thermostat energy injection: h_conserved stays an
        # oracle in every mode
        ext_work = st.ext_work

        def ke_vel(wv_, sv_):
            return self._ke(st.wvalid, wv_, sv_)

        if use_nhc:
            ke2 = 2.0 * ke_vel(wv, sv)
            scale, nhc_xi = nhc_halfstep(nhc_xi, ke2, self.ndof, kT,
                                         cfg.tau, dt)
            wv = wv * scale
            sv = sv * scale
            ext_work = ext_work + 0.5 * ke2 * (scale * scale - 1.0)
        if move_lam and cfg.lambda_thermostat == "nhc":
            ke2l = 2.0 * lambda_dyn.lambda_kinetic(v_lam, ts.spec)
            scale_l, nhc_lam_xi = nhc_halfstep(
                nhc_lam_xi, ke2l, self.n_sites, kT, cfg.lambda_tau, dt)
            v_lam = v_lam * scale_l
            ext_work = ext_work + 0.5 * ke2l * (scale_l * scale_l - 1.0)

        # B
        wv = wv + (0.5 * dt) * frc.fw * inv_mw * vm_atoms
        sv = sv + (0.5 * dt) * frc.fs * inv_ms
        if move_lam:
            k1 = self._lam_kick_scale(st.step, 0)
            v_lam = v_lam + (0.5 * dt) * k1 * self._lam_slow_force(
                frc.f_lam, st.lam, st.pH) * inv_ml

        # A
        wx = wx + (0.5 * dt) * wv
        sx = sx + (0.5 * dt) * sv
        if move_lam:
            lam, v_lam = self._lam_drift(lam, v_lam, st.pH, 0.5 * dt, inv_ml)

        # O (Langevin OU). The heat is booked into ext_work on
        # CONSTRAINT-PROJECTED copies of the velocities: the raw ΔKE would
        # count constraint-violating components that RATTLE removes anyway
        if cfg.thermostat == "langevin":

            def ke_proj(wv_, sv_):
                return ke_vel(self.shake.velocities(wx, wv_, st.box,
                                                    st.wvalid),
                              self._project_solute(sx, sv_, st.box))

            ke_o0 = ke_proj(wv, sv)
            c1 = math.exp(-cfg.gamma * dt)
            sig_w = torch.sqrt((1.0 - c1 * c1) * kT
                               / (self.wmass * units.MVV2E))[None, None, :]
            wv = c1 * wv + sig_w * vm_atoms * self._randn(wv)
            sig_s = torch.sqrt((1.0 - c1 * c1) * kT
                               / (ts.solute.mass * units.MVV2E))[:, None]
            sv = c1 * sv + sig_s * ts.solute.smask[:, None] * self._randn(sv)
            ext_work = ext_work + ke_proj(wv, sv) - ke_o0
        if move_lam and cfg.lambda_thermostat == "langevin":
            kel_o0 = lambda_dyn.lambda_kinetic(v_lam, ts.spec)
            c1l = math.exp(-cfg.lambda_gamma * dt)
            sig_l = torch.sqrt((1.0 - c1l * c1l) * kT
                               / (ts.spec.m_lambda * units.MVV2E))
            v_lam = c1l * v_lam + sig_l * self._randn(v_lam)
            ext_work = (ext_work + lambda_dyn.lambda_kinetic(v_lam, ts.spec)
                        - kel_o0)

        # A
        wx = wx + (0.5 * dt) * wv
        sx = sx + (0.5 * dt) * sv
        if move_lam:
            lam, v_lam = self._lam_drift(lam, v_lam, st.pH, 0.5 * dt, inv_ml)
            lam, v_lam = self._reflect_lam(lam, v_lam)

        # SHAKE water (tiled) + buffer-water solute constraints
        wx, wv = self.shake.positions(st.wx, wx, wv, st.box, dt, st.wvalid)
        if ts.solute_constraints is not None:
            sx, sv = ts.solute_constraints.positions(st.sx, sx, sv, st.box,
                                                     dt)

        st_new = dataclasses.replace(st, wx=wx, sx=sx, lam=lam,
                                     step=st.step + 1)
        frc_new = self.compute_forces(st_new)
        frc_capped = self._cap_forces(frc_new)

        # B
        wv = wv + (0.5 * dt) * frc_capped.fw * inv_mw * vm_atoms
        sv = sv + (0.5 * dt) * frc_capped.fs * inv_ms
        if move_lam:
            k2 = self._lam_kick_scale(st.step, 1)
            v_lam = v_lam + (0.5 * dt) * k2 * self._lam_slow_force(
                frc_new.f_lam, lam, st.pH) * inv_ml

        if use_nhc:
            ke2 = 2.0 * ke_vel(wv, sv)
            scale, nhc_xi = nhc_halfstep(nhc_xi, ke2, self.ndof, kT,
                                         cfg.tau, dt)
            # book the thermostat's work on constraint-projected KE (the
            # projection is linear, so it commutes with the uniform scale)
            ke2_p = 2.0 * ke_vel(
                self.shake.velocities(wx, wv, st.box, st.wvalid),
                self._project_solute(sx, sv, st.box))
            wv = wv * scale
            sv = sv * scale
            ext_work = ext_work + 0.5 * ke2_p * (scale * scale - 1.0)
        if move_lam and cfg.lambda_thermostat == "nhc":
            ke2l = 2.0 * lambda_dyn.lambda_kinetic(v_lam, ts.spec)
            scale_l, nhc_lam_xi = nhc_halfstep(
                nhc_lam_xi, ke2l, self.n_sites, kT, cfg.lambda_tau, dt)
            v_lam = v_lam * scale_l
            ext_work = ext_work + 0.5 * ke2l * (scale_l * scale_l - 1.0)

        # RATTLE
        wv = self.shake.velocities(wx, wv, st.box, st.wvalid)
        sv = self._project_solute(sx, sv, st.box)

        return dataclasses.replace(
            st_new, wv=wv, sv=sv, v_lam=v_lam, nhc_xi=nhc_xi,
            nhc_lam_xi=nhc_lam_xi, ext_work=ext_work), frc_new

    # -- minimization (FIRE on tiles, constraints enforced every move) --------

    def make_minimize(self, n_steps: int, *, dt_start=0.3, dt_max=0.6,
                      f_inc=1.1, f_dec=0.5, alpha_start=0.1, f_alpha=0.99,
                      n_min=5, max_move=0.05):
        """FIRE relaxation of the tiled system (λ held fixed); rigid-water
        constraints are projected every move. Returns minimize(st) →
        (st with zero velocities, per-block final energies)."""
        block = self.cfg.rebuild_every
        n_blocks = -(-n_steps // block)
        inv_mw = (units.FTM2V / self.wmass)[None, None, :]
        inv_ms = units.FTM2V / self.ts.solute.mass[:, None]
        smask = self.ts.solute.smask[:, None]

        def fire_step(st, vw, vs, dtf, al, n_pos):
            frc = self.compute_forces(st)
            vm = torch.repeat_interleave(st.wvalid, 3, dim=-1)[None]
            fw = frc.fw * vm
            fs = frc.fs * smask
            vw = vw + dtf * fw * inv_mw
            vs = vs + dtf * fs * inv_ms
            power = torch.sum(fw * vw) + torch.sum(fs * vs)
            f_norm = torch.sqrt(torch.sum(fw * fw) + torch.sum(fs * fs)
                                + 1e-20)
            v_norm = torch.sqrt(torch.sum(vw * vw) + torch.sum(vs * vs)
                                + 1e-20)
            mix = v_norm / f_norm
            uphill = power < 0.0
            vw = torch.where(uphill, 0.0, (1.0 - al) * vw + al * fw * mix)
            vs = torch.where(uphill, 0.0, (1.0 - al) * vs + al * fs * mix)
            n_pos = torch.where(uphill, 0, n_pos + 1)
            grow = (n_pos > n_min) & ~uphill
            dtf = torch.where(grow, torch.clamp(dtf * f_inc, max=dt_max),
                              torch.where(uphill, dtf * f_dec, dtf))
            al = torch.where(grow, al * f_alpha,
                             torch.where(uphill, alpha_start, al))
            dxw = dtf * vw
            lw = torch.sqrt(torch.sum(dxw * dxw, dim=0, keepdim=True) + 1e-20)
            dxw = dxw * torch.clamp(max_move / lw, max=1.0)
            dxs = dtf * vs
            ls = torch.sqrt(torch.sum(dxs * dxs, dim=-1, keepdim=True)
                            + 1e-20)
            dxs = dxs * torch.clamp(max_move / ls, max=1.0)
            wx_new, _ = self.shake.positions(
                st.wx, st.wx + dxw * vm, torch.zeros_like(vw), st.box, 1.0,
                st.wvalid)
            sx_new = st.sx + dxs
            if self.ts.solute_constraints is not None:
                sx_new, _ = self.ts.solute_constraints.positions(
                    st.sx, sx_new, torch.zeros_like(vs), st.box, 1.0)
            st = dataclasses.replace(st, wx=wx_new, sx=sx_new)
            return st, vw, vs, dtf, al, n_pos, frc.e_pot

        def minimize(st: TiledState):
            dtype, dev = st.sx.dtype, st.sx.device
            dtf = torch.tensor(dt_start, dtype=dtype, device=dev)
            al = torch.tensor(alpha_start, dtype=dtype, device=dev)
            n_pos = torch.zeros((), dtype=torch.int32, device=dev)
            e_hist = []
            for _ in range(n_blocks):
                st, _ = rebin(st, self.ts.params)
                # restart FIRE each block: keeps the adaptive dt from
                # running away against the constraint projections
                vw = torch.zeros_like(st.wv)
                vs = torch.zeros_like(st.sv)
                dtf = torch.clamp(dtf, max=dt_start)
                for _ in range(block):
                    st, vw, vs, dtf, al, n_pos, e = fire_step(
                        st, vw, vs, dtf, al, n_pos)
                e_hist.append(e)
            st = dataclasses.replace(st, wv=torch.zeros_like(st.wv),
                                     sv=torch.zeros_like(st.sv))
            return st, torch.stack(e_hist)

        return minimize

    # -- run loop ------------------------------------------------------------

    def make_run(self, n_steps: int, detailed_flags: bool = False):
        """Run loop: rebin + ``rebuild_every``-step blocks. Returns
        run(st) → (state, overflow, obs) with obs stacked per step.

        ``overflow`` is the OR of the capacity flag (rebin's early
        slot-full warning) and the dangerous-build drift flag: a water O
        that moved more than ``skin`` within a block may have missed the
        stencil. With ``detailed_flags=True`` it is the pair (capacity,
        drift). Flags and observables stay on the device."""
        block = self.cfg.rebuild_every
        n_blocks = -(-n_steps // block)
        drift_budget = self.ts.params.skin

        def run(st: TiledState):
            dev = st.wx.device
            ov_cap = torch.zeros((), dtype=torch.bool, device=dev)
            ov_drift = torch.zeros((), dtype=torch.bool, device=dev)
            rows = []
            for _ in range(n_blocks):
                st, ov = rebin(st, self.ts.params)
                ov_cap = ov_cap | ov
                frc = self.compute_forces(st)
                wxO0 = st.wx[:, :, 0::3]
                for _ in range(block):
                    st, frc = self.step(st, frc)
                    rows.append(self.observe(st, frc))
                # rows keep their identity within a block (rebinning only
                # moves rows at block start); parked rows don't move
                dw2 = torch.sum((st.wx[:, :, 0::3] - wxO0) ** 2, dim=0)
                ov_drift = ov_drift | (torch.max(dw2) > drift_budget ** 2)
            obs = Observables.stack(rows)
            if detailed_flags:
                return st, (ov_cap, ov_drift), obs
            return st, ov_cap | ov_drift, obs

        return run
