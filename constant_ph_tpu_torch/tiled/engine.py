"""TiledEngine: the hot-path engine on cell tiles (port of
constant_ph_tpu/tiled/engine.py).

Per step: tile pair blocks, smooth PME under ``kspace_every`` impulse MTS
with the stale-φ carry, λ-dynamics with exact dU/dλ, BAOAB Langevin /
velocity-Verlet / NHC integration with the λ-RESPA inner drift, and tile
SHAKE/RATTLE. The water-water block is a CUDA kernel on the GPU: K1
(csrc/ww_pair.cu) on the hot path, K2 (csrc/ww_tally.cu, per-atom
tallies) with ``use_pallas_ww=True``; ``need_tally`` without K2, and
grids below 3 cells per dim, take the plain tally path
(tiled.forces.water_water). ``make_minimize`` and ``make_run`` return
functions that loop over ``rebuild_every``-step blocks in Python (the JAX
package's lax.scan), rebinning at each block start; they never read a
device value on the host (the MTS boundary test and the metadynamics
deposit test read the state's host step counter), so the caller decides
when to synchronise.

With ``metad`` (metad.MetadParams) the λ forces carry the state's
well-tempered bias tables, and ``make_run`` deposits one hill per site at
a block boundary whenever the block crossed a multiple of the stride
(unless ``metad_frozen``). Random numbers come from a ``torch.Generator``:
the engine's own, or one the caller passes to ``step`` / ``run``.

Replicas are a batch dimension: every method takes a batch of R walkers
(a TiledState whose tensor fields lead with R, as
parallel.replica.stack_replicas makes it; ``step_host`` shared) and moves
them all with one sequence of launches, K1 and K2 each launched once a
force evaluation for the whole batch, as ``jax.vmap`` over the JAX
engine does. Energies, temperatures, flags and ``h_conserved`` come back
(R,), observables (R, T, …). A batch draws replica r's Langevin noise
from ``generators[r]``, in the order a run of that replica alone draws
it. A single state runs through the same code as a batch of one
(unsqueezed at entry, squeezed at exit), with one generator.

k-space is smooth PME (``kspace_ep`` a PMEParams, also on the live box
under NPT) or factorized Ewald (an ops.ewald.EwaldParams: every water slot
and solute atom in one list, charges masked by validity); both run under
``kspace_every`` impulse MTS.

With ``spatial`` (a process group, parallel.spatial.make_spatial_mesh)
the engine runs on x-slabs of the cell grid: its states hold the rank's
owned cells (parallel.spatial.shard_tiled_state), one halo exchange a
force evaluation feeds K1's / K2's slab entries, the water-derived
energies, solute forces, φ and the PME mesh are all-reduced, the water
kinetic energy is all-reduced where it is used, rebinning gathers the
tiles once a block, and the Langevin noise of the whole grid is drawn on
every rank alike (parallel/spatial.py). Not on slabs: factorized Ewald,
grids below 3 cells per dim, make_minimize, and the barostat
(tiled/npt.py), which refuse.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from constant_ph_tpu_torch import lambda_dyn, metad as metad_mod, units
from constant_ph_tpu_torch.batching import (
    PerReplica,
    bview,
    generators_for,
    state_batched,
)
from constant_ph_tpu_torch.engine import (
    EngineConfig,
    Observables,
    full_float32_matmuls,
)
from constant_ph_tpu_torch.integrators import nhc_halfstep, replica_randn
from constant_ph_tpu_torch.lambda_dyn import BiasParams
from constant_ph_tpu_torch.ops.bonded import bonded_forces
from constant_ph_tpu_torch.ops.ewald import ewald_recip_xd
from constant_ph_tpu_torch.ops.pme import PMEParams, pme_recip_tiled
from constant_ph_tpu_torch.parallel import comm, spatial as spatial_mod
from constant_ph_tpu_torch.tiled import forces as tforces
from constant_ph_tpu_torch.tiled.layout import (
    TiledState,
    TiledSystem,
    rebin,
)
from constant_ph_tpu_torch.tiled.shake import TiledWaterShake


@dataclasses.dataclass
class TiledForces(PerReplica):
    """One replica's shapes; a batch leads every field with R."""

    fw: torch.Tensor      # (3, G, 3W)
    fs: torch.Tensor      # (Ns, 3)
    f_lam: torch.Tensor   # (S,)
    e_lj: torch.Tensor
    e_coul: torch.Tensor
    e_bonded: torch.Tensor
    e_kspace: torch.Tensor
    e_site: torch.Tensor
    eatom_w: torch.Tensor  # (G, 3W) per-atom energy tallies (need_tally)
    eatom_s: torch.Tensor  # (Ns,)
    phi_s: torch.Tensor   # (Ns,) φ on solute atoms
    dUdlam: torch.Tensor  # (S,)
    # reciprocal-space φ on solute atoms from the most recent k-space
    # evaluation, carried from step to step so λ forces between MTS
    # boundaries use the stale value (exact at kspace_every == 1); zeros
    # without k-space
    phi_recip_s: torch.Tensor

    @property
    def e_pot(self):
        return (self.e_lj + self.e_coul + self.e_bonded + self.e_kspace
                + self.e_site)


class TiledEngine:
    def __init__(self, tsys: TiledSystem, config: EngineConfig = EngineConfig(),
                 bias: BiasParams = BiasParams(), kspace_ep=None,
                 use_pallas_ww=False, metad=None, metad_frozen=False,
                 spatial=None):
        if config.kspace_every < 1:
            raise ValueError("kspace_every must be >= 1")
        if (config.kspace_live_box and kspace_ep is not None
                and not isinstance(kspace_ep, PMEParams)):
            raise ValueError(
                "kspace_live_box requires PME: factorized-Ewald params bake "
                "box-shaped structure-factor tables at build time; use "
                "ops.pme.make_pme_params for NPT k-space")
        if metad is not None and tsys.spec is None:
            raise ValueError("metadynamics needs titratable sites")
        # the rank's x-slab (parallel/spatial.py), or None
        self.slab = None
        if spatial is not None:
            if kspace_ep is not None and not isinstance(kspace_ep,
                                                        PMEParams):
                raise NotImplementedError(
                    "factorized Ewald on x-slabs is not ported; use PME")
            self.slab = spatial_mod.slab_of(spatial, tsys.params)
        full_float32_matmuls()

        self.ts = tsys
        self.cfg = config
        self.bias = bias
        self.kspace_ep = kspace_ep
        # metadynamics λ bias: states carry matching (S, nbins) tables
        # (metad.init_tables → TiledState.metad_v / metad_dv). With
        # metad_frozen the bias is a static potential; otherwise make_run
        # deposits hills at block boundaries
        self.metad = metad
        self.metad_frozen = metad_frozen
        # use_pallas_ww (the JAX package's name, kept for call-site
        # parity): True runs the full-tally kernel K2 on every force
        # evaluation; False, or the JAX package's "fast", the hot-path
        # kernel K1. Below 3 cells per dim neither applies and the plain
        # tally path runs
        self.use_pallas_ww = (use_pallas_ww is True
                              and min(tsys.params.grid) >= 3)
        self.device = tsys.device
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed)
        if metad is not None:
            metad.grid(self.device)   # made once, outside any run block
        self.shake = TiledWaterShake(tsys.water)
        p = tsys.params
        self.W = p.W
        self.G = p.G
        self.wmass = torch.as_tensor(
            np.tile(tsys.water.mass_pattern, p.W), dtype=torch.float32,
            device=self.device)                                   # (3W,)
        self.wq_pat = torch.as_tensor(
            np.tile(tsys.water.q_pattern, p.W), dtype=torch.float32,
            device=self.device)                                   # (3W,)
        self.n_waters = tsys.water_atom_ids.shape[0]
        self.ns_real = len(tsys.solute_ids)
        self.n_sites = 0 if tsys.spec is None else tsys.spec.n_sites
        n_buf_cons = (tsys.solute_constraints.n_constraints
                      if tsys.solute_constraints is not None else 0)
        self.ndof = (3 * (3 * self.n_waters + self.ns_real) - 3
                     - 3 * self.n_waters - n_buf_cons)
        self.e_corr = 0.0
        if kspace_ep is not None:
            self.e_corr = tforces.water_intra_ewald_correction(
                tsys.water, self.n_waters, kspace_ep.alpha)

    # -- forces ---------------------------------------------------------------

    def charges_solute(self, lam):
        """Solute charges (…, Ns) at λ (…, S)."""
        ts = self.ts
        if ts.spec is None:
            return ts.solute.q0.expand(lam.shape[:-1] + (-1,))
        return lambda_dyn.charges(ts.solute.q0, ts.spec, lam)

    @state_batched
    def compute_forces(self, st: TiledState, need_tally: bool = False,
                       kspace_impulse: bool = False,
                       phi_recip_prev=None) -> TiledForces:
        """Forces + energies (+ per-atom water tallies when ``need_tally``)
        of a batch, or of one state.

        The hot path skips the water eatom/φ tallies: only φ on solute
        atoms feeds dU/dλ, and the tallies serve the compute_Hs
        diagnostic.

        ``kspace_impulse`` (set by the MD step and run loop, not by
        minimisation or diagnostics): with cfg.kspace_every = k > 1 the
        reciprocal term runs only when st.step % k == 0 (decided on the
        host copy of the counter, so nothing waits for the device) and its
        forces enter ×k, so the two half-kicks around a boundary deliver
        the Verlet-I / r-RESPA impulse. Between boundaries λ forces use
        ``phi_recip_prev``, the previous reciprocal φ; off-boundary
        evaluations report e_kspace = 0. φ and energies are not
        amplified."""
        ts = self.ts
        p = ts.params
        gx, gy, gz = p.grid
        W = p.W
        R = st.wx.shape[0]
        slab = self.slab
        G = st.wx.shape[2]                     # cells held (a slab's own)
        gx = G // (gy * gz)
        # the kernels take contiguous tiles and boxes; a batch sliced out
        # of another (every other replica) is strided
        box = st.box.contiguous()
        kw = dict(style=ts.coul_style, alpha=ts.alpha, rc=ts.cutoff)

        wxg = st.wx.reshape(R, 3, gx, gy, gz, 3 * W).contiguous()
        wvg = st.wvalid.reshape(R, gx, gy, gz, W)

        fast_ok = min(p.grid) >= 3 and not need_tally
        wxk, wvk, kwk = wxg, wvg, kw          # the kernels' tiles
        if slab is not None:
            # one halo exchange into the kernels' slab entries; K2's also
            # serves the tallies
            wxk, wvk = spatial_mod.halo(wxg, wvg, slab)
            kwk = dict(kw, x_first=slab.x_first)
        if self.use_pallas_ww or (need_tally and slab is not None):
            e_lj_ww, e_c_ww, f_ww, eatom_ww, _ = tforces.water_water_tally(
                wxk, wvk, ts.water, p, box, **kwk)
        elif fast_ok:
            e_lj_ww, e_c_ww, f_ww = tforces.water_water_fast(
                wxk, ts.water, p, box, **kwk)
            eatom_ww = torch.zeros_like(wxg[:, 0])
        else:
            e_lj_ww, e_c_ww, f_ww, eatom_ww, _ = tforces.water_water(
                wxg, wvg, ts.water, p, box, **kw)

        qs = self.charges_solute(st.lam)                     # (R, Ns)
        if fast_ok:
            e_lj_ws, e_c_ws, f_w_ws, f_s_ws, phi_s_ws = \
                tforces.water_solute_fast(
                    wxg, st.sx, qs, ts.solute, ts.water, p, box,
                    x_first=0 if slab is None else slab.x_first, **kw)
            eatom_w_ws = torch.zeros_like(wxg[:, 0])
            eatom_s_ws = torch.zeros_like(qs)
        else:
            (e_lj_ws, e_c_ws, f_w_ws, f_s_ws, eatom_w_ws, eatom_s_ws, _,
             phi_s_ws) = tforces.water_solute(
                wxg, wvg, st.sx, qs, ts.solute, ts.water, p, box, **kw)
        if slab is not None:
            # the water-derived sums over the ranks, in one all-reduce;
            # the solute's own terms below run on every rank alike
            (e_lj_ww, e_c_ww, e_lj_ws, e_c_ws, f_s_ws, phi_s_ws,
             eatom_s_ws) = self._sum_over_slabs(
                e_lj_ww, e_c_ww, e_lj_ws, e_c_ws, f_s_ws, phi_s_ws,
                eatom_s_ws)
        e_lj_ss, e_c_ss, f_ss, eatom_ss, phi_ss = tforces.solute_solute(
            st.sx, qs, ts.solute, box, **kw)

        fw = (f_ww + f_w_ws).reshape(R, 3, G, 3 * W)
        fs = f_s_ws + f_ss
        eatom_w = (eatom_ww + eatom_w_ws).reshape(R, G, 3 * W)
        eatom_s = eatom_s_ws + eatom_ss
        phi_s = phi_s_ws + phi_ss

        zero = st.sx.new_zeros((R,))
        e_bonded = zero
        if ts.bonded is not None and int(ts.bonded.bond_idx.shape[0]):
            e_bonded, fb, eatom_b = bonded_forces(st.sx, box, ts.bonded)
            fs = fs + fb
            eatom_s = eatom_s + eatom_b

        e_kspace = zero
        phi_recip = torch.zeros_like(qs)
        k_ev = self.cfg.kspace_every if kspace_impulse else 1
        if k_ev > 1 and need_tally:
            raise ValueError("per-atom tallies require a full kspace "
                             "evaluation (call without kspace_impulse)")
        if self.kspace_ep is not None and st.step_host % k_ev != 0:
            # between MTS boundaries: no reciprocal force, the stale φ
            if phi_recip_prev is not None:
                phi_recip = phi_recip_prev
        elif isinstance(self.kspace_ep, PMEParams):
            # an MTS boundary (or no MTS): smooth PME on the cell tiles
            vm_atoms = torch.repeat_interleave(st.wvalid, 3, dim=-1)
            wqg = (self.wq_pat * vm_atoms).reshape(R, gx, gy, gz, 3 * W)
            qs_m = qs * ts.solute.smask
            ek, fwk, fsk, phi_recip, phi_wk = pme_recip_tiled(
                wxg, wqg, st.sx, qs_m, self.kspace_ep,
                need_water_phi=need_tally,
                box=st.box if self.cfg.kspace_live_box else None,
                slab=slab)
            fw = fw + float(k_ev) * fwk.reshape(R, 3, G, 3 * W)
            fs = fs + float(k_ev) * fsk
            if need_tally:
                eatom_w = eatom_w + (0.5 * wqg * phi_wk).reshape(
                    R, G, 3 * W)
                eatom_s = eatom_s + 0.5 * qs_m * phi_recip
            e_kspace = ek + self.e_corr
        elif self.kspace_ep is not None:
            # factorized Ewald over every water slot and solute atom:
            # parked slots carry no charge and get no force
            vm_atoms = torch.repeat_interleave(st.wvalid, 3,
                                               dim=-1).reshape(R, -1)
            nw = vm_atoms.shape[-1]
            q_all = torch.cat([self.wq_pat.repeat(self.G) * vm_atoms,
                               qs * ts.solute.smask], dim=-1)
            xd = tuple(torch.cat([st.wx[:, d].reshape(R, -1), st.sx[..., d]],
                                 dim=-1) for d in range(3))
            ek, fk, phik, eatomk = ewald_recip_xd(xd, q_all, self.kspace_ep)
            fwk = torch.stack([fk[d][:, :nw] * vm_atoms for d in range(3)],
                              dim=1)
            fsk = torch.stack([fk[d][:, nw:] for d in range(3)], dim=-1)
            fw = fw + float(k_ev) * fwk.reshape(R, 3, self.G, 3 * W)
            fs = fs + float(k_ev) * fsk
            phi_recip = phik[:, nw:]
            eatom_w = eatom_w + eatomk[:, :nw].reshape(R, self.G, 3 * W)
            eatom_s = eatom_s + eatomk[:, nw:]
            e_kspace = ek + self.e_corr

        phi_s = phi_s + phi_recip
        if ts.spec is not None:
            dUdlam = lambda_dyn.dq_dlambda_dot(ts.spec, phi_s)
            f_lam, u_site = lambda_dyn.lambda_force(
                st.lam, dUdlam, ts.spec, st.pH[:, None], self.cfg.T,
                self.bias)
            e_site = torch.sum(u_site, dim=-1)
            if self.metad is not None:
                if tuple(st.metad_v.shape[1:]) != (ts.spec.n_sites,
                                                   self.metad.nbins):
                    raise ValueError(
                        "state carries no metadynamics tables of this "
                        "shape: set them with metad.init_tables "
                        "(TiledState.metad_v / metad_dv)")
                vb, dvb = metad_mod.lookup(st.metad_v, st.metad_dv, st.lam,
                                           self.metad)
                f_lam = f_lam - dvb
                e_site = e_site + torch.sum(vb, dim=-1)
        else:
            dUdlam = f_lam = st.sx.new_zeros((R, 0))
            e_site = zero

        return TiledForces(
            fw=fw, fs=fs, f_lam=f_lam,
            e_lj=e_lj_ww + e_lj_ws + e_lj_ss,
            e_coul=e_c_ww + e_c_ws + e_c_ss,
            e_bonded=e_bonded, e_kspace=e_kspace, e_site=e_site,
            eatom_w=eatom_w, eatom_s=eatom_s, phi_s=phi_s, dUdlam=dUdlam,
            phi_recip_s=phi_recip,
        )

    def _sum_over_slabs(self, *parts):
        """Each (R, …) tensor of ``parts`` summed over the slabs' ranks,
        all in one all-reduce."""
        R = parts[0].shape[0]
        flat = comm.all_reduce_sum(
            torch.cat([t.reshape(R, -1) for t in parts], dim=1),
            self.slab.group)
        out, at = [], 0
        for t in parts:
            k = t[0].numel()
            out.append(flat[:, at:at + k].reshape(t.shape))
            at += k
        return out

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
        """Kinetic energy (R,) of a batch's velocities (on slabs, the
        water's summed over the ranks)."""
        vm_atoms = torch.repeat_interleave(wvalid, 3, dim=-1)[:, None]
        ke_w = 0.5 * units.MVV2E * torch.sum(
            (self.wmass * wv * wv * vm_atoms).flatten(1), dim=-1)
        if self.slab is not None:
            ke_w = comm.all_reduce_sum(ke_w, self.slab.group)
        sol = self.ts.solute
        ke_s = 0.5 * units.MVV2E * torch.sum(
            (sol.mass[:, None] * sv * sv * sol.smask[:, None]).flatten(1),
            dim=-1)
        return ke_w + ke_s

    @state_batched
    def kinetic_energy(self, st: TiledState):
        return self._ke(st.wvalid, st.wv, st.sv)

    @state_batched
    def observe(self, st: TiledState, frc: TiledForces) -> Observables:
        """Observables of a batch (fields (R, …)), or of one state."""
        ke = self._ke(st.wvalid, st.wv, st.sv)
        temp = 2.0 * ke / (self.ndof * units.BOLTZ)
        if self.ts.spec is not None:
            ke_lam = lambda_dyn.lambda_kinetic(st.v_lam, self.ts.spec)
            temp_lam = lambda_dyn.lambda_temperature(st.v_lam, self.ts.spec)
        else:
            ke_lam = temp_lam = torch.zeros_like(ke)
        # under impulse MTS h_conserved is exact only on k-space boundary
        # rows (off-boundary rows report e_kspace = 0); h_valid marks them
        k_ev = self.cfg.kspace_every
        if self.kspace_ep is None or k_ev == 1:
            h_valid = torch.ones(ke.shape, dtype=torch.bool, device=ke.device)
        else:
            h_valid = (st.step % k_ev) == 0
        return Observables(
            e_pot=frc.e_pot, e_lj=frc.e_lj, e_coul=frc.e_coul,
            e_bonded=frc.e_bonded, e_kspace=frc.e_kspace, e_site=frc.e_site,
            ke=ke, temp=temp, ke_lam=ke_lam, temp_lam=temp_lam,
            h_conserved=frc.e_pot + ke + ke_lam - st.ext_work,
            h_valid=h_valid, ext_work=st.ext_work, lam=st.lam, v_lam=st.v_lam,
            dUdlam=frc.dUdlam,
        )

    def compute_Hs(self, st: TiledState, frc: TiledForces | None = None):
        """Per-atom energy diagnostic of the reference fix: HA = Σ eatom,
        HB = HA without the titratable-H group ((R,) each for a batch)."""
        if frc is None:
            frc = self.compute_forces(st, need_tally=True)
        vm_atoms = torch.repeat_interleave(st.wvalid, 3, dim=-1)
        HA_w = torch.sum(frc.eatom_w * vm_atoms, dim=(-2, -1))
        if self.slab is not None:
            HA_w = comm.all_reduce_sum(HA_w, self.slab.group)
        HA = HA_w + torch.sum(frc.eatom_s * self.ts.solute.smask, dim=-1)
        HB = HA - torch.sum(torch.where(self.ts.groupH_mask, frc.eatom_s,
                                        0.0), dim=-1)
        return HA, HB

    # -- integration ------------------------------------------------------------

    def _lam_kick_scale(self, step, offset):
        """Each replica's λ kick factor (R, 1) at its step (R,)."""
        nev = self.cfg.lambda_nevery
        if nev <= 1 or self.ts.spec is None:
            return 1.0
        active = ((step + offset) % nev) == 0
        return active.to(torch.float32)[:, None] * float(nev)

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
        wnorm = torch.sqrt(torch.sum(frc.fw * frc.fw, dim=-3, keepdim=True)
                           + 1e-12)
        snorm = torch.sqrt(torch.sum(frc.fs * frc.fs, dim=-1, keepdim=True)
                           + 1e-12)
        return dataclasses.replace(
            frc, fw=frc.fw * torch.clamp(cap / wnorm, max=1.0),
            fs=frc.fs * torch.clamp(cap / snorm, max=1.0))

    def _project_solute(self, sx, sv, box):
        sc = self.ts.solute_constraints
        return sc.velocities(sx, sv, box) if sc is not None else sv

    @state_batched
    def step(self, st: TiledState, frc: TiledForces, generators=None):
        """One BAOAB (or velocity-Verlet / NHC) step of a batch, or of one
        state; returns the new state and the forces at its positions.
        Langevin noise comes from ``generators`` (one a replica; for one
        state a Generator, default: the engine's)."""
        gens = generators_for(st.wx.shape[0], generators, self.generator)
        cfg = self.cfg
        ts = self.ts
        dt = cfg.dt
        has_lam = ts.spec is not None
        move_lam = has_lam and not cfg.lambda_frozen
        frc = self._cap_forces(frc)

        vm_atoms = torch.repeat_interleave(st.wvalid, 3, dim=-1)[:, None]
        inv_mw = units.FTM2V / self.wmass
        inv_ms = units.FTM2V / ts.solute.mass[:, None]
        inv_ml = units.FTM2V / ts.spec.m_lambda if has_lam else None
        pH = st.pH[:, None]                  # against (R, S) λ arrays

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
            wv = wv * bview(scale, wv.ndim)
            sv = sv * bview(scale, sv.ndim)
            ext_work = ext_work + 0.5 * ke2 * (scale * scale - 1.0)
        if move_lam and cfg.lambda_thermostat == "nhc":
            ke2l = 2.0 * lambda_dyn.lambda_kinetic(v_lam, ts.spec)
            scale_l, nhc_lam_xi = nhc_halfstep(
                nhc_lam_xi, ke2l, self.n_sites, kT, cfg.lambda_tau, dt)
            v_lam = v_lam * scale_l[:, None]
            ext_work = ext_work + 0.5 * ke2l * (scale_l * scale_l - 1.0)

        # B
        wv = wv + (0.5 * dt) * frc.fw * inv_mw * vm_atoms
        sv = sv + (0.5 * dt) * frc.fs * inv_ms
        if move_lam:
            k1 = self._lam_kick_scale(st.step, 0)
            v_lam = v_lam + (0.5 * dt) * k1 * self._lam_slow_force(
                frc.f_lam, st.lam, pH) * inv_ml

        # A
        wx = wx + (0.5 * dt) * wv
        sx = sx + (0.5 * dt) * sv
        if move_lam:
            lam, v_lam = self._lam_drift(lam, v_lam, pH, 0.5 * dt, inv_ml)

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
                               / (self.wmass * units.MVV2E))
            noise = (replica_randn(wv, gens) if self.slab is None else
                     spatial_mod.slab_randn(wv, gens, self.slab, self.G))
            wv = c1 * wv + sig_w * vm_atoms * noise
            sig_s = torch.sqrt((1.0 - c1 * c1) * kT
                               / (ts.solute.mass * units.MVV2E))[:, None]
            sv = c1 * sv + sig_s * ts.solute.smask[:, None] * replica_randn(
                sv, gens)
            ext_work = ext_work + ke_proj(wv, sv) - ke_o0
        if move_lam and cfg.lambda_thermostat == "langevin":
            kel_o0 = lambda_dyn.lambda_kinetic(v_lam, ts.spec)
            c1l = math.exp(-cfg.lambda_gamma * dt)
            sig_l = torch.sqrt((1.0 - c1l * c1l) * kT
                               / (ts.spec.m_lambda * units.MVV2E))
            v_lam = c1l * v_lam + sig_l * replica_randn(v_lam, gens)
            ext_work = (ext_work + lambda_dyn.lambda_kinetic(v_lam, ts.spec)
                        - kel_o0)

        # A
        wx = wx + (0.5 * dt) * wv
        sx = sx + (0.5 * dt) * sv
        if move_lam:
            lam, v_lam = self._lam_drift(lam, v_lam, pH, 0.5 * dt, inv_ml)
            lam, v_lam = self._reflect_lam(lam, v_lam)

        # SHAKE water (tiled) + buffer-water solute constraints
        wx, wv = self.shake.positions(st.wx, wx, wv, st.box, dt, st.wvalid)
        if ts.solute_constraints is not None:
            sx, sv = ts.solute_constraints.positions(st.sx, sx, sv, st.box,
                                                     dt)

        # the step counter advances BEFORE the force evaluation, so its MTS
        # boundary test agrees with the block-start recompute in make_run
        # (positions x_c, counter c after rebin); otherwise every rebuild
        # adds a spurious k-space half-impulse
        st_new = dataclasses.replace(st, wx=wx, sx=sx, lam=lam,
                                     step=st.step + 1,
                                     step_host=st.step_host + 1)
        frc_new = self.compute_forces(st_new, kspace_impulse=True,
                                      phi_recip_prev=frc.phi_recip_s)
        frc_capped = self._cap_forces(frc_new)

        # B
        wv = wv + (0.5 * dt) * frc_capped.fw * inv_mw * vm_atoms
        sv = sv + (0.5 * dt) * frc_capped.fs * inv_ms
        if move_lam:
            k2 = self._lam_kick_scale(st.step, 1)
            v_lam = v_lam + (0.5 * dt) * k2 * self._lam_slow_force(
                frc_new.f_lam, lam, pH) * inv_ml

        if use_nhc:
            ke2 = 2.0 * ke_vel(wv, sv)
            scale, nhc_xi = nhc_halfstep(nhc_xi, ke2, self.ndof, kT,
                                         cfg.tau, dt)
            # book the thermostat's work on constraint-projected KE (the
            # projection is linear, so it commutes with the uniform scale)
            ke2_p = 2.0 * ke_vel(
                self.shake.velocities(wx, wv, st.box, st.wvalid),
                self._project_solute(sx, sv, st.box))
            wv = wv * bview(scale, wv.ndim)
            sv = sv * bview(scale, sv.ndim)
            ext_work = ext_work + 0.5 * ke2_p * (scale * scale - 1.0)
        if move_lam and cfg.lambda_thermostat == "nhc":
            ke2l = 2.0 * lambda_dyn.lambda_kinetic(v_lam, ts.spec)
            scale_l, nhc_lam_xi = nhc_halfstep(
                nhc_lam_xi, ke2l, self.n_sites, kT, cfg.lambda_tau, dt)
            v_lam = v_lam * scale_l[:, None]
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
        (st with zero velocities, per-block final energies). Not on
        x-slabs."""
        if self.slab is not None:
            raise NotImplementedError(
                "FIRE on x-slabs is not ported: minimise the whole grid, "
                "then shard the state")
        block = self.cfg.rebuild_every
        n_blocks = -(-n_steps // block)
        inv_mw = (units.FTM2V / self.wmass)[None, None, :]
        inv_ms = units.FTM2V / self.ts.solute.mass[:, None]
        smask = self.ts.solute.smask[:, None]

        def fire_step(st, vw, vs, dtf, al, n_pos):
            frc = self.compute_forces(st)
            vm = torch.repeat_interleave(st.wvalid, 3, dim=-1)[..., None, :, :]
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
            lw = torch.sqrt(torch.sum(dxw * dxw, dim=-3, keepdim=True)
                            + 1e-20)
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
            if not e_hist:                  # n_steps 0, as JAX's (0,)
                return st, torch.zeros(0, dtype=dtype, device=dev)
            return st, torch.stack(e_hist)

        return minimize

    # -- run loop ------------------------------------------------------------

    def _deposit(self, st: TiledState, block: int) -> TiledState:
        """One hill per site and replica at the end of a block that
        crossed a multiple of the stride (the block started at step_host −
        block), decided on the host counter so nothing waits for the
        device. The deposit raises e_site by ΔV(λ) at once; each replica's
        ext_work books its own, so h_conserved stays an oracle while hills
        land."""
        p = self.metad
        if (st.step_host - block) % p.stride >= block:
            return st
        mv, mdv = metad_mod.deposit(st.metad_v, st.metad_dv, st.lam, p)
        dV = (metad_mod.lookup(mv, mdv, st.lam, p)[0]
              - metad_mod.lookup(st.metad_v, st.metad_dv, st.lam, p)[0])
        return dataclasses.replace(
            st, metad_v=mv, metad_dv=mdv,
            ext_work=st.ext_work + torch.sum(dV, dim=-1))

    def _rebin(self, st: TiledState):
        """layout.rebin of a batch; on slabs through one gather of the
        tiles (parallel.spatial.rebin_slab)."""
        if self.slab is None:
            return rebin(st, self.ts.params)
        return spatial_mod.rebin_slab(st, self.slab, self.ts.params)

    def make_run(self, n_steps: int, detailed_flags: bool = False):
        """Run loop: rebin + ``rebuild_every``-step blocks. Returns
        run(batch, generators=None) → (batch, overflow (R,), obs (R, T,
        …)): R walkers advanced by one sequence of launches (the JAX
        package's jax.vmap(make_run(n))), replica r's Langevin noise from
        generators[r]. run(state, generator=None) runs one state as a
        batch of one, overflow 0-d and obs (T, …); its noise comes from
        ``generator`` (default: the engine's).

        ``overflow`` is the OR of the capacity flag (rebin's early
        slot-full warning) and the dangerous-build drift flag: a water O
        that moved more than ``skin`` within a block may have missed the
        stencil. With ``detailed_flags=True`` it is the pair (capacity,
        drift). Flags and observables stay on the device."""
        block = self.cfg.rebuild_every
        n_blocks = -(-n_steps // block)
        drift_budget = self.ts.params.skin

        @state_batched
        def run(st: TiledState, generators=None):
            gens = generators_for(st.wx.shape[0], generators, self.generator)
            R = st.wx.shape[0]
            dev = st.wx.device
            ov_cap = torch.zeros((R,), dtype=torch.bool, device=dev)
            ov_drift = torch.zeros((R,), dtype=torch.bool, device=dev)
            rows = []
            for _ in range(n_blocks):
                st, ov = self._rebin(st)
                ov_cap = ov_cap | ov
                frc = self.compute_forces(st, kspace_impulse=True,
                                          phi_recip_prev=st.phi_recip_s)
                wxO0 = st.wx[..., 0::3]
                for _ in range(block):
                    st, frc = self.step(st, frc, gens)
                    rows.append(self.observe(st, frc))
                # rows keep their identity within a block (rebinning only
                # moves rows at block start); parked rows don't move
                dw2 = torch.sum((st.wx[..., 0::3] - wxO0) ** 2, dim=1)
                drift = torch.amax(dw2, dim=(1, 2)) > drift_budget ** 2
                if self.slab is not None:
                    drift = comm.all_reduce_sum(
                        drift.to(torch.float32), self.slab.group) > 0
                ov_drift = ov_drift | drift
                # keep the k-space MTS carry in the state, so the next run
                # call keeps the stale-φ λ coupling
                st = dataclasses.replace(st, phi_recip_s=frc.phi_recip_s)
                if self.metad is not None and not self.metad_frozen:
                    st = self._deposit(st, block)
            obs = Observables.stack(rows, dim=1)
            if detailed_flags:
                return st, (ov_cap, ov_drift), obs
            return st, ov_cap | ov_drift, obs

        return run
