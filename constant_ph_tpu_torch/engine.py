"""The reference MD engine on padded neighbour lists, its run
configuration and per-step observables (port of
constant_ph_tpu/engine.py).

``Engine`` composes pair forces (ops/pair.py), bonded terms, an optional
k-space hook (ops/ewald.make_kspace_fn), extra potentials, λ-dynamics with
exact dU/dλ, BAOAB Langevin / velocity-Verlet / NHC integration with the
λ-RESPA inner drift, and M-SHAKE/M-RATTLE constraints. It is the semantic
reference the tiled hot path (tiled/engine.TiledEngine) is held to.

``make_run`` loops over ``rebuild_every``-step blocks in Python (the JAX
package's lax.scan). At each block start it builds a candidate list and
keeps it, field by field with torch.where, where the skin trigger fired
(the JAX package's lax.cond): nothing is read back to the host, at the
cost of one list build a block. The λ kick schedule of lambda_nevery reads
the state's host step counter. Random numbers come from a
``torch.Generator``: the engine's own, or one the caller passes.

Replicas are a batch dimension, as in the tiled engine: every method takes
a batch of R replicas (a SystemState and a NeighborList whose tensor
fields lead with R, as parallel.replica.stack_replicas makes them;
``step_host`` shared) and moves them all with one sequence of launches,
the JAX package's ``jax.vmap(make_run(n))(states, nbrs)``: one list build
a block for all R, each replica keeping its own list unless its own skin
trigger fired. Energies, temperatures and ``h_conserved`` come back (R,),
observables (R, T, …). Replica r draws its Langevin noise from
``generators[r]``, in the order a run of that replica alone draws it (v,
then v_λ, each step). A single state runs through the same code as a
batch of one (batching.state_batched), with one generator.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from constant_ph_tpu_torch import lambda_dyn, profiling, units
from constant_ph_tpu_torch.batching import (
    PerReplica,
    generators_for,
    state_batched,
)
from constant_ph_tpu_torch.forcefield import ForceField
from constant_ph_tpu_torch.integrators import (
    kinetic_energy,
    langevin_o_step,
    nhc_halfstep,
)
from constant_ph_tpu_torch.lambda_dyn import BiasParams, LambdaSpec
from constant_ph_tpu_torch.neighbors import (
    NeighborList,
    NeighborParams,
    build_neighbor_list,
    needs_rebuild,
    select,
    stencil_offsets,
)
from constant_ph_tpu_torch.ops.pair import pair_forces
from constant_ph_tpu_torch.state import SystemState


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static run configuration."""

    dt: float = 1.0                  # fs
    T: float = 300.0                 # K
    thermostat: str = "langevin"     # "langevin" | "nhc" | "nve"
    gamma: float = 0.001             # 1/fs
    tau: float = 100.0               # fs (NHC)
    lambda_nevery: int = 1
    lambda_thermostat: str = "langevin"   # "langevin" | "nhc" | "none"
    lambda_gamma: float = 0.005
    lambda_tau: float = 200.0
    # λ-RESPA: lambda_inner // 2 velocity-Verlet substeps of λ against
    # the analytic stiff force per half drift; 1 = single-rate drift
    lambda_inner: int = 8
    rebuild_every: int = 20
    # k-space impulse MTS (Verlet-I / r-RESPA outer level): the reciprocal
    # term is evaluated every kspace_every steps and applied ×kspace_every
    # in the two half-kicks around the evaluation; λ forces in between use
    # the last reciprocal φ (tiled/engine.py)
    kspace_every: int = 1
    # per-atom force-norm cap in kcal/mol/Å (0 = off)
    force_cap: float = 0.0
    # reflective λ backstop walls (folding reflection, tiled/engine.py)
    lam_min: float = -0.5
    lam_max: float = 1.5
    lambda_frozen: bool = False
    # derive the PME influence function, spacing and volume from the live
    # state box at each k-space evaluation (ops/pme.pme_influence) instead
    # of the box baked into the PME params (NPT)
    kspace_live_box: bool = False
    # seed of the engine's torch.Generator (thermostat noise); the JAX
    # package keeps a PRNG key in its state instead
    seed: int = 0

    def __post_init__(self):
        # the JAX engine silently rounds an odd lambda_inner down
        # (m = lambda_inner // 2); the port refuses it
        if self.lambda_inner > 1 and self.lambda_inner % 2:
            raise ValueError(
                f"lambda_inner must be 1 or even, got {self.lambda_inner}: "
                "each half drift runs lambda_inner // 2 substeps")


@dataclasses.dataclass
class Observables:
    """Per-step observables: energies, temperatures, λ state and the
    conserved quantity h_conserved = E_tot − ext_work."""

    e_pot: torch.Tensor
    e_lj: torch.Tensor
    e_coul: torch.Tensor
    e_bonded: torch.Tensor
    e_kspace: torch.Tensor
    e_site: torch.Tensor
    ke: torch.Tensor
    temp: torch.Tensor
    ke_lam: torch.Tensor
    temp_lam: torch.Tensor
    h_conserved: torch.Tensor
    h_valid: torch.Tensor
    ext_work: torch.Tensor
    lam: torch.Tensor        # (S,)
    v_lam: torch.Tensor      # (S,)
    dUdlam: torch.Tensor     # (S,)

    @staticmethod
    def stack(rows: list, dim: int = 0) -> "Observables":
        """Stack per-step rows into one Observables with a step axis at
        ``dim`` (0; 1 for rows of a replica batch, giving (R, T, …));
        device tensors, nothing is copied to the host."""
        return Observables(**{
            f.name: torch.stack([getattr(r, f.name) for r in rows], dim=dim)
            for f in dataclasses.fields(Observables)})


def full_float32_matmuls():
    """TF32 off and float32 matmuls at "highest": SHAKE, PME's B-spline
    factors and the Ewald sums need full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@dataclasses.dataclass
class Forces(PerReplica):
    """One replica's shapes; a batch leads every field with R."""

    f: torch.Tensor          # (N, 3)
    f_lam: torch.Tensor      # (S,)
    e_lj: torch.Tensor
    e_coul: torch.Tensor
    e_bonded: torch.Tensor
    e_kspace: torch.Tensor
    e_site: torch.Tensor     # Σ bias + pH terms over sites
    eatom: torch.Tensor      # (N,) per-atom tally
    phi: torch.Tensor        # (N,) ∂U/∂q
    dUdlam: torch.Tensor     # (S,)

    @property
    def e_pot(self):
        return (self.e_lj + self.e_coul + self.e_bonded + self.e_kspace
                + self.e_site)


class Engine:
    """Composes a force field (+ λ sites, bonded terms, a k-space hook and
    extra potentials) into step and run functions.

    ``bonded_fn`` (x, box) → (E, F, eatom); ``kspace_fn`` and each entry
    of ``extra_potentials`` (x, q, box) → (E, F, φ, eatom)."""

    def __init__(self, ff: ForceField, nbr_params: NeighborParams,
                 config: EngineConfig = EngineConfig(),
                 spec: Optional[LambdaSpec] = None,
                 bias: BiasParams = BiasParams(),
                 extra_potentials: tuple = (),
                 bonded_fn: Optional[Callable] = None,
                 kspace_fn: Optional[Callable] = None,
                 constraints=None):
        if config.kspace_every > 1:
            raise ValueError(
                "kspace_every > 1 (k-space impulse MTS) is implemented in "
                "TiledEngine only; the reference Engine evaluates k-space "
                "every step")
        if config.kspace_live_box:
            raise ValueError(
                "kspace_live_box (NPT k-space) is implemented in "
                "TiledEngine + PME only")
        if config.force_cap > 0.0:
            # the JAX package's Engine ignores the cap without a word
            raise ValueError("force_cap is implemented in TiledEngine only")
        full_float32_matmuls()
        self.ff = ff
        self.nbr_params = nbr_params
        self.cfg = config
        self.spec = spec
        self.bias = bias
        self.extra_potentials = tuple(extra_potentials)
        self.bonded_fn = bonded_fn
        self.kspace_fn = kspace_fn
        self.constraints = constraints
        self.n_constraints = (0 if constraints is None
                              else constraints.n_constraints)
        self.n_sites = 0 if spec is None else spec.n_sites
        self.device = ff.mass.device
        self.excl_idx = torch.as_tensor(ff.excl_idx, dtype=torch.int64,
                                        device=self.device)
        self.excl_code = torch.as_tensor(ff.excl_code, dtype=torch.int64,
                                         device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed)
        self.stencil_offsets = stencil_offsets(nbr_params, self.device)

    # -- neighbour structure ----------------------------------------------

    @profiling.spanned("cph.nbr_build")
    def build_neighbors(self, x, box) -> NeighborList:
        """One replica's list, or a batch's (x (R, N, 3), box (R, 3)) in
        one build."""
        return build_neighbor_list(x, box, self.nbr_params, self.excl_idx,
                                   self.excl_code, self.stencil_offsets)

    # -- forces -----------------------------------------------------------

    def charges(self, lam):
        """Charges (…, N) of λ (…, S)."""
        if self.spec is None:
            return self.ff.q0.expand(lam.shape[:-1] + self.ff.q0.shape)
        return lambda_dyn.charges(self.ff.q0, self.spec, lam)

    @profiling.spanned("cph.forces")
    @state_batched
    def compute_forces(self, x, lam, box, pH, nbr: NeighborList) -> Forces:
        """Forces of a batch (x (R, N, 3), lam (R, S), box (R, 3), pH
        (R,), nbr a batch of lists), or of one replica."""
        profiling.count("forces")
        ff = self.ff
        q = self.charges(lam)
        with profiling.span("cph.forces.pair"):
            pr = pair_forces(x, q, ff.type, box, nbr, ff.pair)
        f, phi, eatom = pr.force, pr.phi, pr.eatom
        zero = x.new_zeros(x.shape[:1])
        e_bonded = e_kspace = zero

        if self.bonded_fn is not None:
            eb, fb, eatom_b = self.bonded_fn(x, box)
            e_bonded = e_bonded + eb
            f = f + fb
            eatom = eatom + eatom_b
        if self.kspace_fn is not None:
            with profiling.span("cph.forces.kspace"):
                ek, fk, phik, eatom_k = self.kspace_fn(x, q, box)
            e_kspace = e_kspace + ek
            f = f + fk
            phi = phi + phik
            eatom = eatom + eatom_k
        for pot in self.extra_potentials:
            ep, fp, phip, eatom_p = pot(x, q, box)
            e_bonded = e_bonded + ep
            f = f + fp
            phi = phi + phip
            eatom = eatom + eatom_p

        if self.spec is not None:
            with profiling.span("cph.forces.lambda"):
                dUdlam = lambda_dyn.dq_dlambda_dot(self.spec, phi)
                f_lam, u_site = lambda_dyn.lambda_force(
                    lam, dUdlam, self.spec, pH[:, None], self.cfg.T,
                    self.bias)
                e_site = torch.sum(u_site, dim=-1)
        else:
            dUdlam = f_lam = x.new_zeros(x.shape[:1] + (0,))
            e_site = zero
        return Forces(f=f, f_lam=f_lam, e_lj=pr.e_lj, e_coul=pr.e_coul,
                      e_bonded=e_bonded, e_kspace=e_kspace, e_site=e_site,
                      eatom=eatom, phi=phi, dUdlam=dUdlam)

    # -- observables ------------------------------------------------------

    def _ndof(self, x):
        return 3 * x.shape[-2] - 3 - self.n_constraints

    @profiling.spanned("cph.observe")
    @state_batched
    def observe(self, state: SystemState, frc: Forces) -> Observables:
        """Observables of a batch (fields (R, …)), or of one state."""
        ke = kinetic_energy(state.v, self.ff.mass)
        ndof = self._ndof(state.x)
        temp = 2.0 * ke / (ndof * units.BOLTZ)
        if self.spec is not None:
            ke_lam = lambda_dyn.lambda_kinetic(state.v_lam, self.spec)
            temp_lam = lambda_dyn.lambda_temperature(state.v_lam, self.spec)
        else:
            ke_lam = temp_lam = torch.zeros_like(ke)
        return Observables(
            e_pot=frc.e_pot, e_lj=frc.e_lj, e_coul=frc.e_coul,
            e_bonded=frc.e_bonded, e_kspace=frc.e_kspace, e_site=frc.e_site,
            ke=ke, temp=temp, ke_lam=ke_lam, temp_lam=temp_lam,
            h_conserved=frc.e_pot + ke + ke_lam - state.ext_work,
            h_valid=torch.ones(ke.shape, dtype=torch.bool,
                               device=ke.device),
            ext_work=state.ext_work, lam=state.lam, v_lam=state.v_lam,
            dUdlam=frc.dUdlam)

    # -- one MD step ------------------------------------------------------

    def _lam_kick_scale(self, step_host: int, offset: int) -> float:
        """Impulse-MTS λ kick factor: nevery at λ-steps, 0 otherwise,
        decided on the host step counter."""
        nev = self.cfg.lambda_nevery
        if nev <= 1 or self.spec is None:
            return 1.0
        return float(nev) if (step_host + offset) % nev == 0 else 0.0

    def _lam_drift(self, lam, v_lam, pH, h, inv_ml):
        """λ-RESPA inner drift: lambda_inner // 2 velocity-Verlet substeps
        against the analytic stiff force; lambda_inner == 1 is a plain
        drift."""
        m = self.cfg.lambda_inner // 2
        if m <= 0 or self.spec is None:
            return lam + h * v_lam, v_lam
        hs = h / m
        spec, T, bias = self.spec, self.cfg.T, self.bias
        for _ in range(m):
            f = lambda_dyn.analytic_lambda_force(lam, spec, pH, T, bias)
            v_lam = v_lam + (0.5 * hs) * f * inv_ml
            lam = lam + hs * v_lam
            f = lambda_dyn.analytic_lambda_force(lam, spec, pH, T, bias)
            v_lam = v_lam + (0.5 * hs) * f * inv_ml
        return lam, v_lam

    def _lam_slow_force(self, f_lam, lam, pH):
        """Outer λ force: total minus the part the inner loop owns."""
        if self.cfg.lambda_inner // 2 <= 0 or self.spec is None:
            return f_lam
        return f_lam - lambda_dyn.analytic_lambda_force(
            lam, self.spec, pH, self.cfg.T, self.bias)

    def _reflect_lam(self, lam, v_lam):
        # folding reflection: maps any λ back into [lo, hi], velocity
        # flipped on odd legs (torch.remainder is floor-mod, as jnp.mod)
        lo, hi = self.cfg.lam_min, self.cfg.lam_max
        rng = hi - lo
        y = torch.remainder(lam - lo, 2.0 * rng)
        odd = y > rng
        return (torch.where(odd, 2.0 * rng - y, y) + lo,
                torch.where(odd, -v_lam, v_lam))

    @profiling.spanned("cph.step")
    @state_batched
    def step(self, state: SystemState, frc: Forces, nbr: NeighborList,
             generators=None):
        """One BAOAB / velocity-Verlet / NHC step for atoms and λ of a
        batch, or of one state; returns (state', forces at its positions).
        Langevin noise comes from ``generators`` (one a replica; for one
        state a Generator, default: the engine's); a batch without Langevin
        noise needs none."""
        profiling.count("steps")
        cfg = self.cfg
        mass = self.ff.mass
        dt = cfg.dt
        inv_m = units.FTM2V / mass[:, None]
        move_lam = self.spec is not None and not cfg.lambda_frozen
        inv_ml = units.FTM2V / self.spec.m_lambda if move_lam else None
        if cfg.thermostat == "langevin" or (
                move_lam and cfg.lambda_thermostat == "langevin"):
            gens = generators_for(state.x.shape[0], generators,
                                  self.generator)

        v, v_lam = state.v, state.v_lam
        x, lam = state.x, state.lam
        pH = state.pH[:, None]               # against (R, S) λ arrays
        use_nhc = cfg.thermostat == "nhc"
        nhc_xi, nhc_lam_xi = state.nhc_xi, state.nhc_lam_xi
        ndof = self._ndof(x)
        kT = units.BOLTZ * cfg.T
        # cumulative KE change of every thermostat operation: h_conserved
        # stays an oracle under NHC and Langevin, not just NVE
        ext_work = state.ext_work

        if use_nhc:
            ke2 = 2.0 * kinetic_energy(v, mass)
            scale, nhc_xi = nhc_halfstep(nhc_xi, ke2, ndof, kT, cfg.tau, dt)
            v = v * scale[:, None, None]
            ext_work = ext_work + 0.5 * ke2 * (scale * scale - 1.0)
        if move_lam and cfg.lambda_thermostat == "nhc":
            ke2l = 2.0 * lambda_dyn.lambda_kinetic(v_lam, self.spec)
            scale_l, nhc_lam_xi = nhc_halfstep(
                nhc_lam_xi, ke2l, self.n_sites, kT, cfg.lambda_tau, dt)
            v_lam = v_lam * scale_l[:, None]
            ext_work = ext_work + 0.5 * ke2l * (scale_l * scale_l - 1.0)

        # B: half kick
        v = v + (0.5 * dt) * frc.f * inv_m
        if move_lam:
            k1 = self._lam_kick_scale(state.step_host, 0)
            v_lam = v_lam + (0.5 * dt) * k1 * self._lam_slow_force(
                frc.f_lam, state.lam, pH) * inv_ml

        # A: half drift
        x = x + (0.5 * dt) * v
        if move_lam:
            lam, v_lam = self._lam_drift(lam, v_lam, pH, 0.5 * dt, inv_ml)

        # O: Langevin OU; its heat is booked on constraint-projected
        # copies (the dynamics keep the raw velocities)
        if cfg.thermostat == "langevin":
            def ke_p(v_):
                if self.constraints is not None:
                    v_ = self.constraints.velocities(x, v_, state.box)
                return kinetic_energy(v_, mass)

            ke_o0 = ke_p(v)
            v = langevin_o_step(gens, v, mass, cfg.T, cfg.gamma, dt)
            ext_work = ext_work + ke_p(v) - ke_o0
        if move_lam and cfg.lambda_thermostat == "langevin":
            kel_o0 = lambda_dyn.lambda_kinetic(v_lam, self.spec)
            v_lam = langevin_o_step(gens, v_lam, self.spec.m_lambda, cfg.T,
                                    cfg.lambda_gamma, dt)
            ext_work = (ext_work
                        + lambda_dyn.lambda_kinetic(v_lam, self.spec)
                        - kel_o0)

        # A: half drift
        x = x + (0.5 * dt) * v
        if move_lam:
            lam, v_lam = self._lam_drift(lam, v_lam, pH, 0.5 * dt, inv_ml)
            lam, v_lam = self._reflect_lam(lam, v_lam)

        # SHAKE positions onto the constraint manifold
        if self.constraints is not None:
            x, v = self.constraints.positions(state.x, x, v, state.box, dt)

        frc_new = self.compute_forces(x, lam, state.box, state.pH, nbr)

        # B: half kick
        v = v + (0.5 * dt) * frc_new.f * inv_m
        if move_lam:
            k2 = self._lam_kick_scale(state.step_host, 1)
            v_lam = v_lam + (0.5 * dt) * k2 * self._lam_slow_force(
                frc_new.f_lam, lam, pH) * inv_ml

        if use_nhc:
            ke2 = 2.0 * kinetic_energy(v, mass)
            scale, nhc_xi = nhc_halfstep(nhc_xi, ke2, ndof, kT, cfg.tau, dt)
            # the thermostat's work on constraint-projected KE (the
            # projection is linear, so it commutes with the scale)
            ke2_p = ke2
            if self.constraints is not None:
                ke2_p = 2.0 * kinetic_energy(
                    self.constraints.velocities(x, v, state.box), mass)
            v = v * scale[:, None, None]
            ext_work = ext_work + 0.5 * ke2_p * (scale * scale - 1.0)
        if move_lam and cfg.lambda_thermostat == "nhc":
            ke2l = 2.0 * lambda_dyn.lambda_kinetic(v_lam, self.spec)
            scale_l, nhc_lam_xi = nhc_halfstep(
                nhc_lam_xi, ke2l, self.n_sites, kT, cfg.lambda_tau, dt)
            v_lam = v_lam * scale_l[:, None]
            ext_work = ext_work + 0.5 * ke2l * (scale_l * scale_l - 1.0)

        # RATTLE: project constraint-violating velocity components
        if self.constraints is not None:
            v = self.constraints.velocities(x, v, state.box)

        new_state = dataclasses.replace(
            state, x=x, v=v, lam=lam, v_lam=v_lam, step=state.step + 1,
            step_host=state.step_host + 1, nhc_xi=nhc_xi,
            nhc_lam_xi=nhc_lam_xi, ext_work=ext_work)
        return new_state, frc_new

    # -- run loop ---------------------------------------------------------

    def make_run(self, n_steps: int):
        """run(batch, nbrs, generators=None) → (batch, nbrs, obs (R, T,
        …)): blocks of ``rebuild_every`` steps (n_steps rounded up to
        whole blocks) of R replicas with one sequence of launches, replica
        r's noise from generators[r]. At a block start one list build for
        the batch; each replica takes the new list only where some of its
        atoms moved more than skin/2 (neighbors.needs_rebuild).
        run(state, nbr, generator=None) runs one state as a batch of one,
        obs (T, …), its noise from ``generator`` (default: the engine's).
        Nothing is read back to the host."""
        block = self.cfg.rebuild_every
        n_blocks = -(-n_steps // block)

        @profiling.spanned("cph.run")
        @state_batched
        def run(state: SystemState, nbr: NeighborList, generators=None):
            rows = []
            for _ in range(n_blocks):
                nbr = select(
                    needs_rebuild(nbr, state.x, state.box, self.nbr_params),
                    self.build_neighbors(state.x, state.box), nbr)
                frc = self.compute_forces(state.x, state.lam, state.box,
                                          state.pH, nbr)
                for _ in range(block):
                    state, frc = self.step(state, frc, nbr, generators)
                    rows.append(self.observe(state, frc))
            return state, nbr, Observables.stack(rows, dim=1)

        return run

    def run(self, state: SystemState, n_steps: int, nbr=None,
            generator=None):
        """Build the list (unless given) and run n_steps: one state with
        one generator, or a batch with one a replica."""
        if nbr is None:
            nbr = self.build_neighbors(state.x, state.box)
        return self.make_run(n_steps)(state, nbr, generator)

    # -- reference-parity diagnostics -------------------------------------

    def compute_Hs(self, state: SystemState, nbr, groupH_mask):
        """HA = Σ eatom over all atoms; HB = the same without the
        titratable-H group ((R,) each for a batch)."""
        frc = self.compute_forces(state.x, state.lam, state.box, state.pH,
                                  nbr)
        HA = torch.sum(frc.eatom, dim=-1)
        HB = torch.sum(torch.where(groupH_mask, 0.0, frc.eatom), dim=-1)
        return HA, HB
