"""pH replica exchange on the tiled and the reference engine (port of
constant_ph_tpu/parallel/replica.py).

Replicas are stacked states: every tensor field of a TiledState or
SystemState (and of a NeighborList) gains a leading replica axis R
(``stack_replicas``). The swap move, the health checks, the rollback and
the metadynamics hill merge work on that stack. On both engines the stack
is the engine's batch: one ``make_run`` call a block advances every
replica with one sequence of launches (the JAX package's ``jax.vmap``),
each replica drawing its Langevin noise from a ``torch.Generator`` of its
own that the runner holds. On the reference engine each replica keeps its
own neighbour list, all R built in one pass where rebuilt.

Swap move (even/odd alternating neighbour pairs, Metropolis): replicas
keep their configurations and exchange pH values. The Hamiltonian depends
on pH only through f(λ)·kT·ln10·(pK − pH) per site, so

    β·Δ = ln10 · (pH_i − pH_j) · (F_i − F_j),   F = Σ_sites f(λ_s)

and no energy is re-evaluated.

Over ranks (torch.distributed, parallel/comm.py), the batch is split into
contiguous slices in rank order (``split_replicas``): a rank runs its
slice as its engine's batch, each replica with the generator it has in the
one-process batch, and the swap is decided on the all-gathered (R,) λ and
pH with uniforms drawn from a generator that is the same on every rank;
each rank keeps its slice of the swapped pHs. A replica's trajectory is
then the one it has in the one-process batch.
"""
from __future__ import annotations

import dataclasses

import torch

from constant_ph_tpu_torch import (
    lambda_dyn,
    profiling,
    resolve_device,
    units,
)
from constant_ph_tpu_torch.batching import replica_of
from constant_ph_tpu_torch.engine import Observables
from constant_ph_tpu_torch.parallel import comm


def _tensor_fields(state):
    return [f.name for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)]


def stack_replicas(states: list):
    """Stack per-replica states (TiledState, SystemState or NeighborList)
    into one batch. Fields that are not tensors (the host step counter)
    must agree across replicas and stay as they are."""
    first = states[0]
    out = {}
    for f in dataclasses.fields(first):
        vals = [getattr(s, f.name) for s in states]
        if isinstance(vals[0], torch.Tensor):
            out[f.name] = torch.stack(vals)
        else:
            if any(v != vals[0] for v in vals):
                raise ValueError(f"replicas disagree on {f.name}: {vals}")
            out[f.name] = vals[0]
    return type(first)(**out)


def unstack_replicas(batch) -> list:
    """The inverse of stack_replicas: one state per replica (views into
    the batch)."""
    R = getattr(batch, _tensor_fields(batch)[0]).shape[0]
    return [replica_of(batch, r) for r in range(R)]


def _fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from (seed, data): splitmix64's finaliser over
    their combination (the port's analogue of jax.random.fold_in)."""
    m = (1 << 64) - 1
    x = (seed * 0x9E3779B97F4A7C15 + data + 1) & m
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


def replica_generators(seeds, device="cuda") -> list:
    """One torch.Generator per replica, seeded from ``seeds``."""
    dev = resolve_device(device)
    return [torch.Generator(device=dev).manual_seed(int(s)) for s in seeds]


def _swap(lam, pH, generator, bias, parity, u=None):
    """The swap sweep on (R, S) λ and (R,) pH: (new pH (R,), accepted
    (R,))."""
    R = pH.shape[0]
    dev = pH.device
    F = torch.sum(lambda_dyn.switching(lam, bias)[0], dim=1)   # (R,)
    idx = torch.arange(R, device=dev)
    partner = torch.where((idx - parity) % 2 == 0, idx + 1, idx - 1)
    partner = torch.clamp(partner, 0, R - 1)
    valid = (partner != idx) & ((partner - parity) >= 0) & (partner < R)
    # β·ΔH for the swap; accept with min(1, exp(−β·ΔH))
    beta_dH = units.LN10 * (pH - pH[partner]) * (F - F[partner])
    low = torch.minimum(idx, partner)
    if u is None:
        u = torch.rand((R,), generator=generator, dtype=pH.dtype, device=dev)
    accept = (u[low] < torch.exp(torch.clamp(-beta_dH, max=0.0))) & valid
    return torch.where(accept, pH[partner], pH), accept


@profiling.spanned("cph.rex.swap")
def swap_phs(states, generator, bias, parity, u=None, group=None):
    """One even/odd pH-swap sweep over the replica batch (leading axis R).

    parity 0 swaps pairs (0,1),(2,3),…; 1 swaps (1,2),(3,4),…. The
    Metropolis uniforms ``u`` (R,) are drawn from ``generator`` unless
    given (the JAX package draws jax.random.uniform(key, (R,))); each pair
    uses the uniform of its lower index. Returns (new_states,
    accepted_mask).

    With a process group ``group`` of more than one rank, ``states`` is
    this rank's slice of the batch (split_replicas): λ and pH of every
    rank are all-gathered (one call), the sweep runs on the whole (R,)
    batch with uniforms (R,) that ``generator`` draws alike on every rank,
    and the rank keeps its slice of the new pHs and of the accepted
    mask."""
    profiling.count("swaps")
    if comm.world(group) == 1:
        new_pH, accept = _swap(states.lam, states.pH, generator, bias,
                               parity, u)
        return dataclasses.replace(states, pH=new_pH), accept
    both = comm.all_gather(torch.cat([states.lam, states.pH[:, None]],
                                     dim=1), group)
    both = both.reshape(-1, both.shape[-1])
    new_pH, accept = _swap(both[:, :-1], both[:, -1], generator, bias,
                           parity, u)
    own = rank_slice(both.shape[0], group)
    return dataclasses.replace(states, pH=new_pH[own]), accept[own]


def rank_slice(R: int, group=None) -> slice:
    """The replicas of a batch of R that this rank runs: a contiguous
    slice in rank order; R % world != 0 is refused."""
    n, r = comm.world(group), comm.rank(group)
    if R % n:
        raise ValueError(f"{R} replicas do not split over {n} ranks")
    return slice(r * (R // n), (r + 1) * (R // n))


def split_replicas(batch, group=None):
    """This rank's slice (rank_slice) of a batch (contiguous copies; host
    fields as they are)."""
    R = getattr(batch, _tensor_fields(batch)[0]).shape[0]
    own = rank_slice(R, group)
    return dataclasses.replace(batch, **{
        n: getattr(batch, n)[own].contiguous()
        for n in _tensor_fields(batch)})


def _rank_generators(engine, R_local, device, group):
    """One generator per replica of this rank's slice, seeded from
    (engine seed, r) with r the replica's index in the whole batch."""
    own = rank_slice(R_local * comm.world(group), group)
    return replica_generators([_fold_in(engine.cfg.seed, r)
                               for r in range(own.start, own.stop)], device)


def make_rex_runner(engine, md_steps_per_swap: int, group=None):
    """Replica-exchange block on the reference engine:
    block(states, nbrs, generator, parity, u=None) → (states, nbrs,
    generator, accept, obs_last). ``states`` and ``nbrs`` are a batch
    (stack_replicas; every replica keeps its own neighbour list) and run
    as one: one ``make_run`` call a block. Replica r's noise comes from
    ``block.generators[r]``, made at the first call from (engine seed, r);
    ``generator`` draws the swap uniforms unless ``u`` (R,) gives them.
    Nothing is read back to the host. With a process group ``group``,
    ``states`` / ``nbrs`` are this rank's slice (split_replicas), replica
    r's generator is seeded from its index in the whole batch, and the
    swap runs over ranks (swap_phs)."""
    run = engine.make_run(md_steps_per_swap)

    def block(states, nbrs, generator, parity, u=None):
        if block.generators is None:
            block.generators = _rank_generators(
                engine, states.pH.shape[0], states.pH.device, group)
        states, nbrs, obs = run(states, nbrs, block.generators)  # (R, T, …)
        states, accepted = swap_phs(states, generator, engine.bias, parity,
                                    u=u, group=group)
        last_obs = Observables(**{
            f.name: getattr(obs, f.name)[:, -1]
            for f in dataclasses.fields(Observables)})
        return states, nbrs, generator, accepted, last_obs

    block.generators = None
    return block


def make_rex_runner_tiled(engine, md_steps_per_swap: int,
                          with_stats: bool = False, generators=None,
                          group=None):
    """Replica-exchange block on the tiled engine:
    block(states, generator, parity) → (states, generator, accept,
    obs_last), or with ``with_stats=True`` (states, generator, accept,
    overflow (R,), stats) where stats is {"obs_last": Observables with a
    leading R axis, "frac_deprot": (R, S) in-block mean of (λ > 0.5)}.

    ``generator`` draws the swap uniforms. Replica r's Langevin noise comes
    from ``block.generators[r]``: the list given, or one generator per
    replica made at the first call, seeded from (engine seed, r). Nothing
    is read back to the host. The R replicas run as one batch: one
    ``make_run`` call a block. With a process group ``group``, ``states``
    is this rank's slice (split_replicas), replica r's generator is seeded
    from its index in the whole batch, and the swap runs over ranks
    (swap_phs)."""
    run = engine.make_run(md_steps_per_swap)

    def block(states, generator, parity):
        if block.generators is None:
            block.generators = _rank_generators(
                engine, states.pH.shape[0], states.pH.device, group)
        states, overflow, obs = run(states, block.generators)  # (R, T, …)
        states, accepted = swap_phs(states, generator, engine.bias, parity,
                                    group=group)
        last_obs = Observables(**{
            f.name: getattr(obs, f.name)[:, -1]
            for f in dataclasses.fields(Observables)})
        if with_stats:
            frac = torch.mean((obs.lam > 0.5).to(torch.float32), dim=1)
            stats = {"obs_last": last_obs, "frac_deprot": frac}
            return states, generator, accepted, overflow, stats
        return states, generator, accepted, last_obs

    block.generators = generators
    return block


# -- per-replica failure detection -------------------------------------------
#
# One walker of a replica batch can blow up while the others stay healthy;
# the batch then rolls that replica back to its pre-chunk state and
# reseeds its generator, so the retry draws another trajectory.


def replica_finite(batch) -> torch.Tensor:
    """(R,) bool: every floating-point tensor of each replica is finite.
    One pass over the batch; the result stays on the device."""
    cols = []
    for name in _tensor_fields(batch):
        t = getattr(batch, name)
        if t.is_floating_point():
            cols.append(torch.isfinite(t).reshape(t.shape[0], -1).all(dim=1))
    return torch.stack(cols).all(dim=0)


def rollback_replicas(batch, prev, fin, salt: int, generators=None):
    """Restore the replicas where ``fin`` (replica_finite of ``batch``) is
    False to their pre-chunk state ``prev``; keep the healthy ones. With
    ``generators`` (one per replica) each failed replica's generator is
    reseeded from (its seed, 7919 + salt), the port's fold_in of the JAX
    package's key, so the retry does not replay the blow-up; finding the
    failed replicas then reads ``fin`` on the host."""
    def sel(new, old):
        m = fin.reshape(fin.shape + (1,) * (new.ndim - 1))
        return torch.where(m, new, old)

    merged = dataclasses.replace(batch, **{
        n: sel(getattr(batch, n), getattr(prev, n))
        for n in _tensor_fields(batch)})
    if generators is not None:
        for r in torch.nonzero(~fin).reshape(-1).tolist():
            g = generators[r]
            g.manual_seed(_fold_in(g.initial_seed(), 7919 + salt))
    return merged


def replica_healthy(batch, lam_min: float = -0.1, lam_max: float = 1.1,
                    v_lam_max: float = 0.5,
                    v_atom_max: float = 5.0) -> torch.Tensor:
    """(R,) bool: finite AND λ inside [lam_min, lam_max] AND |v_λ| ≤
    v_lam_max AND atom speeds ≤ v_atom_max Å/fs per component. A walker
    can be corrupt but finite (λ outside the walls, v_λ at 60× thermal);
    its statistics are lost all the same, so it rolls back like a NaN."""
    fin = replica_finite(batch)
    lam_ok = ((batch.lam >= lam_min) & (batch.lam <= lam_max)).all(dim=1)
    v_ok = (torch.abs(batch.v_lam) <= v_lam_max).all(dim=1)
    R = batch.lam.shape[0]
    wv_ok = (torch.abs(batch.wv.reshape(R, -1)) <= v_atom_max).all(dim=1)
    sv_ok = (torch.abs(batch.sv.reshape(R, -1)) <= v_atom_max).all(dim=1)
    return fin & lam_ok & v_ok & wv_ok & sv_ok
