"""Cell list → padded (N, K) neighbour lists (port of
constant_ph_tpu/neighbors.py).

Fixed shapes everywhere: atoms are binned into a static cell grid with a
fixed capacity, candidates come from a static stencil of cells, and the K
nearest candidates inside rc + skin are kept per atom, with an overflow
flag instead of reallocation. Rebuild policy is the skin trigger: rebuild
when any atom has moved more than skin/2 since the list was built
(``needs_rebuild``, a device-side bool).

Sizing (``make_neighbor_params``) is host numpy, the JAX package's
arithmetic. The build is plain torch ops on the list's device and never
reads a device value on the host. The cell table comes from a stable
argsort and searchsorted, as in the JAX package; where a cell overflows,
several atoms write its last slot (on CUDA the winner is arbitrary) and the
overflow flag is set. ``torch.topk`` may order equal distances otherwise
than ``jax.lax.top_k``: each row holds the same neighbours, not
necessarily in the same order.

A batch of R replicas (x (R, N, 3), box (R, 3); the JAX package's
``jax.vmap``) is built in one pass: one stable argsort over all R·N cell
keys, replica r's offset by r·G, an (R·G, C) cell table, (R, N, S·C)
candidates and one ``topk``; each replica's list is bitwise its own
build's. The list's fields then lead with R and ``overflow``,
``max_displacement2`` and ``needs_rebuild`` are (R,). One replica is
built as a batch of one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from constant_ph_tpu_torch.batching import PerReplica, replica_of
from constant_ph_tpu_torch.state import min_image, wrap


@dataclasses.dataclass(frozen=True)
class NeighborParams:
    """Static sizing of the neighbour structure (host-side decisions)."""

    cutoff: float          # rc + skin, Å
    skin: float
    capacity: int          # K neighbours an atom
    grid: tuple            # cells a dimension
    cell_capacity: int     # C atoms a cell
    stencil: tuple         # cell offsets (ox, oy, oz)
    use_cells: bool = True


@dataclasses.dataclass
class NeighborList(PerReplica):
    """One replica's shapes; a batch leads every field with R."""

    _probe = ("idx", 2)

    idx: torch.Tensor       # (N, K) int64 neighbour ids, padded with N
    code: torch.Tensor      # (N, K) int64 special-bond code 0..3
    x_ref: torch.Tensor     # (N, 3) positions at build time
    overflow: torch.Tensor  # () bool: list or cell capacity exceeded

    @property
    def capacity(self) -> int:
        return self.idx.shape[-1]


def make_neighbor_params(box, cutoff: float, *, n_atoms: int,
                         skin: float = 2.0, capacity: int | None = None,
                         safety: float = 1.35,
                         target_cells_per_cutoff: int = 1,
                         use_cells: bool | None = None) -> NeighborParams:
    """Host-side sizing: grid, per-cell and per-atom capacities.

    ``capacity`` defaults to safety × the expected neighbours in the
    (rc + skin) sphere at the system's mean density, rounded up to a
    multiple of 128 (8 for small lists) and capped at n_atoms."""
    box = np.asarray(box, dtype=np.float64)
    if cutoff > float(box.min()) / 2.0 + 1e-9:
        raise ValueError(
            f"pair cutoff {cutoff} exceeds half the smallest box length "
            f"({box.min() / 2:.3f}); minimum-image convention would be violated"
        )
    rc = cutoff + skin
    density = n_atoms / float(np.prod(box))
    if use_cells is None:
        use_cells = n_atoms > 512

    cell_target = rc / max(1, target_cells_per_cutoff)
    grid = tuple(int(max(1, np.floor(b / cell_target))) for b in box)
    cell_size = box / np.maximum(np.array(grid), 1)
    reach = tuple(int(np.ceil(rc / cs)) if g > 1 else 0
                  for cs, g in zip(cell_size, grid))
    offsets = tuple((ox, oy, oz)
                    for ox in range(-reach[0], reach[0] + 1)
                    for oy in range(-reach[1], reach[1] + 1)
                    for oz in range(-reach[2], reach[2] + 1))
    cell_vol = float(np.prod(cell_size))
    cell_cap = int(np.ceil(density * cell_vol * (safety + 0.35))) + 4
    cell_cap = max(8, -(-cell_cap // 8) * 8)

    if capacity is None:
        nsphere = density * 4.0 / 3.0 * np.pi * rc**3
        capacity = int(np.ceil(nsphere * safety)) + 8
    mult = 128 if capacity > 128 else 8
    capacity = min(-(-capacity // mult) * mult, n_atoms)

    return NeighborParams(cutoff=float(rc), skin=float(skin),
                          capacity=int(capacity), grid=grid,
                          cell_capacity=int(cell_cap), stencil=offsets,
                          use_cells=bool(use_cells))


def _special_codes(idx, excl_idx, excl_code):
    """Each neighbour's special-bond code, by matching the per-atom
    exclusion table (N, KE) one column at a time (no (N, K, KE) array)."""
    code = torch.zeros_like(idx)
    for e in range(excl_idx.shape[1]):
        code = code + (idx == excl_idx[:, e:e + 1]) * excl_code[:, e:e + 1]
    return code


def take_rows(a, j):
    """a (…, N) at ids j (…, N, M): one gather, (…, N, M) (the batched
    form of a[j])."""
    return torch.gather(a, -1, j.flatten(-2)).view(j.shape)


def _finalize(x, box, cand, params: NeighborParams, excl_idx, excl_code,
              extra_overflow) -> NeighborList:
    """Candidate ids (R, N, M) → the K nearest inside rc + skin, padded
    with N. Distances are built one coordinate at a time on (R, N, M)
    arrays."""
    n = x.shape[1]
    rc2 = params.cutoff * params.cutoff
    cc = torch.clamp(cand, max=n - 1)
    r2 = None
    for d in range(3):
        xd = x[..., d]
        dxd = min_image(xd[..., None] - take_rows(xd, cc),
                        box[:, d, None, None])
        r2 = dxd * dxd if r2 is None else r2 + dxd * dxd
    del cc
    self_ids = torch.arange(n, device=x.device)[:, None]
    valid = (cand < n) & (cand != self_ids) & (r2 < rc2)
    r2k = torch.where(valid, r2, torch.inf)
    del r2
    neg, sel = torch.topk(-r2k, params.capacity, dim=-1)
    idx = torch.gather(cand, -1, sel)
    idx = torch.where(torch.isfinite(neg), idx, n)
    overflow = torch.any(valid.sum(dim=-1) > params.capacity,
                         dim=-1) | extra_overflow
    code = _special_codes(idx, excl_idx, excl_code)
    return NeighborList(idx=idx, code=code, x_ref=x, overflow=overflow)


def stencil_offsets(params: NeighborParams, device) -> torch.Tensor:
    """(S, 3) int64 cell offsets of the stencil on ``device``. A host to
    device copy: make it once, outside any run loop."""
    return torch.tensor(params.stencil, dtype=torch.int64, device=device)


def build_neighbor_list(x, box, params: NeighborParams, excl_idx,
                        excl_code, offsets=None) -> NeighborList:
    """The padded neighbour list of positions ``x`` (N, 3) in ``box``
    (3,), or the lists of a batch, x (R, N, 3) and box (R, 3), in one pass
    (excl_idx / excl_code: (N, KE) int64 tensors on x's device, shared by
    the replicas). ``offsets`` is stencil_offsets(params, x.device);
    without it the build copies the stencil to the device, which waits
    for the device."""
    if x.ndim == 2:
        return replica_of(build_neighbor_list(
            x[None], box[None], params, excl_idx, excl_code, offsets))
    R, n = x.shape[:2]
    dev = x.device
    if not params.use_cells:
        cand = torch.arange(n, device=dev).expand(R, n, n)
        return _finalize(x, box, cand, params, excl_idx, excl_code,
                         torch.zeros((R,), dtype=torch.bool, device=dev))

    gx, gy, gz = params.grid
    G = gx * gy * gz
    cap = params.cell_capacity
    if offsets is None:
        offsets = stencil_offsets(params, dev)
    # per-replica box lengths on the device, not a grid tensor: a host
    # copy would wait for the device
    xw = wrap(x, box[:, None, :])
    ci = [torch.clamp(torch.floor(xw[..., d] / (box[:, d, None] / g)).long(),
                      0, g - 1)
          for d, g in enumerate(params.grid)]                       # (R, N)
    cid = (ci[0] * gy + ci[1]) * gz + ci[2]
    # replica r's cells are keys r·G … r·G + G − 1: one sort keeps the
    # replicas apart, each in its own build's order
    rep = G * torch.arange(R, device=dev)[:, None]
    key = (cid + rep).reshape(-1)                                  # (R·N,)

    # bin: stable sort by key, rank within the cell, scatter into a
    # fixed-capacity table of local atom ids
    order = torch.argsort(key, stable=True)
    key_sorted = key[order]
    first_of_cell = torch.searchsorted(key_sorted, key_sorted, side="left")
    rank = torch.arange(R * n, device=dev) - first_of_cell
    # the sorted keys of replica r fill positions r·N … r·N + N − 1
    cell_overflow = torch.any((rank >= cap).reshape(R, n), dim=1)
    slot = torch.clamp(rank, max=cap - 1)
    table = torch.full((R * G * cap,), n, dtype=torch.int64, device=dev)
    table[key_sorted * cap + slot] = torch.remainder(order, n)
    table = table.reshape(R * G, cap)

    # gather the stencil cells of each atom
    nbr = [torch.remainder(ci[d][..., None] + offsets[:, d], g)
           for d, g in enumerate(params.grid)]                  # (R, N, S)
    nbr_cid = (nbr[0] * gy + nbr[1]) * gz + nbr[2] + rep[..., None]
    cand = table[nbr_cid].reshape(R, n, -1)                   # (R, N, S·C)
    return _finalize(x, box, cand, params, excl_idx, excl_code,
                     cell_overflow)


def max_displacement2(nbr: NeighborList, x, box):
    """The largest squared displacement of any atom since the build: ()
    for one list, (R,) for a batch."""
    dx = min_image(x - nbr.x_ref, box[..., None, :])
    return torch.amax(torch.sum(dx * dx, dim=-1), dim=-1)


def needs_rebuild(nbr: NeighborList, x, box, params: NeighborParams):
    """Some atom moved more than skin/2 since the build: a () bool, or
    (R,) for a batch."""
    return max_displacement2(nbr, x, box) > (0.5 * params.skin) ** 2


def select(pred, a: NeighborList, b: NeighborList) -> NeighborList:
    """Field by field a where the device bool ``pred`` holds, else b: the
    sync-free form of the JAX package's lax.cond between two lists. For a
    batch ``pred`` is (R,) and each replica keeps its own list unless its
    own trigger fired (``jax.vmap`` of the lax.cond): a list rebuilt for
    another replica's sake may order the same neighbours otherwise."""
    def pick(ta, tb):
        m = pred.reshape(pred.shape + (1,) * (ta.ndim - pred.ndim))
        return torch.where(m, ta, tb)

    return NeighborList(**{
        f.name: pick(getattr(a, f.name), getattr(b, f.name))
        for f in dataclasses.fields(NeighborList)})
