"""Spatial x-slab decomposition of the tiled engine over ranks (port of
constant_ph_tpu/parallel/spatial.py; SURVEY.md §2.4, §5.8).

The (3, G, 3W) water tiles have G linearised gx-major, so a contiguous
slice of G along whole x-layers is an x-slab. Rank r of n owns the layers
[r·gx/n, (r+1)·gx/n) of every replica (``shard_tiled_state``); the solute,
box, λ, pH, metadynamics tables and scalars stay replicated. In the JAX
package XLA writes the halo exchange itself (the rolled stencil's shifts
across shards become collective permutes); here the engine
(tiled/engine.py, ``TiledEngine(spatial=group)``) does it explicitly:

- one halo exchange a force evaluation (``halo``): each rank sends its
  first x-layer of coordinates and validity to rank − 1 and its last to
  rank + 1, and K1 / K2 run their slab entries on the owned layers
  between the two ghost layers. Both sum every pair on the i side, so
  nothing is sent back for water-water;
- one all-reduce of the water-derived energies, the solute's forces and
  φ from water (and through them dU/dλ), one of the PME mesh or of the
  water's Ewald structure factor, one of the water kinetic energy where
  a temperature or a thermostat's work needs it; solute-solute and
  bonded terms run on the replicated solute on every rank, outside the
  sums;
- one all-gather of the tiles a ``rebuild_every`` block (``rebin_slab``):
  every rank rebins the whole grid identically (layout.rebin) and keeps
  its slab; the tiles are never gathered inside a block, except below 3
  cells a dimension: there the plain tally path (tiled.forces.water_water)
  needs the whole grid for its minimum image, so a force evaluation
  gathers the coordinates and validity once (``gather_cells``), every
  rank computes the water terms of the whole grid and keeps its own rows
  (tiled.layout.make_tile_params gives such boxes one cell, which only
  one rank divides; a grid of 2 comes from TileParams made by hand);
- Langevin noise drawn for the whole tile array from generators that are
  the same on every rank, each rank keeping its slab (``slab_randn``):
  the replicated solute and λ advance bitwise alike on every rank, and a
  slab run follows the single-process run.

Every TiledEngine path runs on slabs: the run loop, FIRE (its water sums
in one all-reduce a step), the MC barostat and the pressure
(tiled/npt.py: molecule counts summed, the accept decision's inputs
broadcast from rank 0), the elastic drivers (a retile gathers the tiles,
retiles the whole grid on every rank alike and shards again;
``gather_state`` gives an ``on_chunk`` writer the whole grid), and PME
or factorized Ewald k-space (the water's mesh or structure factor summed
over the ranks). Requirements: an initialised process group and a grid
x dimension that the ranks divide.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from constant_ph_tpu_torch.batching import state_batched
from constant_ph_tpu_torch.integrators import replica_randn
from constant_ph_tpu_torch.parallel import comm
from constant_ph_tpu_torch.tiled.layout import TiledState, TileParams, rebin


@dataclasses.dataclass(frozen=True)
class Slab:
    """A rank's x-slab of the cell grid."""

    group: object        # the process group (None: the default group)
    world: int
    x_first: int         # global x index of the first owned layer
    n: int               # owned x-layers
    cells: slice         # the owned range of the G axis (gx-major)


def make_spatial_mesh(n_ranks: int):
    """The process group of the first ``n_ranks`` ranks (the default
    group when that is all of them) for a slab decomposition. Needs an
    initialised process group (parallel.comm.init); every rank calls it."""
    if not comm.active():
        raise RuntimeError("make_spatial_mesh needs an initialised process "
                           "group (parallel.comm.init)")
    if n_ranks == comm.world():
        return dist.group.WORLD
    if not 1 <= n_ranks < comm.world():
        raise ValueError(f"{n_ranks} ranks of {comm.world()}")
    return dist.new_group(list(range(n_ranks)))


def slab_of(group, params: TileParams) -> Slab:
    """This rank's slab of ``params.grid`` over ``group``; a grid x
    dimension that the ranks do not divide is refused, as the JAX package
    refuses it."""
    n, r = comm.world(group), comm.rank(group)
    gx, gy, gz = params.grid
    if gx % n:
        raise ValueError(f"grid x dimension {gx} not divisible by the "
                         f"{n} ranks")
    k = gx // n
    return Slab(group=group, world=n, x_first=r * k, n=k,
                cells=slice(r * k * gy * gz, (r + 1) * k * gy * gz))


def _cell_axis(name):
    return 2 if name in ("wx", "wv") else 1


def shard_tiled_state(tstate: TiledState, group,
                      params: TileParams) -> TiledState:
    """This rank's x-slab of a state (or batch): the (3, G, 3W) water
    tiles and the (G, W) cell arrays sliced to the owned cells (copies);
    every other field stays replicated as it is."""
    sl = slab_of(group, params)
    batch = tstate.is_batch()
    return dataclasses.replace(tstate, **{
        k: getattr(tstate, k).narrow(
            _cell_axis(k) - (0 if batch else 1), sl.cells.start,
            sl.cells.stop - sl.cells.start).contiguous()
        for k in ("wx", "wv", "wvalid", "wid")})


def gather_cells(parts, slab: Slab):
    """The whole grid of each (R, …) tensor of a batch's slab, gathered
    from every rank in one all-gather: ``parts`` holds (tensor, cell axis)
    pairs, the cell axis the one that runs over the owned cells (G, or x
    in grid shape); each comes back with the ranks' cells in rank order
    along that axis. Tensors of 4-byte types travel as float32 bits."""
    R = parts[0][0].shape[0]
    flat = torch.cat([t.contiguous().view(torch.float32).reshape(R, -1)
                      for t, _ in parts], dim=1)
    got = comm.all_gather(flat, slab.group)               # (n, R, k)
    out, at = [], 0
    for t, axis in parts:
        k = t[0].numel()
        loc = got[:, :, at:at + k].reshape((slab.world,) + tuple(t.shape))
        out.append(torch.cat(list(loc), dim=axis).view(t.dtype))
        at += k
    return out


@state_batched
def gather_tiles(st: TiledState, slab: Slab, params: TileParams):
    """The whole grid's tiles of a state (or batch) on a slab, gathered
    from every rank in one all-gather: the state with (3, G, 3W) / (G, W)
    tiles (every other field as it is)."""
    names = ("wx", "wv", "wvalid", "wid")
    whole = gather_cells([(getattr(st, k), _cell_axis(k)) for k in names],
                         slab)
    assert whole[0].shape[2] == params.G
    return dataclasses.replace(st, **dict(zip(names, whole)))


def gather_state(st: TiledState, group, params: TileParams) -> TiledState:
    """The inverse of ``shard_tiled_state``: the whole grid's state (or
    batch) on every rank of ``group``, from each rank's slab, in one
    all-gather. Every rank calls it; checkpoint and trajectory writers
    take its result (an elastic run's ``on_chunk`` sees the rank's slab)."""
    return gather_tiles(st, slab_of(group, params), params)


@state_batched
def rebin_slab(st: TiledState, slab: Slab, params: TileParams):
    """layout.rebin of a state or batch on slabs: one all-gather of the
    tiles, the whole grid rebinned on every rank alike, the rank's slab
    kept. Returns (state, overflow), the flag every rank's alike."""
    full, overflow = rebin(gather_tiles(st, slab, params), params)
    return dataclasses.replace(full, **{
        k: getattr(full, k).narrow(_cell_axis(k), slab.cells.start,
                                   slab.cells.stop - slab.cells.start)
        .contiguous()
        for k in ("wx", "wv", "wvalid", "wid")}), overflow


def halo(wxg, wvg, slab: Slab):
    """The tiles of a batch's owned x-layers with one ghost layer on each
    side: wxg (R, 3, n, gy, gz, A) and wvg (R, n, gy, gz, W) →
    (R, 3, n + 2, gy, gz, A) and (R, n + 2, gy, gz, W), the ghosts raw
    coordinates and validity as the neighbouring ranks hold them. One
    halo exchange: each rank's first layer to rank − 1, its last to
    rank + 1, coordinates and validity in one message each way."""
    R = wxg.shape[0]
    nx = wxg[:, :, 0].numel() // R

    def layer(i):
        return torch.cat([wxg[:, :, i].reshape(R, -1),
                          wvg[:, i].reshape(R, -1)], dim=1)

    below, above = comm.halo_exchange(layer(0), layer(-1), slab.group)

    def unpack(buf):
        return (buf[:, :nx].reshape(wxg[:, :, :1].shape),
                buf[:, nx:].reshape(wvg[:, :1].shape))

    (xb, vb), (xa, va) = unpack(below), unpack(above)
    return (torch.cat([xb, wxg, xa], dim=2).contiguous(),
            torch.cat([vb, wvg, va], dim=1).contiguous())


def slab_randn(like, generators, slab: Slab, G: int):
    """Standard normal noise for a batch's owned water tiles ``like`` (R,
    3, G_own, A): drawn for the whole (R, 3, G, A) array from each
    replica's generator (the numbers of a single-process run) and sliced
    to the slab."""
    R, _, _, A = like.shape
    full = replica_randn(like.new_empty((R, 3, G, A)), generators)
    return full[:, :, slab.cells].contiguous()
