"""The process-group layer of the port's multi-device paths
(torch.distributed). The JAX package gets its collectives from XLA over a
device mesh (``psum`` in shard_map, the collective permutes of the rolled
stencil); the port's distributed code goes through the few calls here:

- ``init`` / ``world`` / ``rank``: the group, from an explicit
  ``init_method`` (``file://`` under a temporary directory in the tests,
  so concurrent test processes never compete for a TCP port;
  ``tcp://localhost:<port>`` works as well);
- ``all_reduce_sum``, ``all_gather``: the MPI_Allreduce / Allgather of
  the reference (fix_constant_pH.cpp:274);
- ``halo_exchange``: one ghost layer to each neighbour of a periodic ring
  of ranks (the ghost exchange of fix_constant_pH.cpp:287-308).

How a tensor travels is chosen by the group's backend, in one place
(``_via_host``): with ``nccl``, and with ``gloo`` for CPU tensors, the
collective takes the tensor itself; with ``gloo`` and a CUDA tensor (two
processes sharing one card, where NCCL refuses two ranks on one device)
the tensor is copied into a pinned host buffer, the collective runs on
that buffer, and the result is copied back. Without an initialised
process group every call acts on one rank: the reductions return their
input, ``all_gather`` a batch of one, the halo the rank's own layers.

``STATS`` counts, per call kind, the calls, the bytes this rank handed to
the collective and the point-to-point messages it sent; the tests and
chip_smoke.py read and reset it (``reset_stats``)."""
from __future__ import annotations

import torch
import torch.distributed as dist

STATS = {}


def reset_stats():
    """Zero every counter of ``STATS``."""
    for k in ("all_reduce", "all_gather", "halo_exchange"):
        STATS[k] = {"calls": 0, "bytes": 0, "sends": 0}


reset_stats()


def _count(kind, t, sends=0):
    s = STATS[kind]
    s["calls"] += 1
    s["bytes"] += t.numel() * t.element_size()
    s["sends"] += sends


def init(init_method: str, world_size: int, rank_: int,
         backend: str = "gloo"):
    """Join the default process group of ``world_size`` ranks as rank
    ``rank_`` and return it. Every rank calls this with the same
    ``init_method`` and ``backend`` ("gloo" on the CPU and for several
    processes sharing one card; "nccl" for one process a card)."""
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank_)
    return dist.group.WORLD


def close():
    """Leave the default process group, if one is initialised."""
    if dist.is_initialized():
        dist.destroy_process_group()


def active() -> bool:
    """Whether a process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def world(group=None) -> int:
    """Ranks in ``group`` (None: the default group); 1 without one."""
    return dist.get_world_size(group) if active() else 1


def rank(group=None) -> int:
    """This process's rank in ``group``; 0 without a process group."""
    return dist.get_rank(group) if active() else 0


def _global(group, r):
    return r if group is None else dist.get_global_rank(group, r)


def _via_host(t, group) -> bool:
    """gloo has no collectives on CUDA tensors that this module relies
    on: such a tensor goes through a pinned host buffer."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t):
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def all_reduce_sum(t, group=None):
    """The elementwise sum of ``t`` over the ranks, returned as a new
    tensor on t's device; every rank gets the same bits."""
    _count("all_reduce", t)
    out = t.clone()
    if not active():
        return out
    if _via_host(out, group):
        h = _host(out)
        dist.all_reduce(h, group=group)
        out.copy_(h)
    else:
        dist.all_reduce(out, group=group)
    return out


def all_gather(t, group=None):
    """The ranks' ``t`` (equal shapes) stacked in rank order along a new
    leading axis: (world, *t.shape) on t's device."""
    _count("all_gather", t)
    t = t.contiguous()
    if not active():
        return t[None].clone()
    n = world(group)
    src = _host(t) if _via_host(t, group) else t
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(t.device)


def halo_exchange(first, last, group=None):
    """One ghost layer to each side on a periodic ring of ranks: this
    rank sends ``first`` (its first layer) to rank − 1 and ``last`` to
    rank + 1, and returns (ghost below, ghost above): rank − 1's ``last``
    and rank + 1's ``first``. On one rank the ring closes on itself:
    (last, first). Two messages a call at two ranks and more; the sends
    and receives are posted in one fixed order with tags, so a backend
    that matches messages by order alone pairs them the same way."""
    n = world(group)
    _count("halo_exchange", first, sends=2 if n > 1 else 0)
    STATS["halo_exchange"]["bytes"] += last.numel() * last.element_size()
    if n == 1:
        return last.clone(), first.clone()
    r = rank(group)
    below, above = _global(group, (r - 1) % n), _global(group, (r + 1) % n)
    host = _via_host(first, group)
    send_first = _host(first) if host else first.contiguous()
    send_last = _host(last) if host else last.contiguous()
    recv_below = torch.empty_like(send_last)
    recv_above = torch.empty_like(send_first)
    reqs = [dist.isend(send_last, above, group=group, tag=1),
            dist.isend(send_first, below, group=group, tag=0),
            dist.irecv(recv_below, below, group=group, tag=1),
            dist.irecv(recv_above, above, group=group, tag=0)]
    for q in reqs:
        q.wait()
    return recv_below.to(first.device), recv_above.to(first.device)


def _to_host(obj):
    """A child's result made safe to pickle across processes: tensors
    become numpy arrays (on the host), containers are walked."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _child(fn, r, n, init_method, backend, threads, args, queue):
    import traceback

    torch.set_num_threads(threads)
    try:
        init(init_method, n, r, backend)
        try:
            out = _to_host(fn(r, n, *args))
        finally:
            close()
        queue.put((r, True, out))
    except BaseException:                       # reported to the parent
        queue.put((r, False, traceback.format_exc()))
        raise


def run_ranks(fn, n, args=(), *, backend="gloo", init_dir=None, threads=1,
              timeout=1800.0):
    """Run fn(rank, n, *args) in n spawned processes joined into one
    process group (``backend``, a ``file://`` rendezvous in ``init_dir``,
    a new temporary directory by default) and return the ranks' results
    in rank order, tensors as numpy arrays. ``fn`` must be importable by
    name (a module-level function) and the child imports what its module
    imports. Raises if any rank fails, with its traceback; every process
    is joined (or killed past ``timeout`` seconds) before this returns."""
    import os
    import queue as queue_mod
    import shutil
    import tempfile
    import time

    import torch.multiprocessing as mp

    own_dir = init_dir is None
    d = tempfile.mkdtemp(prefix="ranks_") if own_dir else str(init_dir)
    init_method = "file://" + os.path.join(d, "rendezvous")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(fn, r, n, init_method,
                                              backend, threads, args, q))
             for r in range(n)]
    results, errors = {}, {}
    try:
        for p in procs:
            p.start()
        t_end = time.monotonic() + timeout
        while len(results) + len(errors) < n:
            try:
                r, ok, payload = q.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if (dead and len(results) + len(errors) < n
                        and all(p.exitcode is not None for p in procs)):
                    break
                if time.monotonic() > t_end:
                    raise TimeoutError(f"ranks did not finish in {timeout} s")
                continue
            (results if ok else errors)[r] = payload
    finally:
        for p in procs:
            if p.pid is None:                   # never started
                continue
            p.join(timeout=30.0)
            if p.is_alive():
                p.kill()
                p.join()
        if own_dir:
            shutil.rmtree(d, ignore_errors=True)
    if errors or len(results) < n:
        msg = "\n".join(f"rank {r}:\n{tb}" for r, tb in sorted(errors.items()))
        codes = [p.exitcode for p in procs]
        raise RuntimeError(f"{n - len(results)} of {n} ranks failed "
                           f"(exit codes {codes})\n{msg}")
    return [results[r] for r in range(n)]
