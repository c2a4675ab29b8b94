"""Replicas as a leading batch axis.

The tiled engine and the functions under it are written for a batch: every
per-replica tensor carries a leading replica axis R (a batch is what
parallel.replica.stack_replicas makes), so one sequence of launches moves
all R walkers, as ``jax.vmap`` does in the JAX package. A single replica
runs through the same code as a batch of one: it is unsqueezed at entry
and squeezed at exit.
"""
from __future__ import annotations

import dataclasses
import functools

import torch


class PerReplica:
    """Marks a dataclass whose tensor fields all lead with the replica axis
    in a batch (TiledState, TiledForces)."""


def _lift(a):
    """One replica's argument → a batch of one's."""
    if isinstance(a, PerReplica):
        return batch_of_one(a)
    if isinstance(a, torch.Tensor):
        return a[None]
    if isinstance(a, torch.Generator):
        return [a]
    return a


def _squeeze(out):
    """A batch of one's result → one replica's."""
    if isinstance(out, torch.Tensor):
        return out[0]
    if dataclasses.is_dataclass(out):
        return replica_of(out)
    if isinstance(out, (tuple, list)):
        return type(out)(_squeeze(o) for o in out)
    return out


def state_batched(fn):
    """Decorator for a function or method written for a batch whose first
    per-replica dataclass argument is a TiledState. A call with one state
    (``wx`` without the replica axis) runs as a batch of one: each
    per-replica dataclass and tensor argument gains a leading axis of 1, a
    torch.Generator becomes a list of one, and each tensor of the result
    (dataclass fields included) loses the axis again."""
    @functools.wraps(fn)
    def wrapper(*args, **kw):
        st = next(a for a in args if isinstance(a, PerReplica))
        if st.wx.ndim != 3:
            return fn(*args, **kw)
        return _squeeze(fn(*map(_lift, args),
                           **{k: _lift(v) for k, v in kw.items()}))
    return wrapper


def replica_batched(core_ndim: int):
    """Decorator for a function written over a leading replica axis on
    every tensor argument (positional or keyword; the static tables are
    not tensors). A call whose first argument has ``core_ndim`` dims is
    one replica: each tensor argument is unsqueezed to a batch of one and
    each tensor of the result squeezed back."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(x, *args, **kw):
            if x.ndim == core_ndim + 1:
                return fn(x, *args, **kw)
            if x.ndim != core_ndim:
                raise ValueError(
                    f"{fn.__name__}: first argument has {x.ndim} dims; "
                    f"one replica has {core_ndim}, a batch {core_ndim + 1}")
            args = [a[None] if isinstance(a, torch.Tensor) else a
                    for a in args]
            kw = {k: v[None] if isinstance(v, torch.Tensor) else v
                  for k, v in kw.items()}
            return _squeeze(fn(x[None], *args, **kw))
        return wrapper
    return deco


def batch_of_one(obj):
    """A dataclass of one replica's tensors → a batch of one (views)."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name)[None] for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


def replica_of(batch, r: int = 0):
    """Replica r of a batch (views); the inverse of batch_of_one."""
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name)[r] for f in dataclasses.fields(batch)
        if isinstance(getattr(batch, f.name), torch.Tensor)})


def bview(t, ndim: int):
    """A per-replica (R,) tensor shaped (R, 1, …, 1) with ``ndim`` dims in
    all, to broadcast against per-replica arrays; a Python number is
    returned as it is."""
    if not isinstance(t, torch.Tensor):
        return t
    return t.reshape(t.shape[:1] + (1,) * (ndim - 1))
