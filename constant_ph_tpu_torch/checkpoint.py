"""Checkpoint and exact resume (port of constant_ph_tpu/checkpoint.py).

The format is the JAX package's: a plain .npz of the SystemState's named
leaves. ``load`` reads the JAX package's checkpoints as they are; their
PRNG ``key`` leaf is read and dropped (the port's state has none), and a
missing field other than the append-after-save scalars of
``_SCALAR_FILL_FIELDS`` is refused, never zero-filled. ``save`` writes
the port's state plus a ``key`` leaf of shape (2,) uint32 (zeros), so the
JAX package's ``checkpoint.load`` takes the port's files (and draws its
own noise from that key).

The port's noise comes from a ``torch.Generator`` (tiled/engine.py), not
from the state, so exact resume needs the generator too: ``save(...,
generator=g)`` stores its state as the optional leaf ``torch_generator``
(uint8), and ``load(..., generator=g)`` restores it into ``g``. Save and
load then continue the trajectory bit for bit, Langevin noise included.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from constant_ph_tpu_torch import convert
from constant_ph_tpu_torch.state import SystemState

GENERATOR_LEAF = "torch_generator"


def _path(path) -> str:
    return str(path) if str(path).endswith(".npz") else str(path) + ".npz"


def save(path, state: SystemState, generator: torch.Generator = None):
    """Write ``state`` (and the state of ``generator``, when given) to
    ``path`` (.npz added when missing, as numpy does)."""
    leaves = {f.name: getattr(state, f.name).detach().cpu().numpy()
              for f in dataclasses.fields(state)
              if isinstance(getattr(state, f.name), torch.Tensor)}
    leaves["key"] = np.zeros((2,), np.uint32)
    if generator is not None:
        leaves[GENERATOR_LEAF] = generator.get_state().numpy()
    np.savez(_path(path), **leaves)


def load(path, device="cuda", generator: torch.Generator = None
         ) -> SystemState:
    """The SystemState stored at ``path``, on ``device`` (float32, as
    every state of the port). With ``generator``, its state is restored
    from the file; a file without one (every JAX checkpoint) raises, since
    the resume could not be exact."""
    with np.load(_path(path)) as data:
        leaves = {k: data[k] for k in data.files}
    if generator is not None:
        if GENERATOR_LEAF not in leaves:
            raise KeyError(f"checkpoint {path} holds no generator state "
                           f"('{GENERATOR_LEAF}'); resume with a fresh "
                           "generator instead")
        generator.set_state(torch.as_tensor(leaves[GENERATOR_LEAF]))
    try:
        return convert.system_state(leaves, device=device)
    except KeyError as err:
        raise KeyError(f"checkpoint {path}: {err.args[0]}") from None
