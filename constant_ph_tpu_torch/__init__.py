"""constant_ph_tpu_torch — the PyTorch/CUDA port of constant_ph_tpu.

Constant-pH λ-dynamics MD on the tiled cell-stencil hot path, run on an
NVIDIA GPU. Module names mirror the JAX package (`constant_ph_tpu`), which
stays the reference the port is tested against (tests/test_torch_*.py).

The port carries the main path: build (`systems.water.solvated_acid`),
lay out (`tiled.layout.split_system`, `to_tiled`), and run
(`tiled.engine.TiledEngine.make_minimize`, `make_run`) with
damped-shifted-force Coulomb or smooth PME (`ops.pme`, under impulse
MTS), plus the per-atom tally path (`compute_Hs`). The water-water pair
blocks run as hand-written CUDA kernels on CUDA tensors — the hot path
(`csrc/ww_pair.cu`) and the full-tally block (`csrc/ww_tally.cu`) — and
as their plain PyTorch versions on CPU tensors. The reference engine
(`engine.Engine` on padded neighbour lists, `ops.pair`, factorized Ewald
in `ops.ewald`, FIRE in `minimize`) is the oracle the tiled path is held
to.

Entry points take ``device`` (default ``"cuda"``); asking for CUDA on a
machine without it raises instead of falling back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device for ``device``; raises if CUDA is asked for but
    absent (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev
