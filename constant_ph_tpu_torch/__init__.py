"""constant_ph_tpu_torch — the PyTorch/CUDA port of constant_ph_tpu.

Constant-pH λ-dynamics MD on the tiled cell-stencil hot path, run on an
NVIDIA GPU. Module names mirror the JAX package (`constant_ph_tpu`), which
stays the reference the port is tested against (tests/test_torch_*.py).

This slice carries the damped-shifted-force (DSF) main path: build
(`systems.water.solvated_acid`), lay out (`tiled.layout.split_system`,
`to_tiled`), and run (`tiled.engine.TiledEngine.make_minimize`,
`make_run`). The water-water pair block runs as a hand-written CUDA
kernel (`csrc/ww_pair.cu`) on CUDA tensors and as its plain PyTorch
version on CPU tensors.

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
