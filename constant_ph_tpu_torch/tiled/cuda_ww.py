"""Build, load and launch the CUDA water-water kernel (csrc/ww_pair.cu).

The kernel replaces the TPU kernel constant_ph_tpu/tiled/pallas_ww.py
``_chunk_pair_kernel``; see the note at the top of the source for its
design and bound. It is compiled with nvcc for sm_90a into a shared
library with a plain C interface, at first use, under
``constant_ph_tpu_torch/_build/`` (named by a hash of the source), and
loaded with ctypes. Nothing here touches CUDA when the module is
imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import torch

from constant_ph_tpu_torch import units

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "ww_pair.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "$CUDA_HOME/bin); the CUDA kernel cannot be built")
    return path


def build() -> tuple[str, str]:
    """Compile the kernel library if it is not built yet. Returns (path
    of the .so, nvcc's messages — empty when it was already built)."""
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(
            fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"ww_pair_{digest}.so")
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{r.stdout}{r.stderr}")
    os.replace(tmp, path)
    return path, r.stdout + r.stderr


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()[0])
    lib.ww_pair_param_count.restype = ctypes.c_int
    lib.ww_pair_param_count.argtypes = []
    lib.ww_pair_scratch_floats.restype = ctypes.c_int
    lib.ww_pair_scratch_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ww_pair_forward.restype = ctypes.c_int
    lib.ww_pair_forward.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    if lib.ww_pair_param_count() != len(_PARAM_ORDER):
        raise RuntimeError("ww_pair.cu parameter layout does not match "
                           "cuda_ww._PARAM_ORDER")
    return lib


# host parameter array layout; the enum P_* in ww_pair.cu mirrors it
_PARAM_ORDER = ([f"c1_{k}" for k in range(11)] + [f"c2_{k}" for k in range(11)]
                + ["kOO", "kOH", "kHH", "c6", "c12", "esh", "c6x6",
                   "c12x12", "rc", "rc2", "two_over_rc", "e_sh", "f_sh"])


def _params(wm, style, alpha, rc):
    # python-float (float64) products rounded once to float32, as the
    # plain version's scalar constants are
    from constant_ph_tpu_torch.tiled.forces import coulomb_constants

    e_sh, f_sh, c_g1, c_g2 = coulomb_constants(style, alpha, rc)
    qO, qH = wm.q_pattern[0], wm.q_pattern[1]
    vals = (list(c_g1) + list(c_g2)
            + [units.QQR2E * qO * qO, units.QQR2E * qO * qH,
               units.QQR2E * qH * qH, wm.c6_OO, wm.c12_OO, wm.eshift_OO,
               6.0 * wm.c6_OO, 12.0 * wm.c12_OO, rc, rc * rc, 2.0 / rc,
               e_sh, f_sh])
    return (ctypes.c_float * len(vals))(*vals)


def water_water_cuda(wxg, wm, p, box, *, style, alpha, rc):
    """The water-water block on the GPU: (e_lj, e_coul, f) with f shaped
    like wxg (3, gx, gy, gz, 3W), as tiled.forces.water_water_fast_plain.
    Launches on the current stream without synchronising."""
    gx, gy, gz = p.grid
    G, A = p.G, 3 * p.W
    if min(p.grid) < 3:
        raise ValueError("the CUDA water-water kernel needs grid >= 3 per "
                         "dim (the stencil would alias)")
    if style not in ("dsf", "cut"):
        raise ValueError(f"unknown coulomb style {style!r}")
    if not (wxg.is_cuda and wxg.dtype == torch.float32
            and wxg.is_contiguous() and wxg.numel() == 3 * G * A
            and wxg.shape[0] == 3 and wxg.shape[-1] == A):
        raise ValueError("wxg must be a contiguous float32 CUDA tensor of "
                         f"shape (3, {gx}, {gy}, {gz}, {A})")
    if not (box.is_cuda and box.dtype == torch.float32
            and box.is_contiguous() and tuple(box.shape) == (3,)):
        raise ValueError("box must be a contiguous float32 CUDA tensor (3,)")
    if 3 * A * 4 > 48 * 1024 or G > 65535:
        raise ValueError(f"tile too large for the kernel (A={A}, G={G})")
    lib = _lib()
    dev = wxg.device
    f = torch.empty_like(wxg)
    e_part = torch.empty(lib.ww_pair_scratch_floats(G, A),
                         dtype=torch.float32, device=dev)
    e_out = torch.empty(2, dtype=torch.float32, device=dev)
    prm = _params(wm, style, alpha, rc)
    err = lib.ww_pair_forward(
        wxg.data_ptr(), box.data_ptr(), f.data_ptr(), e_part.data_ptr(),
        e_out.data_ptr(), gx, gy, gz, A, ctypes.addressof(prm),
        int(style == "dsf"), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ww_pair kernel launch failed: CUDA error {err}")
    water_water_cuda.launches += 1
    return e_out[0], e_out[1], f


water_water_cuda.launches = 0   # kernel launches (read by chip_smoke.py)
