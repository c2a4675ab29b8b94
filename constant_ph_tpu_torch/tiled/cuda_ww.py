"""Build, load and launch the CUDA water-water kernels.

- ``csrc/ww_pair.cu`` (``water_water_cuda``) replaces the TPU kernel
  constant_ph_tpu/tiled/pallas_ww.py ``_chunk_pair_kernel`` (K1, the hot
  path);
- ``csrc/ww_tally.cu`` (``water_water_tally_cuda``) replaces
  ``make_ww_kernel``'s inner kernel (K2, the full-tally path).

See the note at the top of each source for its design and bound. Each
source is compiled with nvcc for sm_90a into a shared library with a
plain C interface, at first use, under ``constant_ph_tpu_torch/_build/``
(named by a hash of the source and flags), and loaded with ctypes;
``build()`` runs one nvcc per source, all at once. Nothing here touches
CUDA when the module is imported.
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
SOURCES = {name: os.path.join(_PKG, "csrc", f"{name}.cu")
           for name in ("ww_pair", "ww_tally")}
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


def _target(name: str) -> str:
    with open(SOURCES[name], "rb") as fh:
        digest = hashlib.sha256(
            fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}_{digest}.so")


def build(names=tuple(SOURCES)) -> dict:
    """Compile the kernel libraries of ``names`` that are not built yet,
    one nvcc process per source, all started together. Returns {name:
    (path of the .so, nvcc's messages — empty when it was already
    built)}."""
    out, jobs = {}, []
    for name in names:
        path = _target(name)
        if os.path.exists(path):
            out[name] = (path, "")
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCES[name]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, path, tmp, proc))
    # wait for every nvcc before reporting a failure, so none is left
    # running
    done = [(name, path, tmp, proc, proc.communicate()[0])
            for name, path, tmp, proc in jobs]
    for name, path, tmp, proc, msgs in done:
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCES[name]}:\n{msgs}")
        os.replace(tmp, path)
        out[name] = (path, msgs)
    return out


# argument types of each library's C entry points (all return int)
_ARGTYPES = {
    "ww_pair": {
        "ww_pair_param_count": [],
        "ww_pair_scratch_floats": [ctypes.c_int, ctypes.c_int],
        "ww_pair_forward": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                            + [ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p]),
    },
    "ww_tally": {
        "ww_tally_param_count": [],
        "ww_tally_forward": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p]),
    },
}


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(build((name,))[name][0])
    for fn, argtypes in _ARGTYPES[name].items():
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = argtypes
    if getattr(lib, f"{name}_param_count")() != len(_PARAM_ORDER[name]):
        raise RuntimeError(f"{name}.cu parameter layout does not match "
                           f"cuda_ww._PARAM_ORDER[{name!r}]")
    return lib


# host parameter array layouts; the enum P_* in each source mirrors them
_PARAM_ORDER = {
    "ww_pair": ([f"c1_{k}" for k in range(11)]
                + [f"c2_{k}" for k in range(11)]
                + ["kOO", "kOH", "kHH", "c6", "c12", "esh", "c6x6",
                   "c12x12", "rc", "rc2", "two_over_rc", "e_sh", "f_sh"]),
    "ww_tally": ["c6", "c12", "esh", "c6x6", "c12x12", "rc", "rc2", "far",
                 "alpha", "two_over_sqrt_pi", "qqr2e", "e_sh", "f_sh"],
}


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
    lib = _lib("ww_pair")
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


def _tally_params(wm, style, alpha, rc):
    from constant_ph_tpu_torch.ops.kernels import TWO_OVER_SQRT_PI
    from constant_ph_tpu_torch.tiled.forces import coulomb_constants

    e_sh, f_sh, _, _ = coulomb_constants(style, alpha, rc)
    vals = [wm.c6_OO, wm.c12_OO, wm.eshift_OO, 6.0 * wm.c6_OO,
            12.0 * wm.c12_OO, rc, rc * rc, rc * rc + 1.0, alpha,
            TWO_OVER_SQRT_PI, units.QQR2E, e_sh, f_sh]
    return (ctypes.c_float * len(vals))(*vals)


def water_water_tally_cuda(wt, box, wm, p, *, style, alpha, rc):
    """The full-tally water-water kernel on the GPU: packed tiles wt
    (gx, gy, gz, 8, A) and box (3,) → out (gx, gy, gz, 8, A), as
    tiled.forces.water_water_tally_plain. Launches on the current stream
    without synchronising."""
    gx, gy, gz = p.grid
    G, A = p.G, 3 * p.W
    if min(p.grid) < 3:
        raise ValueError("the CUDA full-tally kernel needs grid >= 3 per "
                         "dim (the 27 offsets must be distinct cells)")
    if style not in ("dsf", "cut"):
        raise ValueError(f"unknown coulomb style {style!r}")
    if not (wt.is_cuda and wt.dtype == torch.float32 and wt.is_contiguous()
            and tuple(wt.shape) == (gx, gy, gz, 8, A)):
        raise ValueError("wt must be a contiguous float32 CUDA tensor of "
                         f"shape ({gx}, {gy}, {gz}, 8, {A})")
    if not (box.is_cuda and box.dtype == torch.float32
            and box.is_contiguous() and tuple(box.shape) == (3,)):
        raise ValueError("box must be a contiguous float32 CUDA tensor (3,)")
    if 6 * A * 4 > 48 * 1024 or G > 65535:
        raise ValueError(f"tile too large for the kernel (A={A}, G={G})")
    lib = _lib("ww_tally")
    out = torch.empty_like(wt)
    prm = _tally_params(wm, style, alpha, rc)
    err = lib.ww_tally_forward(
        wt.data_ptr(), box.data_ptr(), out.data_ptr(), gx, gy, gz, A,
        ctypes.addressof(prm), int(style == "dsf"), int(alpha > 0.0),
        torch.cuda.current_stream(wt.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ww_tally kernel launch failed: CUDA error {err}")
    water_water_tally_cuda.launches += 1
    return out


water_water_tally_cuda.launches = 0   # kernel launches (read by chip_smoke.py)
