"""Build, load and launch the CUDA water-water kernels.

- ``csrc/ww_pair.cu`` (``water_water_cuda``) replaces the TPU kernel
  constant_ph_tpu/tiled/pallas_ww.py ``_chunk_pair_kernel`` (K1, the hot
  path);
- ``csrc/ww_tally.cu`` (``water_water_tally_cuda``) replaces
  ``make_ww_kernel``'s inner kernel (K2, the full-tally path).

Both take a batch of R replicas in one launch (a leading replica axis on
the tiles and the box; the grid's z dimension in the kernels); one
replica's tiles run as a batch of one. Both have a slab entry
(``x_first=``): tiles of a rank's owned x-layers between two ghost
layers (parallel/spatial.py), outputs for the owned cells. See the note at the top of each
source for its design and bound. Each
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
from constant_ph_tpu_torch.batching import replica_batched
from constant_ph_tpu_torch.tiled.layout import W_MAX

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
        "ww_pair_blocks": [ctypes.c_int, ctypes.c_int],
        "ww_pair_smem_bytes": [ctypes.c_int, ctypes.c_int],
        "ww_pair_forward": ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                            + [ctypes.c_void_p] + [ctypes.c_int] * 6
                            + [ctypes.c_void_p]),
    },
    "ww_tally": {
        "ww_tally_param_count": [],
        "ww_tally_smem_bytes": [ctypes.c_int, ctypes.c_int],
        "ww_tally_forward": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                             + [ctypes.c_void_p] + [ctypes.c_int] * 5
                             + [ctypes.c_void_p]),
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


# dynamic shared memory a block may take: the 227 KB a block can hold, less
# the kernels' < 1 KB of static shared memory; and the most that still lets
# two blocks share an SM's 228 KB (each block reserves 1 KB beside its own)
SMEM_BLOCK = 227 * 1024 - 1024
SMEM_TWO_PER_SM = 228 * 1024 // 2 - 2048
# the pass counts the kernels take: the 27-cell stencil staged whole, by
# dx plane (9 cells a pass), by dx-dy row (3) or cell by cell
PASSES = (1, 3, 9, 27)


def pass_count(smem_of, W, passes=None):
    """The number of passes a kernel stages its stencil in at W: one where
    the whole stencil fits a block, else the fewest passes that let two
    blocks share an SM (else the fewest that fit). ``passes`` forces a
    count (for checks of the multi-pass path); smem_of(W, passes) gives
    the bytes a block takes."""
    if passes is not None:
        if passes not in PASSES:
            raise ValueError(f"passes must be one of {PASSES}, got {passes}")
        if smem_of(W, passes) > SMEM_BLOCK:
            raise ValueError(f"{passes} passes at W={W} take "
                             f"{smem_of(W, passes)} bytes of shared memory, "
                             f"more than a block holds ({SMEM_BLOCK})")
        return passes
    if smem_of(W, 1) <= SMEM_BLOCK:
        return 1
    fit = [n for n in PASSES[1:] if smem_of(W, n) <= SMEM_BLOCK]
    two = [n for n in fit if smem_of(W, n) <= SMEM_TWO_PER_SM]
    return (two or fit)[0]


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


# the most replicas a launch takes (the grid's z dimension)
R_MAX = 65535


def slab_layers(t, p, x_first, x_axis):
    """(x-layers of the tile array t, owned x-layers) of a kernel call:
    the whole grid (gx, gx) without ``x_first``; on a slab, t's layers
    along ``x_axis`` are the owned ones between two ghost layers, within
    the global grid."""
    gx = p.grid[0]
    if x_first is None:
        return gx, gx
    if t.ndim <= x_axis:
        raise ValueError("a slab's tiles need their x axis")
    gxa = t.shape[x_axis]
    gxo = gxa - 2
    if gxo < 1 or not 0 <= x_first <= gx - gxo:
        raise ValueError(f"a slab of {gxa} x-layers (ghosts included) at "
                         f"x {x_first} does not fit the global gx {gx}")
    return gxa, gxo


@replica_batched(5)
def water_water_cuda(wxg, wm, p, box, *, style, alpha, rc, passes=None,
                     x_first=None):
    """The water-water block on the GPU, one launch for a batch of R
    replicas: wxg (R, 3, gx, gy, gz, 3W), box (R, 3) → (e_lj (R,), e_coul
    (R,), f shaped like wxg), as tiled.forces.water_water_fast_plain; one
    replica's (3, gx, gy, gz, 3W) and (3,) run as a batch of one. Launches
    on the current stream without synchronising. The atom pairs the
    kernel evaluated are left, as an (R,) int32 tensor on the device, in
    ``water_water_cuda.pairs_evaluated``, and the passes it staged the
    stencil in in ``water_water_cuda.passes`` (chosen from W by
    pass_count; ``passes`` forces a count, for checks only).

    Slab entry (``x_first`` the global x index of the first owned layer):
    wxg (R, 3, n + 2, gy, gz, 3W) holds n owned x-layers of the global
    grid ``p.grid`` between two ghost layers; f is (R, 3, n, gy, gz, 3W)
    and the energies count the owned cells' pairs (tiled.forces.
    water_water_slab_plain). It counts in ``spatial_launches`` too."""
    gx, gy, gz = p.grid
    W = p.W
    A = 3 * W
    R = wxg.shape[0]
    if min(p.grid) < 3:
        raise ValueError("the CUDA water-water kernel needs grid >= 3 per "
                         "dim (the stencil would alias)")
    if style not in ("dsf", "cut"):
        raise ValueError(f"unknown coulomb style {style!r}")
    gxa, gxo = slab_layers(wxg, p, x_first, 2)
    G = gxo * gy * gz
    if not (wxg.is_cuda and wxg.dtype == torch.float32
            and wxg.is_contiguous()
            and wxg.numel() == R * 3 * gxa * gy * gz * A
            and wxg.shape[1] == 3 and wxg.shape[-1] == A):
        raise ValueError("wxg must be a contiguous float32 CUDA tensor of "
                         f"shape (R, 3, {gxa}, {gy}, {gz}, {A})")
    if not (box.is_cuda and box.dtype == torch.float32
            and box.is_contiguous() and tuple(box.shape) == (R, 3)):
        raise ValueError("box must be a contiguous float32 CUDA tensor "
                         "(R, 3)")
    # cp.async copies 16-byte pieces of every tile row; a candidate is
    # coded (segment << 8) | molecule
    if (W % 4 or W > W_MAX or wxg.data_ptr() % 16 or G > 65535
            or R > R_MAX):
        raise ValueError(f"the kernel needs W % 4 == 0 and W <= {W_MAX}, a "
                         f"16-byte aligned wxg, G <= 65535 and R <= {R_MAX} "
                         f"(W={W}, G={G}, R={R})")
    lib = _lib("ww_pair")
    n_pass = pass_count(lib.ww_pair_smem_bytes, W, passes)
    dev = wxg.device
    f = torch.empty((R, 3, gxo, gy, gz, A) if x_first is not None
                    else wxg.shape, dtype=wxg.dtype, device=dev)
    # one scratch buffer: e_out (2R floats), n_out (R ints), padding to 16
    # bytes, then the per-block partials (2 floats and 1 int a block)
    nblk = R * lib.ww_pair_blocks(G, W)
    head = -(-3 * R // 4) * 4
    scratch = torch.empty(head + 3 * nblk, dtype=torch.float32, device=dev)
    base = scratch.data_ptr()
    part = base + 4 * head
    prm = _params(wm, style, alpha, rc)
    err = lib.ww_pair_forward(
        wxg.data_ptr(), box.data_ptr(), f.data_ptr(), part, part + 8 * nblk,
        base, base + 8 * R, gxa, gy, gz, W, ctypes.addressof(prm),
        int(style == "dsf"), n_pass, R, int(x_first is not None),
        x_first or 0, gx, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ww_pair kernel launch failed: CUDA error {err}")
    water_water_cuda.launches += 1
    water_water_cuda.spatial_launches += x_first is not None
    water_water_cuda.passes = n_pass
    water_water_cuda.pairs_evaluated = scratch[2 * R:3 * R].view(torch.int32)
    e = scratch[:2 * R].view(R, 2)
    return e[:, 0], e[:, 1], f


water_water_cuda.launches = 0   # kernel launches (read by chip_smoke.py)
water_water_cuda.spatial_launches = 0     # of them, through the slab entry
water_water_cuda.pairs_evaluated = None   # (R,) of the last launch
water_water_cuda.passes = None            # of the last launch


def _tally_params(wm, style, alpha, rc):
    from constant_ph_tpu_torch.ops.kernels import TWO_OVER_SQRT_PI
    from constant_ph_tpu_torch.tiled.forces import coulomb_constants

    e_sh, f_sh, _, _ = coulomb_constants(style, alpha, rc)
    vals = [wm.c6_OO, wm.c12_OO, wm.eshift_OO, 6.0 * wm.c6_OO,
            12.0 * wm.c12_OO, rc, rc * rc, rc * rc + 1.0, alpha,
            TWO_OVER_SQRT_PI, units.QQR2E, e_sh, f_sh]
    return (ctypes.c_float * len(vals))(*vals)


@replica_batched(5)
def water_water_tally_cuda(wt, box, wm, p, *, style, alpha, rc,
                           passes=None, x_first=None):
    """The full-tally water-water kernel on the GPU, one launch for a
    batch of R replicas: packed tiles wt (R, gx, gy, gz, 8, A) and box
    (R, 3) → out shaped like wt, as tiled.forces.water_water_tally_plain;
    one replica's (gx, gy, gz, 8, A) and (3,) run as a batch of one.
    Launches on the current stream without synchronising. The atom pairs
    the kernel evaluated are left, as an (R,) int32 tensor on the device,
    in ``water_water_tally_cuda.pairs_evaluated``, and the passes it
    staged the stencil in in ``water_water_tally_cuda.passes`` (chosen
    from W by pass_count; ``passes`` forces a count, for checks only).

    Slab entry (``x_first`` the global x index of the first owned layer):
    wt (R, n + 2, gy, gz, 8, A) holds n owned x-layers of the global grid
    ``p.grid`` between two ghost layers; out is (R, n, gy, gz, 8, A)
    (tiled.forces.water_water_tally_plain with ``x_first``). It counts in
    ``spatial_launches`` too."""
    gx, gy, gz = p.grid
    W = p.W
    A = 3 * W
    R = wt.shape[0]
    if min(p.grid) < 3:
        raise ValueError("the CUDA full-tally kernel needs grid >= 3 per "
                         "dim (the 27 offsets must be distinct cells)")
    if style not in ("dsf", "cut"):
        raise ValueError(f"unknown coulomb style {style!r}")
    gxa, gxo = slab_layers(wt, p, x_first, 1)
    G = gxo * gy * gz
    if not (wt.is_cuda and wt.dtype == torch.float32 and wt.is_contiguous()
            and tuple(wt.shape) == (R, gxa, gy, gz, 8, A)):
        raise ValueError("wt must be a contiguous float32 CUDA tensor of "
                         f"shape (R, {gxa}, {gy}, {gz}, 8, {A})")
    if not (box.is_cuda and box.dtype == torch.float32
            and box.is_contiguous() and tuple(box.shape) == (R, 3)):
        raise ValueError("box must be a contiguous float32 CUDA tensor "
                         "(R, 3)")
    # cp.async copies 16-byte pieces of every tile row; a candidate is
    # coded (offset << 8) | molecule
    if (W % 4 or W > W_MAX or wt.data_ptr() % 16 or G > 65535
            or R > R_MAX):
        raise ValueError(f"the kernel needs W % 4 == 0 and W <= {W_MAX}, a "
                         f"16-byte aligned wt, G <= 65535 and R <= {R_MAX} "
                         f"(W={W}, G={G}, R={R})")
    lib = _lib("ww_tally")
    n_pass = pass_count(lib.ww_tally_smem_bytes, W, passes)
    out = torch.empty((R, gxo, gy, gz, 8, A), dtype=wt.dtype,
                      device=wt.device)
    count = torch.empty(R, dtype=torch.int32, device=wt.device)
    prm = _tally_params(wm, style, alpha, rc)
    err = lib.ww_tally_forward(
        wt.data_ptr(), box.data_ptr(), out.data_ptr(), count.data_ptr(),
        gxa, gy, gz, W, ctypes.addressof(prm), int(style == "dsf"),
        int(alpha > 0.0), n_pass, R, int(x_first is not None),
        torch.cuda.current_stream(wt.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ww_tally kernel launch failed: CUDA error {err}")
    water_water_tally_cuda.launches += 1
    water_water_tally_cuda.spatial_launches += x_first is not None
    water_water_tally_cuda.passes = n_pass
    water_water_tally_cuda.pairs_evaluated = count
    return out


water_water_tally_cuda.launches = 0   # kernel launches (read by chip_smoke.py)
water_water_tally_cuda.spatial_launches = 0   # of them, through the slab entry
water_water_tally_cuda.pairs_evaluated = None   # (R,) of the last launch
water_water_tally_cuda.passes = None            # of the last launch
