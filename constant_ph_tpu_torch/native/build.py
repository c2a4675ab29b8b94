"""Compile (at first use) and load the port's native C++ components.

Each source is built with ``g++ -O2 -shared -fPIC -std=c++17`` into
``constant_ph_tpu_torch/_build/`` (named by a hash of the source and the
flags, written to a temporary name and renamed, so concurrent processes
never load a half-written library) and loaded with ctypes. The one
fallback is a machine without ``g++`` on PATH: load_library returns None
and the callers take their Python paths. A failed compile or a library
that does not load raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
SOURCES = {
    "topology": os.path.join(_DIR, "topology.cpp"),
    "lammps_data": os.path.join(_DIR, "lammps_data.cpp"),
}
FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]


def _target(name: str) -> str:
    with open(SOURCES[name], "rb") as fh:
        digest = hashlib.sha256(
            fh.read() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}_{digest}.so")


@functools.lru_cache(maxsize=None)
def load_library(name: str):
    """The ctypes CDLL of ``name`` ("topology" or "lammps_data"), built
    if needed; None when no g++ is on PATH."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    path = _target(name)
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run([gxx, *FLAGS, "-o", tmp, SOURCES[name]],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed on {SOURCES[name]}:\n{proc.stderr}")
        os.replace(tmp, path)
    return ctypes.CDLL(path)
