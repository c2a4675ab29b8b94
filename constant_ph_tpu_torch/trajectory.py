"""Trajectory output: DCD (CHARMM/X-PLOR binary) writer and reader (port of
constant_ph_tpu/trajectory.py; the files are byte-identical to the JAX
package's for the same frames).

Host-side sink for positions streamed from run blocks; DCD is the compact
de-facto format every MD analysis tool reads (VMD, MDAnalysis, mdtraj).
Frames may be torch tensors on any device: each is copied to the host
once.
"""
from __future__ import annotations

import struct as _struct

import numpy as np
import torch


def _host(a, dtype):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


class DCDWriter:
    def __init__(self, path: str, n_atoms: int, *, dt_fs: float = 1.0,
                 save_every: int = 1):
        self._fh = open(path, "wb")
        self.n_atoms = n_atoms
        self._n_frames = 0
        self._header_written = False
        self._dt_akma = dt_fs / 48.88821291  # fs → AKMA time units
        self._save_every = save_every

    def _block(self, payload: bytes) -> bytes:
        n = _struct.pack("<i", len(payload))
        return n + payload + n

    def _write_header(self):
        h = b"CORD"
        ints = [0] * 20
        ints[0] = 0                      # nframes (patched on close)
        ints[1] = 1                      # first step
        ints[2] = self._save_every
        ints[7] = 0                      # ndof placeholder
        ints[19] = 24                    # CHARMM version flag
        payload = h + _struct.pack("<9i", *ints[:9]) \
            + _struct.pack("<f", self._dt_akma) \
            + _struct.pack("<10i", *ints[9:19]) \
            + _struct.pack("<i", ints[19])
        self._fh.write(self._block(payload))
        # the JAX package's title, so both packages write the same bytes
        title = b"* written by constant_ph_tpu".ljust(80)
        self._fh.write(self._block(_struct.pack("<i", 1) + title))
        self._fh.write(self._block(_struct.pack("<i", self.n_atoms)))
        self._header_written = True

    def write_frame(self, x, box=None):
        """x: (n_atoms, 3) Å. box: optional (3,) orthorhombic lengths."""
        if not self._header_written:
            self._write_header()
        x = _host(x, np.float32)
        if box is not None:
            b = _host(box, np.float64)
            # CHARMM unit cell record: a, gamma, b, beta, alpha, c
            cell = _struct.pack("<6d", b[0], 90.0, b[1], 90.0, 90.0, b[2])
            self._fh.write(self._block(cell))
        for d in range(3):
            self._fh.write(self._block(x[:, d].tobytes()))
        self._n_frames += 1

    def close(self):
        if self._header_written:
            # patch frame count
            self._fh.seek(8)
            self._fh.write(_struct.pack("<i", self._n_frames))
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_dcd(path: str):
    """Minimal DCD reader (for tests / analysis): returns (frames, boxes)
    as numpy arrays."""
    with open(path, "rb") as fh:

        def block():
            raw = fh.read(4)
            if len(raw) < 4:
                return None
            (n,) = _struct.unpack("<i", raw)
            payload = fh.read(n)
            fh.read(4)
            return payload

        header = block()
        if header is None or header[:4] != b"CORD":
            raise ValueError(f"{path} is not a DCD file")
        block()  # title
        block()  # atom count
        frames, boxes = [], []
        while True:
            b1 = block()
            if b1 is None:
                break
            if len(b1) == 48:   # unit cell record
                cell = _struct.unpack("<6d", b1)
                boxes.append((cell[0], cell[2], cell[5]))
                b1 = block()
            xs = np.frombuffer(b1, dtype=np.float32)
            ys = np.frombuffer(block(), dtype=np.float32)
            zs = np.frombuffer(block(), dtype=np.float32)
            frames.append(np.stack([xs, ys, zs], axis=-1))
    return np.array(frames), np.array(boxes)
