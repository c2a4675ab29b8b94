"""Observable streaming and analysis (port of
constant_ph_tpu/observables.py).

The run loop returns an Observables dataclass stacked per step; this
module is the host-side sink: thinning, JSONL/CSV writers, and the
titration estimators (protonation fraction, the Henderson–Hasselbalch
reference curve).
"""
from __future__ import annotations

import dataclasses
import json
from typing import IO, Iterable

import numpy as np
import torch


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def observables_to_rows(obs, every: int = 1) -> Iterable[dict]:
    """Flatten a stacked Observables (leading time axis) to dict rows."""
    fields = [f.name for f in dataclasses.fields(obs)]
    arrays = {name: _host(getattr(obs, name)) for name in fields}
    n = len(next(iter(arrays.values())))
    for t in range(0, n, every):
        row = {}
        for name, a in arrays.items():
            v = a[t]
            row[name] = v.tolist() if v.ndim else float(v)
        yield row


def write_jsonl(obs, fh: IO[str], every: int = 1, step0: int = 0) -> None:
    for i, row in enumerate(observables_to_rows(obs, every)):
        row["step"] = step0 + i * every
        fh.write(json.dumps(row) + "\n")


def write_csv(obs, fh: IO[str], every: int = 1, step0: int = 0) -> None:
    rows = list(observables_to_rows(obs, every))
    if not rows:
        return

    # vector observables (lam, v_lam, dUdlam) become indexed columns
    def expand(row):
        out = {}
        for k, v in row.items():
            if isinstance(v, list):
                for i, vi in enumerate(v):
                    out[f"{k}_{i}"] = vi
            else:
                out[k] = v
        return out

    rows = [expand(r) for r in rows]
    cols = list(rows[0].keys())
    fh.write("step," + ",".join(cols) + "\n")
    for i, r in enumerate(rows):
        fh.write(str(step0 + i * every) + ","
                 + ",".join(f"{r[c]:.8g}" for c in cols) + "\n")


def protonation_fraction(lam_trace, burn_in: float = 0.25):
    """Time-averaged deprotonated fraction per site, ⟨λ > ½⟩, after the
    first ``burn_in`` of the (T, S) trace; compare with hh_curve."""
    lam_trace = _host(lam_trace)
    t0 = int(burn_in * lam_trace.shape[0])
    return (lam_trace[t0:] > 0.5).mean(axis=0)


def hh_curve(pK, pH):
    """Henderson–Hasselbalch deprotonated fraction."""
    return 1.0 / (1.0 + 10.0 ** (np.asarray(pK) - np.asarray(pH)))
