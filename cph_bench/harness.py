"""One run of one cell: set-up, the measured (or traced) window, the
comparison with the reference, and the result line.

Everything a cell is made of is found by name: the cell's entry in
BENCHMARK.json names a configuration (its ``file``) and a traffic mix
(``cph_bench/traffic/<mix>.json``); the mix names its driver
(``cph_bench/drivers/<driver>.py``, whose ``make(ctx)`` builds the run);
each per-layer metric is read by ``cph_bench/layers/<metric>.py``,
whose ``SPANS``, if it has them, name the port's functions that the
traced run wraps in spans for it. Adding a cell needs only new files and
entries."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time

import torch

JAX_NAMES = ("jax", "jaxlib", "flax", "constant_ph_tpu")


@dataclasses.dataclass
class Cell:
    root: str               # the checkout: BENCHMARK.json and cph_bench/
    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: list        # metric entries of BENCHMARK.json
    per_layer: list


def _load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root, name) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, conf["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(root, "cph_bench", "traffic",
                           cell["traffic"] + ".json")) as fh:
        mix = json.load(fh)

    def here(m):
        return m.get("workloads") is None or name in m["workloads"]

    return Cell(root=root, name=name, config=config, mix=mix,
                chips=int(cell["chips"]),
                end_to_end=[m for m in bench["end_to_end"] if here(m)],
                per_layer=[m for m in bench["per_layer"] if here(m)])


class Context:
    """What a driver and the readers get: the cell's data, the seed, the
    device, the inputs once built, and notes of the set-up."""

    def __init__(self, cell, seed, device, reference_rows=1024):
        self.cell = cell
        self.config = cell.config
        self.mix = cell.mix
        self.seed = int(seed)
        self.device = device
        self.inputs = None
        self.notes = {}
        self.reference_rows = reference_rows

    def sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()


def driver(cell):
    kind = cell.mix["driver"]
    return _load_module(os.path.join(cell.root, "cph_bench", "drivers",
                                     kind + ".py"), "cph_bench_driver_" + kind)


def reader(cell, metric):
    return _load_module(os.path.join(cell.root, "cph_bench", "layers",
                                     metric + ".py"),
                        "cph_bench_layer_" + metric)


def jax_modules():
    """Top-level names in sys.modules that are JAX or the JAX package,
    compared whole (constant_ph_tpu_torch is not constant_ph_tpu)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(JAX_NAMES))


def device_info(device, chips):
    if torch.device(device).type != "cuda":
        return dict(platform="cpu", kind="cpu", count=0,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=chips,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated()))


def run_cell(cell, seed, seconds, trace, device, t_start, wrap=None):
    """One run; returns the result dict (the line's keys) and the
    compared numbers [(name, value, limit)]. ``wrap(ctx, run)``, if
    given, stands in for the driver's run (the control)."""
    from cph_bench.reference.check import judge

    ctx = Context(cell, seed, device)
    is_cuda = torch.device(device).type == "cuda"
    run = driver(cell).make(ctx)
    if wrap is not None:
        run = wrap(ctx, run)
    for _ in range(int(cell.mix.get("warm_blocks", 1))):
        run.block()
    ctx.sync()
    run.reset()
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    if is_cuda:
        torch.cuda.reset_peak_memory_stats()

    metrics = {}
    dev = {}
    breakdown = None
    if trace:
        from cph_bench import tracing

        readers = {m["name"]: reader(cell, m["name"]) for m in cell.per_layer}
        spans = {}
        for mod in readers.values():
            spans.update(getattr(mod, "SPANS", {}))
        tr = tracing.traced_window(run, int(cell.mix["trace_blocks"]),
                                   ctx.sync, spans)
        for m in cell.per_layer:
            v = readers[m["name"]].read(tr, ctx, run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev = dict(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = tracing.breakdown(tr)
    else:
        t0 = time.perf_counter()
        while True:
            run.block()
            if time.perf_counter() - t0 >= seconds:
                break
        ctx.sync()
        wall = time.perf_counter() - t0
        ns = run.R * run.blocks * run.steps_per_block * run.dt_fs * 1e-6
        window = dict(
            ns_per_day=ns * 86400.0 / wall,
            peak_mem_gib=(torch.cuda.max_memory_allocated() / 2**30
                          if is_cuda else 0.0),
            setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] in window:
                metrics[m["name"]] = {"value": window[m["name"]],
                                      "unit": m["unit"]}
        ctx.notes["window_s"] = wall
    if is_cuda:
        from cph_bench import roofline

        ctx.notes["card"] = roofline.power_limit()
    info = device_info(device, cell.chips)
    info["memory_peak_bytes"] = max(info["memory_peak_bytes"],
                                    int(setup_peak))
    info.update(dev)
    attempted, failed = run.health()

    J = run.judged()
    del run
    if is_cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = judge(ctx, J)
    ctx.notes["reference_s"] = time.perf_counter() - t0
    ok = all(v <= lim for _, v, lim in checks) and failed == 0 \
        and attempted > 0
    checks = checks + [("failed_replica_blocks", float(failed), 0.0)]
    result = {"correct": bool(ok), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["notes"] = ctx.notes
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result, checks
