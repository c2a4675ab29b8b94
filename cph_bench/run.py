"""Run one cell of the benchmark once, on the card this process starts on.

    python3 cph_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (import, CUDA, kernel build or load, the system from the seed,
relaxation, warm-up) is timed from the first line of this file to the
window. With --trace 0 the window runs whole blocks for --seconds and
the line carries the cell's end-to-end metrics; with --trace 1 the mix's
``trace_blocks`` blocks run under torch.profiler and the line carries the
per-layer metrics, ``busy_s``, ``window_s`` and a breakdown. Either way
the state the window ended in is then compared with the plain reference
(cph_bench/reference/check.py). The numbers compared, with their limits,
are the last lines on standard error and the last key of the line; the
line is the last line on standard output.

Exits 2 without a result when there is no CUDA card (or fewer than the
cell asks for), and 3 when JAX or the JAX package was loaded."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".cph_cache")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's caches live in fixed directories of the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, ROOT)

    import torch

    from cph_bench import harness

    # the card does the work; few host threads keep this process's load
    # on the host small and steady
    torch.set_num_threads(min(2, torch.get_num_threads()))

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"cph_bench: needs {cell.chips} CUDA card(s); "
              f"cuda available {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result, checks = harness.run_cell(cell, args.seed, args.seconds,
                                      bool(args.trace), "cuda", T_START)
    loaded = harness.jax_modules()
    if loaded:
        print(f"cph_bench: JAX or the JAX package was loaded: {loaded}",
              file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
