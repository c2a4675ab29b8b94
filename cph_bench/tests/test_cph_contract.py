"""BENCHMARK.json against the benchmark's contract, the cells it names,
and the JAX-import check."""
import json
import os
import re
import subprocess
import sys

import pytest

from cph_bench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cph_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert all(LINE.match(w) for w in BENCH["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    n = len(BENCH["workloads"])
    # a full check of 24 cells: 2 + 14 runs a cell, each run_seconds + 60,
    # 180 s a cell to compile, 1,200 s spare, inside 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= n <= 24


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_units_and_lines(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert LINE.match(e[key]), (e["name"], key)


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("cph_bench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_pieces(cell):
    c = harness.load_cell(ROOT, cell)
    assert hasattr(harness.driver(c), "make")
    for m in c.per_layer:
        assert hasattr(harness.reader(c, m["name"]), "read")
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "ns_per_day"}
    assert c.per_layer


@pytest.mark.parametrize("name,flagged", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("constant_ph_tpu", True),
    ("constant_ph_tpu.engine", True), ("constant_ph_tpu_torch", False),
    ("constant_ph_tpu_torch.tiled.engine", False), ("jaxtyping", False),
])
def test_jax_check_compares_whole_top_level_names(monkeypatch, name,
                                                  flagged):
    for m in [m for m in sys.modules
              if m.split(".")[0] in harness.JAX_NAMES]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, object())
    assert bool(harness.jax_modules()) is flagged


def test_a_run_without_a_card_fails_and_prints_no_result():
    """Run only where there is no card: the command must refuse."""
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cell = BENCH["workloads"][0]["name"]
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "cph_bench", "run.py"),
         "--workload", cell, "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
