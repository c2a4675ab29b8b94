"""The port's native build and entry points on the CPU.

- native/build.load_library: without g++ on PATH the deck reader and the
  exclusion builder take their Python paths (recorded in
  read_lammps_data.last_reader / build_exclusions.last_path) and give
  the native paths' results; a source that does not compile, and a
  library that does not load, raise instead of falling back.
- cli._load_config reads a .json and a .yaml config as the JAX CLI does,
  and refuses .yaml with the JAX message when pyyaml is missing.
- ``python -m constant_ph_tpu_torch``: a `run` with ``--device cpu``
  prints the summary JSON as its last stdout line; without ``--device``
  it asks for CUDA and fails where there is none.
No JAX function is compiled here.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from constant_ph_tpu import cli as jcli
from constant_ph_tpu_torch import cli as tcli
from constant_ph_tpu_torch import forcefield as tff
from constant_ph_tpu_torch.native import build
from constant_ph_tpu_torch.systems import lammps_data as tld
from constant_ph_tpu_torch.systems.water import solvated_acid

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACID = dict(n_side=3, pH=5.0, pK=4.25, cutoff=4.5, coul_style="dsf",
            alpha=0.2, rigid_water=True)


@pytest.fixture
def fresh_build(monkeypatch):
    """load_library with its cache cleared before and after the test."""
    build.load_library.cache_clear()
    yield monkeypatch
    monkeypatch.undo()
    build.load_library.cache_clear()


def test_no_gxx_takes_the_python_paths(tmp_path, fresh_build):
    system = solvated_acid(device="cpu", **ACID)
    deck = str(tmp_path / "acid.data")
    tld.write_lammps_data(deck, system)
    native = tld.read_lammps_data(deck)
    assert tld.read_lammps_data.last_reader == "native"
    n = int(system.ff.mass.shape[0])
    bonds = native["bonds"][:, 1:3]             # (type, i, j), 0-based
    n_idx, n_code = tff.build_exclusions(n, bonds)
    assert tff.build_exclusions.last_path == "native"

    fresh_build.setattr(build.shutil, "which", lambda name: None)
    build.load_library.cache_clear()
    assert build.load_library("lammps_data") is None
    python = tld.read_lammps_data(deck)
    assert tld.read_lammps_data.last_reader == "python"
    assert set(python) == set(native)
    for k in native:
        if k != "coeffs":
            np.testing.assert_array_equal(python[k], native[k], err_msg=k)
    assert python["coeffs"] == native["coeffs"]
    p_idx, p_code = tff.build_exclusions(n, bonds)
    assert tff.build_exclusions.last_path == "python"
    for i in range(n):
        assert (sorted(zip(p_idx[i], p_code[i]))
                == sorted(zip(n_idx[i], n_code[i]))), i
    # a bond to an atom that is not there raises on either path
    for bad in (bonds - 1, bonds + 1):
        with pytest.raises(ValueError, match="out of range"):
            tff.build_exclusions(n, bad)


def test_failed_build_or_load_raises(tmp_path, fresh_build):
    broken = tmp_path / "broken.cpp"
    broken.write_text("extern \"C\" int f( { return 0; }\n")
    with open(build.SOURCES["lammps_data"]) as fh:
        good = tmp_path / "lammps_data.cpp"
        good.write_text(fh.read())
    fresh_build.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    fresh_build.setattr(build, "SOURCES", {"topology": str(broken),
                                           "lammps_data": str(good)})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        build.load_library("topology")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tff.build_exclusions(3, np.array([[0, 1], [1, 2]]))
    # a file at the library's path that is not a library: dlopen fails
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    with open(build._target("lammps_data"), "wb") as fh:
        fh.write(b"not a shared object")
    with pytest.raises(OSError):
        build.load_library("lammps_data")


def test_load_config_as_jax(tmp_path, monkeypatch):
    cfg = dict(system=dict(builder="solvated_acid", n_side=3),
               engine=dict(dt=1.0, rebuild_every=5), run=dict(steps=10))
    js = tmp_path / "c.json"
    js.write_text(json.dumps(cfg))
    assert tcli._load_config(str(js)) == jcli._load_config(str(js)) == cfg
    ym = tmp_path / "c.yaml"
    ym.write_text("system: {builder: solvated_acid, n_side: 3}\n"
                  "engine: {dt: 1.0, rebuild_every: 5}\n"
                  "run: {steps: 10}\n")
    try:
        import yaml  # noqa: F401
        assert tcli._load_config(str(ym)) == jcli._load_config(str(ym)) == cfg
    except ImportError:
        pass
    # without pyyaml both refuse a .yaml config with the same message
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(SystemExit) as want:
        jcli._load_config(str(ym))
    with pytest.raises(SystemExit) as got:
        tcli._load_config(str(ym))
    assert str(got.value) == str(want.value)


def test_python_m_entry_point(tmp_path):
    cfg = tmp_path / "run.json"
    cfg.write_text(json.dumps(dict(
        system=dict(builder="solvated_acid", **ACID),
        engine=dict(dt=1.0, thermostat="nve", lambda_thermostat="none",
                    rebuild_every=5),
        run=dict(steps=5, minimize_steps=0, tiled=False))))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")

    def run(*extra):
        return subprocess.run(
            [sys.executable, "-m", "constant_ph_tpu_torch", "run", str(cfg),
             *extra], cwd=str(tmp_path), env=env, capture_output=True,
            text=True, timeout=120)

    proc = run("--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["steps"] == 5 and np.isfinite(summary["e_pot"])
    assert set(summary) == {"steps", "wall_s", "e_pot", "temp",
                            "protonation_fraction", "lambda_final"}
    if not torch.cuda.is_available():
        proc = run()
        assert proc.returncode != 0
        assert "torch.cuda.is_available() is False" in proc.stderr
