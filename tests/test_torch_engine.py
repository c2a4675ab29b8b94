"""Parity of the PyTorch port's TiledEngine with the JAX package on the
dilute grid-4³ box (tile_safety 0.2, W = 20), plus the port's own guards.

- compute_forces: forces, φ, dU/dλ and f_λ against JAX, each scaled by
  max(1, |ref|max) within 3e-6, and energies within rtol 1e-5 / atol
  1e-4 kcal/mol (the tolerances tests/test_pallas_ww.py holds between the
  JAX package's two water-water paths; e_coul and e_site are float32 sums
  of large ± terms).
- A 2-block × 4-step NVE trajectory (thermostat "nve", λ thermostat
  "none", λ-RESPA on) from the same JAX-built state. The tolerances come
  from the float32 divergence measured on the CPU between the two
  packages over these 8 steps: positions 1.1e-5 Å, velocities 1.8e-6 Å/fs,
  λ 0 (equal), h_conserved 2e-4 of 906 kcal/mol. They are set at ~10×
  those: 1e-4 Å, 2e-5 Å/fs, 1e-6, and rtol 2e-6 on h_conserved.
- Langevin (atoms + λ) and NHC runs stay finite and in a temperature band
  (the two packages draw different random numbers, so no trajectory
  parity for Langevin).
"""
import ast
import os
import re

import numpy as np
import jax
import pytest
import torch

from constant_ph_tpu.engine import EngineConfig as JConfig
from constant_ph_tpu.tiled.engine import TiledEngine as JEngine
from constant_ph_tpu_torch.engine import EngineConfig
from constant_ph_tpu_torch.ops.ewald import make_ewald_params
from constant_ph_tpu_torch.tiled.engine import TiledEngine

from test_torch_layout import jax_tiled, port_of

# the suite runs six xdist workers on the same cores: one torch thread
# each keeps the port tests from oversubscribing them
torch.set_num_threads(1)

NVE = dict(dt=1.0, thermostat="nve", lambda_thermostat="none",
           rebuild_every=4)


@pytest.fixture(scope="module")
def case():
    _, jts, jst = jax_tiled("dsf", 0.2)
    tts, tst = port_of(jts, jst)
    return jts, jst, tts, tst


def test_compute_forces_matches(case):
    jts, jst, tts, tst = case
    ref = jax.jit(JEngine(jts, JConfig(**NVE)).compute_forces)(jst)
    got = TiledEngine(tts, EngineConfig(**NVE)).compute_forces(tst)
    for name in ("fw", "fs", "f_lam", "phi_s", "dUdlam"):
        a = np.asarray(getattr(ref, name))
        scale = max(1.0, np.abs(a).max())
        np.testing.assert_allclose(getattr(got, name).numpy() / scale,
                                   a / scale, atol=3e-6, err_msg=name)
    for name in ("e_lj", "e_coul", "e_bonded", "e_site", "e_pot"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(ref, name)), rtol=1e-5,
                                   atol=1e-4, err_msg=name)


def test_nve_trajectory_follows_jax(case):
    jts, jst, tts, tst = case
    jst2, jov, jobs = jax.jit(JEngine(jts, JConfig(**NVE)).make_run(8))(jst)
    tst2, tov, tobs = TiledEngine(tts, EngineConfig(**NVE)).make_run(8)(tst)
    assert bool(tov) == bool(jov) is False
    np.testing.assert_array_equal(tst2.wid.numpy(), np.asarray(jst2.wid))
    np.testing.assert_allclose(tst2.wx.numpy(), np.asarray(jst2.wx),
                               atol=1e-4)
    np.testing.assert_allclose(tst2.sx.numpy(), np.asarray(jst2.sx),
                               atol=1e-4)
    np.testing.assert_allclose(tst2.wv.numpy(), np.asarray(jst2.wv),
                               atol=2e-5)
    np.testing.assert_allclose(tobs.lam.numpy(), np.asarray(jobs.lam),
                               atol=1e-6)
    np.testing.assert_allclose(tobs.h_conserved.numpy(),
                               np.asarray(jobs.h_conserved), rtol=2e-6)
    assert int(tst2.step) == 8


def test_unported_paths_raise(case):
    _, _, tts, tst = case
    # a live box needs PME: anything else is refused
    with pytest.raises(ValueError, match="kspace_live_box requires PME"):
        TiledEngine(tts, EngineConfig(kspace_live_box=True),
                    kspace_ep=object())
    # factorized Ewald on x-slabs, refused until it was ported, constructs
    # (without a process group the slab is the whole grid);
    # tests/test_torch_spatial_ewald.py runs it on 2 ranks
    ep = make_ewald_params(tst.box.numpy(), 0.3, device="cpu")
    eng = TiledEngine(tts, EngineConfig(), kspace_ep=ep, spatial=object())
    assert (eng.slab.world, eng.slab.n) == (1, tts.params.grid[0])
    with pytest.raises(ValueError, match="kspace_every"):
        TiledEngine(tts, EngineConfig(kspace_every=0))


# a string that is a whole module path, "a.b.c" or "a.b:attr"
_MODULE_PATH = re.compile(r"[A-Za-z_]\w*(\.\w+)+(:\w+)?|[A-Za-z_]\w*:\w+")


def _imported_modules(path):
    """Modules a file imports: import statements, and module paths named
    in strings (import_module / __import__ arguments, the values of a
    _BUILDERS table, and any other string that is a whole module path)."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif isinstance(node, ast.Call):
            fn = node.func
            name = getattr(fn, "attr", getattr(fn, "id", None))
            if (name in ("import_module", "__import__") and node.args
                    and isinstance(node.args[0], ast.Constant)):
                yield "string:" + str(node.args[0].value)
        elif (isinstance(node, ast.Assign)
              and any(getattr(t, "id", None) == "_BUILDERS"
                      for t in node.targets)):
            yield from ("string:" + v.value for v in node.value.values)
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and _MODULE_PATH.fullmatch(node.value)):
            yield "path:" + node.value


def test_port_never_imports_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # the spawned ranks of the multi-rank tests import tests/torch_ranks.py
    paths = [os.path.join(root, "chip_smoke.py"),
             os.path.join(root, "tests", "torch_ranks.py")]
    for d, _, files in os.walk(os.path.join(root, "constant_ph_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert len(paths) > 15
    for mod in ("comm", "spatial", "dryrun", "replica"):
        assert os.path.join(root, "constant_ph_tpu_torch", "parallel",
                            f"{mod}.py") in paths
    banned = {"jax", "jaxlib", "flax", "constant_ph_tpu"}
    n_strings = 0
    for path in paths:
        for mod in _imported_modules(path):
            if mod.startswith("string:"):
                # a module loaded by name must be one of the port's
                n_strings += 1
                mod = mod[len("string:"):]
                assert mod.split(".")[0].split(":")[0] == \
                    "constant_ph_tpu_torch", f"{path} loads {mod}"
            elif mod.startswith("path:"):
                mod = mod[len("path:"):]
            assert mod.split(".")[0].split(":")[0] not in banned, \
                f"{path} imports {mod}"
    # the CLI's builder table is read
    assert n_strings >= 5
