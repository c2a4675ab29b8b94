"""Parity of the port's state I/O with the JAX package: groups.py
(Groups, check_finite), trajectory.py (DCDWriter, read_dcd: the files are
byte-identical), checkpoint.py (each package loads the other's files; the
port's save → load → run continues bit for bit, generator state included)
and profiling.py (benchmark_run, trace, time_components).

No JAX run loop is compiled here; the port's runs are on the CPU.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from constant_ph_tpu import checkpoint as jckpt
from constant_ph_tpu import profiling as jprof
from constant_ph_tpu.groups import Groups as JGroups
from constant_ph_tpu.groups import check_finite as jcheck_finite
from constant_ph_tpu.state import make_state as jmake_state
from constant_ph_tpu.trajectory import DCDWriter as JDCDWriter
from constant_ph_tpu.trajectory import read_dcd as jread_dcd
from constant_ph_tpu_torch import checkpoint, profiling
from constant_ph_tpu_torch.engine import EngineConfig
from constant_ph_tpu_torch.groups import Groups, check_finite
from constant_ph_tpu_torch.systems.water import solvated_acid
from constant_ph_tpu_torch.tiled.engine import TiledEngine
from constant_ph_tpu_torch.tiled.layout import (
    split_system, to_canonical, to_tiled)
from constant_ph_tpu_torch.trajectory import DCDWriter, read_dcd

from test_torch_layout import SPLIT, SYSTEM, fields_dict

torch.set_num_threads(1)


def test_groups_and_check_finite_match_jax():
    rng = np.random.default_rng(0)
    mask = rng.random(12) < 0.4
    vals = rng.normal(size=12).astype(np.float32)
    jg, tg = JGroups(12), Groups(12, device="cpu")
    for g in (jg, tg):
        g.define("H", ids=[2, 5, 11])
        g.define("W", mask=mask)
    for name in ("all", "H", "W"):
        np.testing.assert_array_equal(tg.find(name).numpy(),
                                      np.asarray(jg.find(name)))
        assert tg.count(name) == jg.count(name)
    np.testing.assert_array_equal(tg.union("H", "W").numpy(),
                                  np.asarray(jg.union("H", "W")))
    np.testing.assert_allclose(
        float(Groups.masked_sum(torch.as_tensor(vals), tg.find("W"))),
        float(JGroups.masked_sum(jnp.asarray(vals), jg.find("W"))),
        rtol=1e-6)
    for g in (jg, tg):
        with pytest.raises(KeyError, match="cannot find group 'nope'"):
            g.find("nope")

    # check_finite names the same leaf: a state field, a dict entry
    x = rng.normal(size=(4, 3))
    jstate = jmake_state(x, box=[10.0, 10.0, 10.0], lam=[0.5])
    d = {k: v for k, v in fields_dict(jstate).items() if k != "key"}
    from constant_ph_tpu_torch import convert
    tstate = convert.system_state(d, device="cpu")
    jcheck_finite(jstate)
    check_finite(tstate)
    bad_v = np.array(d["v"])
    bad_v[1, 2] = np.nan
    cases = [
        (jstate.replace(v=jnp.asarray(bad_v)),
         dataclasses.replace(tstate, v=torch.as_tensor(bad_v)), "state"),
        ({"a": [jnp.ones(2), jnp.array([jnp.inf])]},
         {"a": [torch.ones(2), torch.tensor([float("inf")])]}, "tree"),
    ]
    for jt, tt, name in cases:
        with pytest.raises(FloatingPointError) as je:
            jcheck_finite(jt, name)
        with pytest.raises(FloatingPointError) as te:
            check_finite(tt, name)
        assert str(te.value) == str(je.value)


def test_dcd_is_byte_identical_to_jax(tmp_path):
    rng = np.random.default_rng(1)
    frames = rng.uniform(0, 20, size=(4, 17, 3)).astype(np.float32)
    box = np.array([20.0, 21.0, 22.0])
    paths = {}
    for pkg, writer in (("jax", JDCDWriter), ("torch", DCDWriter)):
        for with_box in (True, False):
            path = str(tmp_path / f"{pkg}_{with_box}.dcd")
            with writer(path, 17, dt_fs=2.0, save_every=10) as w:
                for f in frames:
                    if pkg == "torch":     # tensors, as run blocks give
                        f = torch.as_tensor(f)
                    w.write_frame(f, box if with_box else None)
            paths[pkg, with_box] = path
    for with_box in (True, False):
        with open(paths["jax", with_box], "rb") as a, \
                open(paths["torch", with_box], "rb") as b:
            assert a.read() == b.read()
        for pkg in ("jax", "torch"):
            for reader in (jread_dcd, read_dcd):
                got, boxes = reader(paths[pkg, with_box])
                np.testing.assert_array_equal(got, frames)
                assert len(boxes) == (4 if with_box else 0)
    np.testing.assert_array_equal(read_dcd(paths["torch", True])[1][0], box)


def _jax_state():
    rng = np.random.default_rng(2)
    return jmake_state(rng.normal(size=(6, 3)),
                       v=rng.normal(size=(6, 3)), box=[11.0, 12.0, 13.0],
                       lam=[0.2, 0.7], v_lam=[0.01, -0.02], pH=4.5)


def test_jax_checkpoint_loads_in_port(tmp_path):
    js = _jax_state()
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, js)
    ts = checkpoint.load(path, device="cpu")
    for name, val in fields_dict(js).items():
        if name == "key":                  # read and dropped
            assert not hasattr(ts, "key")
            continue
        np.testing.assert_array_equal(getattr(ts, name).numpy(), val,
                                      err_msg=name)
    assert ts.step.dtype == torch.int32
    # a JAX file has no generator state: an exact resume cannot be had
    with pytest.raises(KeyError, match="generator"):
        checkpoint.load(path, device="cpu", generator=torch.Generator())
    # an append-after-save scalar is zero-filled; any other gap refused
    leaves = dict(np.load(path))
    for drop, ok in (("ext_work", True), ("x", False)):
        p = str(tmp_path / f"no_{drop}.npz")
        np.savez(p, **{k: v for k, v in leaves.items() if k != drop})
        if ok:
            assert float(checkpoint.load(p, device="cpu").ext_work) == 0.0
        else:
            with pytest.raises(KeyError, match="'x'"):
                checkpoint.load(p, device="cpu")
            with pytest.raises(KeyError, match="'x'"):
                jckpt.load(p)


def test_port_checkpoint_loads_in_jax_and_resumes_bitwise(tmp_path):
    # a port file in the JAX package's load
    path = str(tmp_path / "port.npz")
    ts = checkpoint.load(_write_jax(tmp_path), device="cpu")
    checkpoint.save(path, ts, generator=torch.Generator().manual_seed(3))
    back = jckpt.load(path)
    for f in dataclasses.fields(ts):
        if f.name == "step_host":        # the port's host copy of step
            assert ts.step_host == int(back.step)
            continue
        np.testing.assert_array_equal(np.asarray(getattr(back, f.name)),
                                      getattr(ts, f.name).numpy())
    assert back.key.shape == (2,) and back.key.dtype == jnp.uint32

    # save → load → run equals the in-memory run, Langevin noise included
    sys_ = solvated_acid(coul_style="dsf", alpha=0.2, device="cpu", **SYSTEM)
    tsys = split_system(sys_, device="cpu", **SPLIT)
    cfg = EngineConfig(dt=1.0, thermostat="langevin", T=300.0, gamma=0.01,
                       lambda_thermostat="langevin", rebuild_every=3)
    run = TiledEngine(tsys, cfg).make_run(6)
    gen = torch.Generator().manual_seed(11)
    st = run(to_tiled(tsys, sys_.state), gen)[0]
    canon = to_canonical(tsys, st)
    checkpoint.save(path, canon, generator=gen)
    gen_b = torch.Generator()
    loaded = checkpoint.load(path, device="cpu", generator=gen_b)
    a = run(to_tiled(tsys, canon), gen)
    b = run(to_tiled(tsys, loaded), gen_b)
    for name in ("wx", "wv", "sx", "sv", "lam", "v_lam", "ext_work"):
        assert torch.equal(getattr(a[0], name), getattr(b[0], name)), name
    for f in dataclasses.fields(a[2]):
        assert torch.equal(getattr(a[2], f.name), getattr(b[2], f.name))


def _write_jax(tmp_path):
    path = str(tmp_path / "jax_src.npz")
    jckpt.save(path, _jax_state())
    return path


def test_profiling_matches_jax_harness(tmp_path):
    """benchmark_run's accounting against the JAX harness on the same
    host-side run function; trace writes a Chrome trace; time_components
    times each thunk."""

    def run_fn(state, k):
        return (state + k,)

    kw = dict(n_calls=3, steps_per_call=10, dt_fs=2.0, warmup=1)
    got = profiling.benchmark_run(run_fn, torch.zeros(3), 1.0, **kw)
    ref = jprof.benchmark_run(run_fn, jnp.zeros(3), 1.0, **kw)
    assert got.keys() == ref.keys() and got["steps"] == ref["steps"] == 30
    for r in (got, ref):
        np.testing.assert_allclose(
            r["ns_per_day"], 30 * 2.0 / 1e6 / (r["wall_s"] / 86400.0))
        np.testing.assert_allclose(r["ms_per_step"], r["wall_s"] / 30 * 1e3)
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(64) @ torch.ones(64)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    times = profiling.time_components({"a": lambda: torch.ones(8).sum()},
                                      n_calls=2)
    assert set(times) == {"a"} and times["a"] >= 0.0
