"""Parity of the port's MC barostat (tiled/npt.py) with the JAX package's
on the small solvated acid of tests/test_npt.py, at n_side 9 so the grid
is 3 cells a dimension (the port's hot path on the CPU runs K1's plain
version there):

- make_mc_barostat fed the JAX move's own uniforms: the same accept flag,
  box and scaled positions to float32 rounding (a few ulp: 1e-5 Å, or
  3e-7 of the ~1e4 Å coordinates of parked slots), and ΔH from each
  package's energies within 3e-3 kcal/mol (0.005 kT). ΔH is a difference
  of two ~800 kcal/mol float32 energy totals that each package sums over
  ~10⁵ pair terms in its own order: they differ by up to 9e-4 kcal/mol
  between the packages here, and ΔH by 1.0e-3 and 1.5e-3 on the two
  accepted moves (the packages' energy bar, rtol 1e-5 in
  tests/test_torch_engine.py, would allow 1.6e-2);
- make_pressure_fn against the JAX pressure;
- _check_npt_kspace refuses baked-box PME; npt_elastic_run keeps its
  drift guard and counts its moves.

The one JAX function compiled here holds every JAX force evaluation: the
barostat move, the energies before and after it, and the pressure.
"""
import numpy as np
import jax
import pytest
import torch

from constant_ph_tpu import units
from constant_ph_tpu.engine import EngineConfig as JConfig
from constant_ph_tpu.systems.water import solvated_acid as jsolvated_acid
from constant_ph_tpu.tiled import layout as jl
from constant_ph_tpu.tiled import npt as jnpt
from constant_ph_tpu.tiled.engine import TiledEngine as JEngine
from constant_ph_tpu_torch.engine import EngineConfig
from constant_ph_tpu_torch.ops.pme import make_pme_params
from constant_ph_tpu_torch.tiled import npt
from constant_ph_tpu_torch.tiled.engine import TiledEngine

from test_torch_layout import port_of

torch.set_num_threads(1)

BUILD = dict(n_side=9, rigid_water=True, lambda_coupled=True, cutoff=6.0,
             skin=1.5, coul_style="dsf", alpha=0.2, seed=9, pH=5.0)
CFG = dict(dt=1.0, thermostat="langevin", rebuild_every=10)
P_ATM, T, DLNV = 1.0, 300.0, 0.02
KEYS = (0, 1, 2, 3)


@pytest.fixture(scope="module")
def moves():
    """Both packages on the same tiles; the JAX move on each key, with the
    energies before and after it and the pressure, from one compile."""
    jsys = jsolvated_acid(**BUILD)
    jts = jl.split_system(jsys, skin=1.5)
    jst = jl.to_tiled(jts, jsys.state)
    assert jts.params.grid == (3, 3, 3)
    jeng = JEngine(jts, JConfig(**CFG))
    move = jnpt.make_mc_barostat(jeng, pressure_atm=P_ATM, T=T,
                                 max_dlnV=DLNV)
    pressure = jnpt.make_pressure_fn(jeng, T=T)

    @jax.jit
    def jax_side(tst, key):
        out, acc = move(tst, key)
        return (out, acc, jeng.compute_forces(tst).e_pot,
                jeng.compute_forces(out).e_pot, pressure(tst))

    ts, st = port_of(jts, jst)
    eng = TiledEngine(ts, EngineConfig(**CFG))
    return jst, [jax_side(jst, jax.random.PRNGKey(k)) for k in KEYS], ts, \
        st, eng


def _uniforms(k):
    """The JAX move's two draws for key k (tiled/npt.py: split, then one
    uniform from each half)."""
    k_prop, k_acc = jax.random.split(jax.random.PRNGKey(k))
    return (float(jax.random.uniform(k_prop)),
            float(jax.random.uniform(k_acc)))


def _dH(e0, e1, box0, box1, n_mol):
    """ΔH of a move from its energies and boxes (float64)."""
    v0, v1 = np.prod(box0), np.prod(box1)
    dln = np.log(v1 / v0)
    kT = units.BOLTZ * T
    return ((e1 - e0) + P_ATM * units.ATM_A3_TO_KCAL * (v1 - v0)
            - (n_mol + 1.0) * kT * dln)


def test_mc_move_matches_jax_with_its_uniforms(moves):
    jst, jout, ts, st, eng = moves
    move = npt.make_mc_barostat(eng, pressure_atm=P_ATM, T=T, max_dlnV=DLNV)
    n_mol = float(st.wvalid.sum()) + npt._Scaler(eng).n_mol_static
    e0 = float(eng.compute_forces(st).e_pot)
    flags = []
    for k, (jo, jacc, je0, je1, _) in zip(KEYS, jout):
        out, acc = move(st, u=_uniforms(k))
        flags.append(bool(jacc))
        assert bool(acc) == bool(jacc), k
        np.testing.assert_allclose(out.box.numpy(), np.asarray(jo.box),
                                   rtol=2e-7)
        for name in ("wx", "sx"):
            np.testing.assert_allclose(getattr(out, name).numpy(),
                                       np.asarray(getattr(jo, name)),
                                       rtol=3e-7, atol=1e-5, err_msg=name)
        if bool(jacc):
            # ΔH of the accepted move from each package's energies
            e1 = float(eng.compute_forces(out).e_pot)
            b0 = np.asarray(jst.box, np.float64)
            b1 = np.asarray(jo.box, np.float64)
            assert abs(_dH(e0, e1, b0, b1, n_mol)
                       - _dH(float(je0), float(je1), b0, b1, n_mol)) < 3e-3
        else:
            assert torch.equal(out.wx, st.wx) and torch.equal(out.box,
                                                              st.box)
    assert True in flags


def test_pressure_matches_jax(moves):
    _, jout, _, st, eng = moves
    p = float(npt.make_pressure_fn(eng, T=T)(st))
    assert np.isfinite(p)
    np.testing.assert_allclose(p, float(jout[0][4]), rtol=2e-3, atol=5.0)


def test_npt_guards_and_elastic_loop(moves):
    _, _, ts, st, eng = moves
    # PME with a baked box is refused, the live box taken; as in JAX
    pme = make_pme_params(st.box.numpy(), ts.params.grid, 0.3, skin=1.5,
                          spacing=1.5, p=6, device="cpu")
    baked = TiledEngine(ts, EngineConfig(**CFG), kspace_ep=pme)
    for make in (npt.make_mc_barostat, npt.make_pressure_fn):
        kw = dict(pressure_atm=P_ATM) if make is npt.make_mc_barostat else {}
        with pytest.raises(NotImplementedError, match="kspace_live_box"):
            make(baked, T=T, **kw)
    live = TiledEngine(ts, EngineConfig(kspace_live_box=True, **CFG),
                       kspace_ep=pme)
    npt.make_mc_barostat(live, pressure_atm=P_ATM, T=T)
    # the molecule groups: the acid, then each buffer water
    onehot, n_g = npt._solute_groups(ts)
    assert onehot.shape == (ts.solute.q0.shape[0], n_g)
    np.testing.assert_array_equal(onehot.sum(axis=1), 1.0)

    # a chunk of 5 steps and its move; again with a drift guard of 1e-9,
    # which stops the run there if the move was accepted
    kw = dict(pressure_atm=P_ATM, chunk=5, max_dlnV=DLNV, seed=4)
    cfg = EngineConfig(**dict(CFG, rebuild_every=5))
    _, st2, obs, info, stats = npt.npt_elastic_run(ts, st, cfg, 5, **kw)
    assert stats["proposed"] == 1 and len(stats["volume"]) == 1
    assert obs.temp.shape[0] == 5 and info.n_retiles == 0
    assert int(st2.wvalid.sum()) == int(st.wvalid.sum())
    if stats["accepted"]:
        with pytest.raises(RuntimeError, match="drifted"):
            npt.npt_elastic_run(ts, st, cfg, 5, max_box_drift=1e-9, **kw)
