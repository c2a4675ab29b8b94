"""Parity of the PyTorch port's builder and tile layout with the JAX package.

Same system, same seed: the builders must place every atom at the same
float32 coordinates, split_system must build equal tables, and to_tiled /
rebin must fill the tiles slot for slot (coordinates, velocities, wid,
wvalid and the overflow flag) — exact equality, no tolerance.

Also holds the helpers that flatten JAX objects to numpy dicts for
constant_ph_tpu_torch.convert (imported by the other test_torch_* files).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from constant_ph_tpu.systems.water import solvated_acid as jax_solvated_acid
from constant_ph_tpu.systems.water import water_box as jax_water_box
from constant_ph_tpu.tiled import layout as jl
from constant_ph_tpu_torch import convert
from constant_ph_tpu_torch.systems.water import solvated_acid, water_box
from constant_ph_tpu_torch.tiled import layout as tl

# the suite runs six xdist workers on the same cores: one torch thread
# each keeps the port tests from oversubscribing them
torch.set_num_threads(1)

# the dilute grid-4³ box of tests/test_pallas_ww.py; tile_safety 0.2 keeps
# W at 20 (A = 60) so every block stays small on the CPU
SYSTEM = dict(n_side=8, spacing=6.4, rigid_water=True, lambda_coupled=True,
              cutoff=8.0, seed=12, pH=5.0)
SPLIT = dict(skin=2.0, tile_safety=0.2)


def fields_dict(obj):
    """A JAX struct dataclass → {field: np.ndarray}."""
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def jax_tiled_system_dict(ts):
    """A JAX TiledSystem → the numpy dict convert.tiled_system takes."""
    p, wm, sc = ts.params, ts.water, ts.solute_constraints
    return dict(
        params=dict(grid=p.grid, W=p.W, half_stencil=p.half_stencil,
                    cutoff=p.cutoff, skin=p.skin),
        water=dict(qO=wm.q_pattern[0], qH=wm.q_pattern[1], c6_OO=wm.c6_OO,
                   c12_OO=wm.c12_OO, eshift_OO=wm.eshift_OO, d_OH=wm.d_OH,
                   d_HH=wm.d_HH, mO=wm.mass_pattern[0],
                   mH=wm.mass_pattern[1]),
        solute=fields_dict(ts.solute),
        spec=None if ts.spec is None else fields_dict(ts.spec),
        bonded=None if ts.bonded is None else fields_dict(ts.bonded),
        solute_constraints=None if sc is None else dict(
            triplets=np.asarray(sc.triplets),
            masses=np.asarray(ts.solute.mass), d01=wm.d_OH, d12=wm.d_HH),
        groupH_mask=np.asarray(ts.groupH_mask),
        water_atom_ids=ts.water_atom_ids, solute_ids=ts.solute_ids,
        n_atoms=ts.n_atoms, coul_style=ts.coul_style, alpha=ts.alpha,
        cutoff=ts.cutoff)


def jax_tiled(style="dsf", alpha=0.2):
    """JAX-built (system, TiledSystem, TiledState) on the test box."""
    sys_ = jax_solvated_acid(skin=2.0, coul_style=style, alpha=alpha,
                             **SYSTEM)
    ts = jl.split_system(sys_, **SPLIT)
    return sys_, ts, jl.to_tiled(ts, sys_.state)


def port_of(ts, tst):
    """The same TiledSystem / TiledState in the port, on the CPU."""
    return (convert.tiled_system(jax_tiled_system_dict(ts), device="cpu"),
            convert.tiled_state(fields_dict(tst), device="cpu"))


def assert_same_tiles(jst, tst):
    for name in ("wx", "wv", "wvalid", "wid", "sx", "sv"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)


@pytest.fixture(scope="module")
def built():
    jsys, jts, jst = jax_tiled()
    tsys = solvated_acid(coul_style="dsf", alpha=0.2, device="cpu", **SYSTEM)
    return jsys, jts, jst, tsys


def test_builder_matches_jax(built):
    jsys, _, _, tsys = built
    np.testing.assert_array_equal(tsys.state.x.numpy(),
                                  np.asarray(jsys.state.x))
    for name in ("mass", "q0", "type"):
        np.testing.assert_array_equal(getattr(tsys.ff, name).numpy(),
                                      np.asarray(getattr(jsys.ff, name)))
    np.testing.assert_array_equal(tsys.ff.excl_idx,
                                  np.asarray(jsys.ff.excl_idx))
    np.testing.assert_array_equal(tsys.ff.excl_code,
                                  np.asarray(jsys.ff.excl_code))
    for name, val in fields_dict(jsys.spec).items():
        np.testing.assert_array_equal(getattr(tsys.spec, name).numpy(), val,
                                      err_msg=name)
    for name, val in fields_dict(jsys.bonded).items():
        np.testing.assert_array_equal(getattr(tsys.bonded, name).numpy(),
                                      val, err_msg=name)
    # the pure-water variant builds the same positions too
    jw = jax_water_box(n_side=6, seed=3, skin=1.0)
    tw = water_box(n_side=6, seed=3, skin=1.0, device="cpu")
    np.testing.assert_array_equal(tw.state.x.numpy(), np.asarray(jw.state.x))
    np.testing.assert_array_equal(tw.spec.dq.numpy(), np.asarray(jw.spec.dq))
    # the reference engine's neighbour sizing, field by field
    for j, t in ((jsys, tsys), (jw, tw)):
        for f in dataclasses.fields(j.nbr_params):
            assert getattr(t.nbr_params, f.name) == getattr(j.nbr_params,
                                                            f.name), f.name
    assert tw.nbr_params.skin == 1.0
    # velocities come from the port's own generator: same distribution,
    # zero total momentum
    v, m = tsys.state.v, tsys.ff.mass
    assert torch.isfinite(v).all()
    assert torch.abs((m[:, None] * v).sum(0)).max() < 1e-3


def test_split_system_tables_match(built):
    _, jts, _, tsys = built
    tts = tl.split_system(tsys, device="cpu", **SPLIT)
    assert tts.params == tl.TileParams(**dataclasses.asdict(jts.params))
    assert vars(tts.water) == vars(jts.water)
    for name, val in fields_dict(jts.solute).items():
        np.testing.assert_array_equal(getattr(tts.solute, name).numpy(), val,
                                      err_msg=name)
    for name, val in fields_dict(jts.spec).items():
        np.testing.assert_array_equal(getattr(tts.spec, name).numpy(), val,
                                      err_msg=name)
    for name, val in fields_dict(jts.bonded).items():
        np.testing.assert_array_equal(getattr(tts.bonded, name).numpy(),
                                      val, err_msg=name)
    np.testing.assert_array_equal(tts.groupH_mask.numpy(),
                                  np.asarray(jts.groupH_mask))
    np.testing.assert_array_equal(tts.water_atom_ids, jts.water_atom_ids)
    np.testing.assert_array_equal(tts.solute_ids, jts.solute_ids)
    jsc, tsc = jts.solute_constraints, tts.solute_constraints
    np.testing.assert_array_equal(tsc.triplets.numpy(),
                                  np.asarray(jsc.triplets))
    np.testing.assert_array_equal(tsc.W.numpy(), np.asarray(jsc.W))
    np.testing.assert_array_equal(tsc.inv_m.numpy(), np.asarray(jsc.inv_m))
    assert (tts.coul_style, tts.alpha, tts.cutoff) == (
        jts.coul_style, jts.alpha, jts.cutoff)


def test_to_tiled_slot_for_slot(built):
    jsys, jts, jst, tsys = built
    tts = tl.split_system(tsys, device="cpu", **SPLIT)
    # the JAX state's velocities, so wv/sv compare too
    state = convert.system_state(
        {k: v for k, v in fields_dict(jsys.state).items() if k != "key"},
        device="cpu")
    assert_same_tiles(jst, tl.to_tiled(tts, state))
    # and back: to_canonical inverts to_tiled up to the box wrap
    back = tl.to_canonical(tts, tl.to_tiled(tts, state))
    d = back.x.numpy() - state.x.numpy()
    box = state.box.numpy()
    np.testing.assert_allclose(d - box * np.round(d / box), 0.0, atol=1e-5)
    np.testing.assert_array_equal(back.v.numpy(), state.v.numpy())


def _perturbed(jst, jts, fill_cell):
    """Tiles after random rigid moves of every molecule by up to ±2.5 Å
    (many cross cells, some the box seam); or, with ``fill_cell``,
    molecules moved into cell 0 until it holds exactly W — the capacity
    flag trips one slot early, before any row is dropped."""
    p = jts.params
    G, W = p.G, p.W
    rng = np.random.default_rng(7)
    wx = np.asarray(jst.wx).copy().reshape(3, G, W, 3)
    valid = np.asarray(jst.wvalid) > 0.5
    if not fill_cell:
        shift = rng.uniform(-2.5, 2.5, size=(3, G, W, 1))
        wx = np.where(valid[None, :, :, None], wx + shift, wx)
    else:
        box = np.asarray(jst.box)
        cell = box / np.array(p.grid)
        n0 = int(valid[0].sum())
        movers = [(c, s) for c in range(1, G) for s in range(W)
                  if valid[c, s]][:W - n0]
        for k, (c, s) in enumerate(movers):
            cen = wx[:, c, s, :].mean(axis=1)
            target = cell * (0.2 + 0.6 * rng.uniform(size=3))
            wx[:, c, s, :] += (target - cen)[:, None]
    return jst.replace(wx=jnp.asarray(wx.reshape(3, G, 3 * W)))


@pytest.mark.parametrize("fill_cell", [False, True])
def test_rebin_slot_for_slot(built, fill_cell):
    _, jts, jst, _ = built
    jst = _perturbed(jst, jts, fill_cell)
    tts, tst = port_of(jts, jst)
    jnew, jov = jl.rebin(jst, jts.params)
    tnew, tov = tl.rebin(tst, tts.params)
    assert bool(tov) == bool(jov) == fill_cell
    assert_same_tiles(jnew, tnew)
    assert int(tnew.wvalid.sum()) == len(jts.water_atom_ids)


def test_retile_matches(built):
    _, jts, jst, _ = built
    tts, tst = port_of(jts, jst)
    W = int(np.asarray(jst.wvalid).sum(axis=1).max()) + 4
    jts2, jst2 = jl.retile(jts, jst, W)
    tts2, tst2 = tl.retile(tts, tst, W)
    assert tts2.params.W == jts2.params.W
    assert_same_tiles(jst2, tst2)


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        assert solvated_acid(n_side=3).state.x.is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            solvated_acid(n_side=3)
