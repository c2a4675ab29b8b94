"""The port's elastic driver and its retile rule:

- ``tiled.layout.retile_auto`` takes W = occupancy + margin_min rounded up
  to 4, lays the tiles out exactly as the JAX package's ``retile`` does at
  that W, and refuses past the kernels' W_MAX 252;
- ``tiled.elastic.elastic_run`` started one slot too small retiles on the
  capacity flag and redoes the chunk from its start state with the
  chunk's noise: bit for bit the run started at the larger W, no molecule
  lost, the retile counted.

No JAX run loop is compiled here.
"""
import numpy as np
import pytest
import torch

from constant_ph_tpu.tiled import layout as jl
from constant_ph_tpu_torch.engine import EngineConfig
from constant_ph_tpu_torch.systems.water import solvated_acid
from constant_ph_tpu_torch.tiled.elastic import elastic_run
from constant_ph_tpu_torch.tiled.layout import (
    W_MAX, retile, retile_auto, split_system, to_canonical, to_tiled)

from test_torch_layout import (
    SPLIT, SYSTEM, assert_same_tiles, jax_tiled, port_of)

torch.set_num_threads(1)


def test_retile_auto_matches_jax_retile():
    _, jts, jst = jax_tiled()
    tts, tst = port_of(jts, jst)
    occ = int(tst.wvalid.sum(dim=1).max())
    ts2, st2 = retile_auto(tts, tst, occ, margin_min=6)
    assert ts2.params.W == -(-(occ + 6) // 4) * 4
    jts2, jst2 = jl.retile(jts, jst, ts2.params.W)
    assert jts2.params.W == ts2.params.W
    assert_same_tiles(jst2, st2)
    for name in ("phi_recip_s", "metad_v", "metad_dv"):
        assert torch.equal(getattr(st2, name), getattr(tst, name))
    assert st2.step_host == tst.step_host
    with pytest.raises(ValueError, match=str(W_MAX)):
        retile_auto(tts, tst, W_MAX - 5, margin_min=6)


def _one_slot_short():
    """The dilute test box with its fullest cell topped up to a multiple
    of 4 molecules (molecules moved in from other cells to free spots),
    tiled at exactly that W: the first rebin trips the capacity flag."""
    sys_ = solvated_acid(coul_style="dsf", alpha=0.2, device="cpu", **SYSTEM)
    ts = split_system(sys_, device="cpu", **SPLIT)
    st = to_tiled(ts, sys_.state)
    occ = st.wvalid.sum(dim=1)
    cell = int(torch.argmax(occ))
    add = -int(occ[cell]) % 4
    x = sys_.state.x.double().numpy()
    box = sys_.state.box.double().numpy()
    lo = np.array(np.unravel_index(cell, ts.params.grid)) * (
        box / np.array(ts.params.grid))
    size = box / np.array(ts.params.grid)
    rng = np.random.default_rng(5)
    ids = ts.water_atom_ids
    in_cell = set(st.wid[cell][st.wvalid[cell] > 0].tolist())
    movers = [m for m in range(len(ids)) if m not in in_cell][:add]
    for m in movers:
        mol = x[ids[m]]
        while True:
            c = lo + size * rng.uniform(0.25, 0.75, 3)
            new = mol - mol.mean(0) + c
            d = new[:, None, :] - np.delete(x, ids[m], axis=0)[None]
            d -= box * np.round(d / box)
            if np.sqrt((d * d).sum(-1)).min() > 3.0:
                break
        x[ids[m]] = new
    state = sys_.state
    state.x = torch.as_tensor(x, dtype=torch.float32)
    W0 = int(occ[cell]) + add
    return retile(ts, to_tiled(ts, state), W0)


def test_elastic_redo_equals_run_at_larger_w():
    ts0, st0 = _one_slot_short()
    W0 = ts0.params.W
    assert int(st0.wvalid.sum(dim=1).max()) == W0
    cfg = EngineConfig(dt=1.0, thermostat="langevin", T=300.0, gamma=0.01,
                       lambda_thermostat="langevin", rebuild_every=4)
    frames = []

    def on_chunk(done, ts, tst, obs):
        frames.append((done, ts.params.W, to_canonical(ts, tst).x))

    ts_e, st_e, obs_e, info = elastic_run(
        ts0, st0, cfg, 16, chunk=8, on_chunk=on_chunk,
        generator=torch.Generator().manual_seed(9))
    W1 = -(-(W0 + 6) // 4) * 4
    assert (info.n_retiles, info.retile_steps, info.final_W) == (1, [0], W1)
    assert [(d, w) for d, w, _ in frames] == [(8, W1), (16, W1)]
    assert int(st_e.wvalid.sum()) == len(ts0.water_atom_ids)
    assert obs_e.temp.shape[0] == 16

    ts1, st1 = retile(ts0, st0, W1)
    ts_d, st_d, obs_d, info_d = elastic_run(
        ts1, st1, cfg, 16, chunk=8,
        generator=torch.Generator().manual_seed(9))
    assert info_d.n_retiles == 0
    for name in ("wx", "wv", "wvalid", "wid", "sx", "sv", "lam", "v_lam",
                 "ext_work"):
        assert torch.equal(getattr(st_e, name), getattr(st_d, name)), name
    for name in ("e_pot", "temp", "h_conserved", "lam"):
        assert torch.equal(getattr(obs_e, name), getattr(obs_d, name)), name
