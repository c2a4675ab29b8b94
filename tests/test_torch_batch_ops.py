"""Replicas as a batch dimension: the port's tile functions on a batch of
R = 3 distinct replicas against R single calls of the same functions.

The replicas (``replicas``, shared with the other test_torch_batch_*
files) are the dilute grid-4³ acid box of tests/test_pallas_ww.py with
seeded perturbations: water and solute positions moved by N(0, 0.03 Å),
each replica's box 0.2 % longer than the last, its own λ, pH and λ
velocity. A function that mixed replicas, or read replica 0's box for
all, would differ.

Tolerances: bitwise where the batch does the single call's elementwise
arithmetic on more rows (rebin's sort and row moves, tile SHAKE and
RATTLE, the buffer-water M-SHAKE / M-RATTLE); elsewhere the batch sums
in another order, and the bar is 1e-6 of the single call's max for
arrays and rtol 1e-6 for energies (water_solute_fast, solute_solute and
bonded_forces on the --small polypeptide of tests/test_torch_replica.py,
pme_recip_tiled on a fixed and on a live box).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from constant_ph_tpu.parallel import replica as jreplica
from constant_ph_tpu_torch.ops.bonded import bonded_forces
from constant_ph_tpu_torch.ops.pme import make_pme_params, pme_recip_tiled
from constant_ph_tpu_torch.parallel.replica import (
    stack_replicas, unstack_replicas)
from constant_ph_tpu_torch.systems.protein import solvated_polypeptide
from constant_ph_tpu_torch.tiled import forces as tf
from constant_ph_tpu_torch.tiled.layout import rebin, split_system, to_tiled
from constant_ph_tpu_torch.tiled.shake import TiledWaterShake

from test_torch_layout import jax_tiled, port_of

# one torch thread per xdist worker, as the other port tests
torch.set_num_threads(1)

R = 3
# tests/test_torch_replica.py's --small polypeptide: bonded terms of every
# family and 8 buffer waters a site
SMALL = dict(n_residues=8, sites_every=2, box_len=26.0, water_spacing=3.4,
             cutoff=6.0, skin=1.2, coul_style="dsf", alpha=0.2, pH=5.0,
             dq_scale=1.0, n_buffer_waters=8)


def replicas(jst, tst, n=R, seed=0, sigma=0.03):
    """n distinct replicas of one JAX TiledState and its port twin, as one
    JAX batch and one port batch with equal float32 values."""
    rng = np.random.default_rng(seed)
    live = np.repeat(np.asarray(jst.wvalid) > 0.5, 3, axis=-1)[None]
    f32 = np.float32
    jreps, treps = [], []
    for r in range(n):
        wx = np.asarray(jst.wx) + np.where(
            live, rng.normal(0.0, sigma, jst.wx.shape), 0.0)
        fields = dict(
            wx=wx.astype(f32),
            wv=(np.asarray(jst.wv) + np.where(
                live, rng.normal(0.0, 1e-3, jst.wv.shape), 0.0)).astype(f32),
            sx=(np.asarray(jst.sx)
                + rng.normal(0.0, sigma, jst.sx.shape)).astype(f32),
            box=(np.asarray(jst.box) * (1.0 + 0.002 * r)).astype(f32),
            lam=np.full(jst.lam.shape, 0.2 + 0.3 * r, f32),
            v_lam=rng.normal(0.0, 0.01, jst.lam.shape).astype(f32),
            pH=f32(4.0 + r))
        jreps.append(jst.replace(**{k: jnp.asarray(v)
                                    for k, v in fields.items()}))
        treps.append(dataclasses.replace(tst, **{
            k: torch.as_tensor(v) for k, v in fields.items()}))
    return jreplica.stack_replicas(jreps), stack_replicas(treps)


def close_to_singles(batch_out, singles, name, atol=1e-6, rtol=1e-6):
    """Each replica's slice of a batched output against its single call:
    arrays within atol of the single's max, 0-d values within rtol."""
    for r, ref in enumerate(singles):
        got = batch_out[r]
        if ref.ndim == 0:
            np.testing.assert_allclose(float(got), float(ref), rtol=rtol,
                                       err_msg=f"{name}[{r}]")
        else:
            scale = max(1.0, float(ref.abs().max()))
            np.testing.assert_allclose(got.numpy() / scale,
                                       ref.numpy() / scale, atol=atol,
                                       err_msg=f"{name}[{r}]")


@pytest.fixture(scope="module")
def acid():
    _, jts, jst = jax_tiled("dsf", 0.2)
    tts, tst = port_of(jts, jst)
    return tts, replicas(jst, tst)[1]


@pytest.fixture(scope="module")
def peptide():
    sys_ = solvated_polypeptide(device="cpu", **SMALL)
    ts = split_system(sys_, device="cpu", skin=1.2, tile_safety=1.72)
    st = to_tiled(ts, sys_.state)
    rng = np.random.default_rng(1)
    reps = [dataclasses.replace(st, sx=st.sx + torch.as_tensor(
        rng.normal(0.0, 0.03, st.sx.shape), dtype=st.sx.dtype),
        box=st.box * (1.0 + 0.002 * r)) for r in range(R)]
    return ts, stack_replicas(reps)


def test_rebin_batch_is_bitwise_per_replica(acid):
    tts, batch = acid
    p = tts.params
    # move a molecule of replica 1 a whole cell, so the replicas' tiles
    # differ after the rebin
    wx = batch.wx.clone()
    wx[1, 0, :, :3] += p.cutoff + p.skin
    batch = dataclasses.replace(batch, wx=wx)
    got, ov = rebin(batch, p)
    assert ov.shape == (R,)
    for r, st in enumerate(unstack_replicas(batch)):
        want, ov_r = rebin(st, p)
        assert bool(ov[r]) == bool(ov_r)
        for name in ("wx", "wv", "wvalid", "wid"):
            assert torch.equal(getattr(got, name)[r], getattr(want, name)), \
                (name, r)
    assert not torch.equal(got.wid[0], got.wid[1])


def test_constraints_batch_is_bitwise_per_replica(acid, peptide):
    tts, batch = acid
    shake = TiledWaterShake(tts.water)
    dt = 2.0
    moved = batch.wx + dt * batch.wv
    pos = shake.positions(batch.wx, moved, batch.wv, batch.box, dt,
                          batch.wvalid)
    vel = shake.velocities(pos[0], pos[1], batch.box, batch.wvalid)
    for r in range(R):
        x1, v1 = shake.positions(batch.wx[r], moved[r], batch.wv[r],
                                 batch.box[r], dt, batch.wvalid[r])
        assert torch.equal(pos[0][r], x1) and torch.equal(pos[1][r], v1)
        assert torch.equal(vel[r], shake.velocities(
            x1, v1, batch.box[r], batch.wvalid[r]))
    # the buffer waters' M-SHAKE / M-RATTLE on the polypeptide's solute
    ts, pb = peptide
    sc = ts.solute_constraints
    assert sc.triplets.shape[0] >= 8
    sv = torch.as_tensor(np.random.default_rng(2).normal(
        0.0, 0.01, pb.sx.shape), dtype=pb.sx.dtype)
    x2, v2 = sc.positions(pb.sx, pb.sx + dt * sv, sv, pb.box, dt)
    v3 = sc.velocities(x2, v2, pb.box)
    for r in range(R):
        xs, vs = sc.positions(pb.sx[r], pb.sx[r] + dt * sv[r], sv[r],
                              pb.box[r], dt)
        assert torch.equal(x2[r], xs) and torch.equal(v2[r], vs)
        assert torch.equal(v3[r], sc.velocities(xs, vs, pb.box[r]))


def test_solute_blocks_batch_match_singles(acid, peptide):
    tts, batch = acid
    p = tts.params
    kw = dict(style=tts.coul_style, alpha=tts.alpha, rc=tts.cutoff)
    wxg = batch.wx.reshape((R, 3) + p.grid + (3 * p.W,))
    qs = batch.sx.new_tensor(np.random.default_rng(3).normal(
        0.0, 0.4, batch.sx.shape[:2]))
    names = ("e_lj", "e_coul", "f_w", "f_s", "phi_s")
    got = tf.water_solute_fast(wxg, batch.sx, qs, tts.solute, tts.water, p,
                               batch.box, **kw)
    singles = [tf.water_solute_fast(wxg[r], batch.sx[r], qs[r], tts.solute,
                                    tts.water, p, batch.box[r], **kw)
               for r in range(R)]
    for k, name in enumerate(names):
        close_to_singles(got[k], [s[k] for s in singles], name)
    got = tf.solute_solute(batch.sx, qs, tts.solute, batch.box, **kw)
    for k, name in enumerate(("e_lj", "e_coul", "f", "eatom", "phi")):
        close_to_singles(got[k], [tf.solute_solute(
            batch.sx[r], qs[r], tts.solute, batch.box[r], **kw)[k]
            for r in range(R)], f"solute_solute {name}")
    ts, pb = peptide
    e, f, eatom = bonded_forces(pb.sx, pb.box, ts.bonded)
    assert e.shape == (R,)
    singles = [bonded_forces(pb.sx[r], pb.box[r], ts.bonded)
               for r in range(R)]
    for k, (name, out) in enumerate(zip(("e", "f", "eatom"),
                                        (e, f, eatom))):
        close_to_singles(out, [s[k] for s in singles], f"bonded {name}")
    assert float(torch.abs(e[0] - e[1])) > 1e-3


def test_pme_batch_matches_singles(acid):
    tts, batch = acid
    for live_box in (False, True):
        _pme_batch_matches_singles(tts, batch, live_box)


def _pme_batch_matches_singles(tts, batch, live_box):
    p = tts.params
    pp = make_pme_params(batch.box[0].numpy(), p.grid, 0.35, spacing=1.0,
                         device="cpu")
    wxg = batch.wx.reshape((R, 3) + p.grid + (3 * p.W,))
    vm = torch.repeat_interleave(batch.wvalid, 3, dim=-1)
    q_pat = torch.as_tensor(np.tile(tts.water.q_pattern, p.W),
                            dtype=torch.float32)
    wq = (q_pat * vm).reshape((R,) + p.grid + (3 * p.W,))
    qs = tts.solute.q0 * tts.solute.smask * (1.0 + 0.1 * torch.arange(
        R, dtype=torch.float32))[:, None]
    box = batch.box if live_box else None
    got = pme_recip_tiled(wxg, wq, batch.sx, qs, pp, need_water_phi=True,
                          box=box)
    singles = [pme_recip_tiled(
        wxg[r], wq[r], batch.sx[r], qs[r], pp, need_water_phi=True,
        box=None if box is None else box[r]) for r in range(R)]
    for k, name in enumerate(("e", "fw", "fs", "phi_s", "phi_w")):
        close_to_singles(got[k], [s[k] for s in singles], name)
    if live_box:
        assert float(torch.abs(got[0][0] - got[0][2])) > 1e-3
