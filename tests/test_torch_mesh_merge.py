"""The port's cross-rank hill merges (metad.make_mesh_walker_merge and
make_mesh_group_merge over torch.distributed, here 2 ranks of gloo,
spawned, the port only) against the JAX package's serial frozen merge on
the inputs of tests/test_metad.py:329 and :367, at that file's bars (V
rtol/atol 1e-5, dV 1e-4), and against the port's one-process
deposit_frozen sum; every rank gets the same tables, and walkers that do
not split over the ranks are refused."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from constant_ph_tpu import metad as jmetad
from constant_ph_tpu_torch import metad
from constant_ph_tpu_torch.parallel import comm

import torch_ranks as tr


def _fields(p):
    return {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}


def _walker_inputs():
    # tests/test_metad.py:329-344
    S, W, K = 3, 8, 2
    p = jmetad.MetadParams(nbins=121, sigma=0.05, h0=0.3, gamma=12.0,
                           stride=10)
    rng = np.random.default_rng(7)
    V, dV = jmetad.init_tables(S, p)
    warm = jnp.asarray(rng.uniform(0.1, 0.9, (20, S)).astype(np.float32))
    V, dV = jmetad.deposit_many(V, dV, warm, p)
    seq = rng.uniform(0.0, 1.0, (W, K, S)).astype(np.float32)
    return p, np.asarray(V), np.asarray(dV), seq


def _group_inputs():
    # tests/test_metad.py:367-386
    G, S, W, K = 3, 2, 4, 2
    p = jmetad.MetadParams(nbins=81, sigma=0.05, h0=0.3, gamma=12.0,
                           stride=10)
    rng = np.random.default_rng(11)
    Vs, dVs = [], []
    for g in range(G):
        V, dV = jmetad.init_tables(S, p)
        warm = jnp.asarray(
            rng.uniform(0.1, 0.9, (10 + 5 * g, S)).astype(np.float32))
        V, dV = jmetad.deposit_many(V, dV, warm, p)
        Vs.append(np.asarray(V))
        dVs.append(np.asarray(dV))
    seq = rng.uniform(0.0, 1.0, (G, W, K, S)).astype(np.float32)
    return p, np.stack(Vs), np.stack(dVs), seq


def _serial(p, V, dV, seq):
    """JAX's serial frozen merge and the port's one-process sum."""
    S = seq.shape[-1]
    dVt, ddVt = jmetad.deposit_frozen(jnp.asarray(V), jnp.asarray(dV),
                                      jnp.asarray(seq.reshape(-1, S)), p)
    pt = metad.MetadParams(**_fields(p))
    tVt, tdVt = metad.deposit_frozen(torch.tensor(V), torch.tensor(dV),
                                     torch.tensor(seq.reshape(-1, S)), pt)
    return ((V + np.asarray(dVt), dV + np.asarray(ddVt)),
            (V + tVt.numpy(), dV + tdVt.numpy()))


def _check(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def merged(tmp_path_factory):
    """One spawn of 2 ranks: both merges and the refusal."""
    pw, Vw, dVw, seqw = _walker_inputs()
    pg, Vg, dVg, seqg = _group_inputs()
    ranks = comm.run_ranks(
        tr.merges, 2, ((Vw, dVw, seqw, _fields(pw)),
                       (Vg, dVg, seqg, _fields(pg)),
                       (Vg, dVg, seqg[:, :3], _fields(pg))),
        init_dir=tmp_path_factory.mktemp("merge"))
    return (pw, Vw, dVw, seqw), (pg, Vg, dVg, seqg), ranks


def test_mesh_walker_merge_matches_serial_frozen_merge(merged):
    (p, V, dV, seq), _, ranks = merged
    jax_ref, port_ref = _serial(p, V, dV, seq)
    for out in ranks:
        tr.assert_tree_equal(out["walker"], ranks[0]["walker"])
        _check(out["walker"], jax_ref)
        _check(out["walker"], port_ref)


def test_mesh_group_merge_matches_serial_frozen_merge(merged):
    _, (p, V, dV, seq), ranks = merged
    for out in ranks:
        tr.assert_tree_equal(out["group"], ranks[0]["group"])
        for g in range(V.shape[0]):
            jax_ref, port_ref = _serial(p, V[g], dV[g], seq[g])
            _check((out["group"][0][g], out["group"][1][g]), jax_ref)
            _check((out["group"][0][g], out["group"][1][g]), port_ref)


def test_mesh_merge_refuses_walkers_that_do_not_split(merged):
    for out in merged[2]:
        assert "do not split over 2 ranks" in out["uneven"]
