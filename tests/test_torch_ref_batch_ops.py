"""The reference engine's ops on a replica batch against ``jax.vmap`` of the
JAX package's, on R = 3 seeded replicas of a 1,537-atom box (solvated_acid
n_side 8, rc 6, skin 1.5: the cell path on a 3³ grid), each with its own
positions (the base state moved by up to ±0.3 Å a coordinate), λ and pH.

- build_neighbor_list on (R, N, 3) in one pass: each row holds JAX's
  neighbour ids with JAX's special-bond codes (rows compared sorted by
  id: torch.topk and jax.lax.top_k may order equal distances otherwise),
  and each replica's list is bitwise the port's single build of it. With
  the list capacity cut to the largest row of the first two replicas, the
  third (compressed by 8 %) overflows alone, in both packages.
- needs_rebuild (R,) at skin/2 ± 1e-3 Å, one replica across the box
  boundary; select keeps each replica's own list unless its own trigger
  fired.
- pair_forces on the batch (DSF α 0.2, and 'cut' α 0.35 for Ewald real
  space) on JAX's lists: forces, φ and eatom within 1e-5 of their max
  and the virial (R,) within rtol 1e-5 (the bars of
  tests/test_torch_pair_ewald.py); energies (R,) within 1e-6 of the
  energy scale Σ|eatom| (the bar of tests/test_torch_ref_engine.py: a
  DSF e_coul of 19.26 kcal/mol read 2.2e-5 off JAX's in relative terms,
  4.3e-4 kcal/mol of a scale of ~8,000); each replica bitwise its single
  call (gathers, elementwise terms and row sums: the same arithmetic).
- ewald_recip on the batch: energies (R,) rtol 1e-5, forces, φ and eatom
  within 1e-5 of their max; each replica within 1e-6 of its single call
  (a batched matmul may sum in another order than a single one; measured
  bitwise equal on the CPU at one thread).

All JAX values come from one jitted function (one compile).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from constant_ph_tpu import neighbors as jn
from constant_ph_tpu.lambda_dyn import charges as jax_charges
from constant_ph_tpu.ops import ewald as jewald
from constant_ph_tpu.ops.pair import pair_forces as jax_pair_forces
from constant_ph_tpu.systems.water import solvated_acid as jax_solvated_acid
from constant_ph_tpu_torch import convert, neighbors as tn
from constant_ph_tpu_torch.lambda_dyn import charges
from constant_ph_tpu_torch.ops import ewald as tewald
from constant_ph_tpu_torch.ops.pair import pair_forces
from constant_ph_tpu_torch.parallel.replica import stack_replicas
from constant_ph_tpu_torch.systems.water import solvated_acid

torch.set_num_threads(1)

R = 3
SYSTEM = dict(n_side=8, cutoff=6.0, skin=1.5, seed=5, pH=5.0)
STYLES = {"dsf": dict(coul_style="dsf", alpha=0.2),
          "cut": dict(coul_style="cut", alpha=0.35)}
LAMS = (0.3, 0.5, 0.8)
PHS = (4.0, 5.0, 6.5)


def sorted_rows(idx, code):
    order = np.argsort(idx, axis=-1, kind="stable")
    return (np.take_along_axis(idx, order, -1),
            np.take_along_axis(code, order, -1))


def scaled_err(got, ref):
    ref = np.asarray(ref)
    return np.abs(got.numpy() - ref).max() / max(1.0, np.abs(ref).max())


def replica_positions(x0, box):
    """R seeded position sets: the base moved by up to ±0.3 Å a
    coordinate, the last compressed by 8 % about the origin."""
    rng = np.random.default_rng(21)
    xs = x0[None] + rng.uniform(-0.3, 0.3, (R,) + x0.shape)
    xs[-1] *= 0.92
    return np.mod(xs, box).astype(np.float32)


def max_row(x, box, rc):
    """The largest number of other atoms within rc of an atom."""
    d = x[:, None, :] - x[None, :, :]
    d -= box * np.round(d / box)
    r2 = np.sum(d * d, axis=-1)
    np.fill_diagonal(r2, np.inf)
    return int((r2 < rc * rc).sum(axis=1).max())


@pytest.fixture(scope="module")
def case():
    jsys = {k: jax_solvated_acid(**SYSTEM, **v) for k, v in STYLES.items()}
    tsys = {k: solvated_acid(device="cpu", **SYSTEM, **v)
            for k, v in STYLES.items()}
    js = jsys["dsf"]
    box = np.asarray(js.state.box)
    xs = replica_positions(np.asarray(js.state.x, np.float64), box)
    lams = np.asarray(LAMS, np.float32)[:, None]
    params = js.nbr_params
    rc = params.cutoff
    K = max(max_row(xs[r].astype(np.float64), box, rc) for r in range(2))
    assert max_row(xs[2].astype(np.float64), box, rc) > K
    small = dataclasses.replace(params, capacity=K)
    # moved copies: replica 0 past skin/2, 1 short of it, 2 past it
    # across the box boundary
    half = 0.5 * params.skin
    moved = xs.copy()
    moved[0, 7, 0] += half + 1e-3
    moved[1, 7, 1] += half - 1e-3
    edge = int(np.argmin(xs[2, :, 0]))
    moved[2, edge, 0] = np.mod(xs[2, edge, 0] - (half + 1e-3), box[0])
    assert moved[2, edge, 0] > box[0] / 2
    ep_j = jewald.make_ewald_params(box, 0.35, accuracy=1e-5)
    excl = (js.ff.excl_idx, js.ff.excl_code)
    jbox = jnp.asarray(box)

    @jax.jit
    def refs(xs, moved, lams):
        def build(p):
            return jax.vmap(lambda x: jn.build_neighbor_list(
                x, jbox, p, *excl))(xs)

        nbrs = build(params)
        q = jax.vmap(lambda lam: jax_charges(js.ff.q0, js.spec, lam))(lams)
        pair = {k: jax.vmap(lambda x, qq, nb: jax_pair_forces(
            x, qq, s.ff.type, jbox, nb, s.ff.pair))(xs, q, nbrs)
            for k, s in jsys.items()}
        return dict(
            nbrs=nbrs, small=build(small).overflow,
            rebuild=jax.vmap(lambda nb, x: jn.needs_rebuild(
                nb, x, jbox, params))(nbrs, moved),
            q=q, pair=pair,
            ewald=jax.vmap(lambda x, qq: jewald.ewald_recip(x, qq, ep_j))(
                xs, q))

    ref = refs(jnp.asarray(xs), jnp.asarray(moved), jnp.asarray(lams))
    t = tsys["dsf"]
    tq = charges(t.ff.q0, t.spec, torch.as_tensor(lams))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(ref["q"]))
    jnbrs = [convert.neighbor_list(
        {f.name: np.asarray(getattr(ref["nbrs"], f.name))[r]
         for f in dataclasses.fields(ref["nbrs"])}, device="cpu")
        for r in range(R)]
    return dict(
        ref=ref, tsys=tsys, params=params, small=small,
        x=torch.as_tensor(xs), moved=torch.as_tensor(moved),
        box=torch.as_tensor(np.broadcast_to(box, (R, 3)).copy()),
        q=tq, excl=(torch.as_tensor(t.ff.excl_idx, dtype=torch.int64),
                    torch.as_tensor(t.ff.excl_code, dtype=torch.int64)),
        jnbrs=jnbrs,
        ep=tewald.make_ewald_params(box, 0.35, accuracy=1e-5, device="cpu"))


def test_build_neighbor_list_batch(case):
    ref = case["ref"]
    got = tn.build_neighbor_list(case["x"], case["box"], case["params"],
                                 *case["excl"])
    K = case["params"].capacity
    assert got.idx.shape == (R, case["x"].shape[1], K)
    assert got.overflow.shape == (R,) and not bool(got.overflow.any())
    gi, gc = sorted_rows(got.idx.numpy(), got.code.numpy())
    ji, jc = sorted_rows(np.asarray(ref["nbrs"].idx, np.int64),
                         np.asarray(ref["nbrs"].code, np.int64))
    np.testing.assert_array_equal(gi, ji)
    np.testing.assert_array_equal(gc, jc)
    assert (got.code > 0).any()
    # each replica's list is bitwise its own single build
    for r in range(R):
        one = tn.build_neighbor_list(case["x"][r], case["box"][r],
                                     case["params"], *case["excl"])
        for f in dataclasses.fields(one):
            assert torch.equal(getattr(one, f.name),
                               getattr(got, f.name)[r]), f.name
    # the list capacity cut: only the compressed replica overflows
    small = tn.build_neighbor_list(case["x"], case["box"], case["small"],
                                   *case["excl"])
    np.testing.assert_array_equal(small.overflow.numpy(),
                                  np.asarray(ref["small"]))
    assert small.overflow.tolist() == [False, False, True]


def test_needs_rebuild_and_select_per_replica(case):
    nbrs = tn.build_neighbor_list(case["x"], case["box"], case["params"],
                                  *case["excl"])
    pred = tn.needs_rebuild(nbrs, case["moved"], case["box"],
                            case["params"])
    assert pred.shape == (R,)
    np.testing.assert_array_equal(pred.numpy(),
                                  np.asarray(case["ref"]["rebuild"]))
    assert pred.tolist() == [True, False, True]
    fresh = tn.build_neighbor_list(case["moved"], case["box"],
                                   case["params"], *case["excl"])
    kept = tn.select(pred, fresh, nbrs)
    for r in range(R):
        want = fresh if pred[r] else nbrs
        for f in dataclasses.fields(kept):
            assert torch.equal(getattr(kept, f.name)[r],
                               getattr(want, f.name)[r]), (r, f.name)


@pytest.mark.parametrize("style", ["dsf", "cut"])
def test_pair_forces_batch_matches_vmap(case, style):
    t = case["tsys"][style]
    nbrs = case["jnbrs"]
    batch = stack_replicas(nbrs)
    got = pair_forces(case["x"], case["q"], t.ff.type, case["box"], batch,
                      t.ff.pair)
    ref = case["ref"]["pair"][style]
    for name in ("force", "phi", "eatom"):
        assert scaled_err(getattr(got, name), getattr(ref, name)) < 1e-5, \
            name
    # energies: float32 sums of terms far larger than the totals, held
    # within 1e-6 of each replica's energy scale Σ|eatom|
    S = np.abs(np.asarray(ref.eatom, np.float64)).sum(axis=1)
    for name in ("e_lj", "e_coul"):
        assert getattr(got, name).shape == (R,)
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=1e-6 * S.min(), err_msg=name)
    np.testing.assert_allclose(got.virial.numpy(), np.asarray(ref.virial),
                               rtol=1e-5)
    for r in range(R):
        one = pair_forces(case["x"][r], case["q"][r], t.ff.type,
                          case["box"][r], nbrs[r], t.ff.pair)
        for name in ("force", "phi", "eatom", "e_lj", "e_coul", "virial"):
            assert torch.equal(getattr(got, name)[r], getattr(one, name)), \
                (r, name)


def test_ewald_recip_batch_matches_vmap(case):
    got = tewald.ewald_recip(case["x"], case["q"], case["ep"])
    ref = case["ref"]["ewald"]
    assert got[0].shape == (R,)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-5)
    for name, g, r in zip(("force", "phi", "eatom"), got[1:], ref[1:]):
        assert g.shape == case["x"].shape[:g.ndim]
        assert scaled_err(g, r) < 1e-5, name
    for r in range(R):
        one = tewald.ewald_recip(case["x"][r], case["q"][r], case["ep"])
        np.testing.assert_allclose(float(got[0][r]), float(one[0]),
                                   rtol=1e-6)
        for g, o in zip(got[1:], one[1:]):
            assert scaled_err(g[r], o) < 1e-6
