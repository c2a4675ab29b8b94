"""Parity of the PyTorch port's metadynamics module with the JAX package.

- Every metad function on numpy-seeded tables and λ (λ on grid nodes,
  between them and outside [lo, hi]) against JAX at rtol 1e-6 / atol 1e-6,
  the λ grid bit for bit (its middle node decides a basin).
- deposit_many against sequential deposits; deposit_frozen additive and
  free of order.
- The pooled estimators on the committed campaign checkpoint
  (examples/results/metad_ms_r5s3_ckpt.npz, walker 0 of each pH rung)
  reproduce metad_ms_r5s3_ckpt_classfixed_curves.json, following
  examples/metad_curves_from_ckpt.py --pooled --dg-ref-eval class-fixed,
  within 1e-4 kcal/mol and 1e-5 in fraction.

The titration module is held in test_torch_titration.py. This file has
five tests, so the suite's scheduler, which starts the files with the most
tests first, does not queue it ahead of the long reference files.
"""
import json
import os

import numpy as np
import jax.numpy as jnp
import torch

from constant_ph_tpu import metad as jmetad
from constant_ph_tpu.tiled.layout import TiledState as JTiledState
from constant_ph_tpu_torch import metad

# the suite runs six xdist workers on the same cores: one torch thread
# each keeps the port tests from oversubscribing them
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(ROOT, "examples", "results")
TOL = dict(rtol=1e-6, atol=1e-6)

PARAMS = [jmetad.MetadParams(nbins=241, sigma=0.05, h0=0.4, gamma=30.0,
                             stride=48),
          jmetad.MetadParams(nbins=121, sigma=0.03, h0=0.25, gamma=8.0,
                             stride=4, lo=-0.2, hi=1.2)]


def port_params(jp):
    return metad.MetadParams(lo=jp.lo, hi=jp.hi, nbins=jp.nbins,
                             sigma=jp.sigma, h0=jp.h0, gamma=jp.gamma,
                             T=jp.T, stride=jp.stride)


def seeded(jp, S=6, G=3, K=5, seed=0):
    """Tables of a few well-tempered fills (hills from seeded λ), λ on
    nodes, between nodes and outside [lo, hi], pK and pH values."""
    rng = np.random.default_rng(seed)
    grid = np.asarray(jp.grid(), np.float64)
    c = rng.uniform(jp.lo, jp.hi, size=(G, S, 12))
    h = rng.uniform(0.2, 3.0, size=(G, S, 12))
    x = grid[None, None, None, :] - c[..., None]
    g = np.exp(-x * x / (2 * 0.08 ** 2))
    V = (h[..., None] * g).sum(2).astype(np.float32)             # (G,S,B)
    dV = (h[..., None] * (-x / 0.08 ** 2) * g).sum(2).astype(np.float32)
    node = grid[rng.integers(0, jp.nbins, size=S)]
    lam = np.stack([
        node,
        rng.uniform(jp.lo, jp.hi, size=S),
        np.where(np.arange(S) % 2, jp.hi + 0.07, jp.lo - 0.05),
    ]).astype(np.float32)                                        # (3, S)
    seq = rng.uniform(jp.lo - 0.05, jp.hi + 0.05,
                      size=(K, S)).astype(np.float32)
    pK = np.resize([4.25, 3.65, 6.5], S).astype(np.float32)
    pH = np.linspace(3.0, 7.0, G).astype(np.float32)
    return dict(V=V, dV=dV, lam=lam, seq=seq, pK=pK, pH=pH)


def close(got, ref, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **(tol or TOL))


def test_grid_bit_for_bit():
    for jp in PARAMS:
        np.testing.assert_array_equal(port_params(jp).grid().numpy(),
                                      np.asarray(jp.grid()))
        assert port_params(jp).dx == jp.dx


def test_lookup_and_deposits_match():
    for jp in PARAMS:
        _lookup_and_deposits_match(jp)


def _lookup_and_deposits_match(jp):
    d, tp = seeded(jp), port_params(jp)
    V, dV = d["V"][0], d["dV"][0]
    tV, tdV = torch.as_tensor(V), torch.as_tensor(dV)
    for lam in d["lam"]:
        for got, ref in zip(metad.lookup(tV, tdV, torch.as_tensor(lam), tp),
                            jmetad.lookup(V, dV, jnp.asarray(lam), jp)):
            close(got, ref)
        for got, ref in zip(metad.deposit(tV, tdV, torch.as_tensor(lam), tp),
                            jmetad.deposit(V, dV, jnp.asarray(lam), jp)):
            close(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    seq = d["seq"]
    for fn_t, fn_j in ((metad.deposit_many, jmetad.deposit_many),
                       (metad.deposit_frozen, jmetad.deposit_frozen)):
        for got, ref in zip(fn_t(tV, tdV, torch.as_tensor(seq), tp),
                            fn_j(V, dV, jnp.asarray(seq), jp)):
            close(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    # outside [lo, hi] the slope is zero (and the value the edge's)
    _, dv_out = metad.lookup(tV, tdV, torch.as_tensor(d["lam"][2]), tp)
    assert torch.all(dv_out == 0.0)


ESTIMATORS = ["free_energy", "_basin_logZ", "deprotonated_fraction",
              "delta_f_sites", "pooled"]


def test_estimators_match():
    for jp in PARAMS:
        for name in ESTIMATORS:
            _estimator_matches(jp, name)


def _estimator_matches(jp, name):
    d, tp = seeded(jp), port_params(jp)
    V = d["V"]
    tV = torch.as_tensor(V)
    if name != "pooled":
        for g in range(V.shape[0]):
            got = getattr(metad, name)(tV[g], tp)
            ref = getattr(jmetad, name)(jnp.asarray(V[g]), jp)
            for a, b in zip(got if isinstance(got, tuple) else (got,),
                            ref if isinstance(ref, tuple) else (ref,)):
                close(a, b)
        return
    pK, pH = torch.as_tensor(d["pK"]), torch.as_tensor(d["pH"])
    F0 = metad.pooled_intrinsic_profile(tV, pK, pH, tp)
    jF0 = jmetad.pooled_intrinsic_profile(jnp.asarray(V), d["pK"], d["pH"],
                                          jp)
    close(F0, jF0)
    for ph in (3.3, 5.0, 6.9):
        close(metad.fraction_at_ph(F0, pK, ph, tp),
              jmetad.fraction_at_ph(jF0, d["pK"], ph, jp))
    to = np.linspace(-40.0, -38.0, V.shape[1]).astype(np.float32)
    for a, b in ((-39.37, -38.6), (-39.37, to)):
        close(metad.retilt_profile(F0, a, b, tp),
              jmetad.retilt_profile(jF0, a, b, jp))
    close(metad.pooled_delta_f(F0, tp), jmetad.pooled_delta_f(jF0, jp))
    # a profile with no node in one basin: −inf there, a finite fraction
    F = F0.clone()
    F[:, tp.grid() > 0.5] = float("inf")
    lz_dep, lz_prot = metad._basin_logZ_F(F, tp)
    assert torch.all(lz_dep == -float("inf")) and torch.isfinite(
        lz_prot).all()
    assert torch.all(torch.sigmoid(lz_dep - lz_prot) == 0.0)


def test_deposit_many_is_sequential_and_frozen_is_additive():
    jp = PARAMS[0]
    d, tp = seeded(jp, K=6), port_params(jp)
    V, dV = torch.as_tensor(d["V"][0]), torch.as_tensor(d["dV"][0])
    seq = torch.as_tensor(d["seq"])
    a, b = V, dV
    for lam in seq:
        a, b = metad.deposit(a, b, lam, tp)
    for got, ref in zip(metad.deposit_many(V, dV, seq, tp), (a, b)):
        assert torch.equal(got, ref)
    # frozen-base deltas: two walkers' halves add up to the whole, in
    # either order, and each hill's height sees only the base table
    whole = metad.deposit_frozen(V, dV, seq, tp)
    h1 = metad.deposit_frozen(V, dV, seq[:3], tp)
    h2 = metad.deposit_frozen(V, dV, seq[3:], tp)
    rev = metad.deposit_frozen(V, dV, seq.flip(0), tp)
    for i in range(2):
        scale = float(torch.abs(whole[i]).max())
        for other in (h1[i] + h2[i], h2[i] + h1[i], rev[i]):
            torch.testing.assert_close(other, whole[i], rtol=0,
                                       atol=1e-6 * scale)
    one = metad.deposit(V, dV, seq[0], tp)
    torch.testing.assert_close(V + metad.deposit_frozen(V, dV, seq[:1],
                                                        tp)[0], one[0])


def _ckpt_inputs():
    """Walker-0 tables and pH of each rung of the committed checkpoint, as
    examples/metad_curves_from_ckpt.py reads them."""
    rep = json.load(open(os.path.join(
        RESULTS, "metad_ms_r5s3_ckpt_classfixed_curves.json")))
    d = np.load(os.path.join(RESULTS, "metad_ms_r5s3_ckpt.npz"))
    fields = [f.name for f in JTiledState.__dataclass_fields__.values()]
    V = np.asarray(d[f"leaf{fields.index('metad_v')}"])        # (R, S, B)
    pH = np.asarray(d[f"leaf{fields.index('pH')}"], np.float64)
    wpp = rep["metad"]["walkers_per_ph"]
    G = len(pH) // wpp
    V = V.reshape(G, wpp, *V.shape[1:])[:, 0]
    pH = pH.reshape(G, wpp)[:, 0]
    pks = np.asarray([s["pK"] for s in rep["per_site"]])
    m = rep["metad"]
    mp = metad.MetadParams(nbins=m["nbins"], sigma=m["sigma"], h0=m["h0"],
                           gamma=m["gamma"], stride=m["stride"], T=300.0)
    return rep, V, pH, pks, mp


def test_pooled_estimators_reproduce_campaign_curves():
    rep, V, pH, pks, mp = _ckpt_inputs()
    assert V.shape == (9, 20, 241) and V.dtype == np.float32
    S, G = V.shape[1], V.shape[0]
    # float32 inputs as jnp.asarray makes them in the reader
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))   # noqa: E731
    D0 = float(rep["dG_ref"])
    F0 = metad.pooled_intrinsic_profile(t(V), t(pks), t(pH), mp)
    dfs = metad.pooled_delta_f(F0, mp).double().numpy()
    np.testing.assert_allclose(dfs, rep["pooled_site_delta_f_kcal"],
                               rtol=0, atol=1e-4)
    assert abs(float(np.mean(dfs)) - rep["pooled_global_offset_kcal"]) < 1e-4
    dg_eval = np.full(S, D0)
    for pk in sorted(set(np.round(pks, 4).tolist())):
        sel = np.abs(pks - pk) < 1e-3
        dfc = float(metad.pooled_delta_f(F0[torch.as_tensor(sel)].mean(0)
                                         [None], mp)[0])
        assert abs(D0 + dfc - rep["dg_ref_eval_per_class"][str(pk)]) < 1e-4
        dg_eval[sel] = D0 + dfc
    F0 = metad.retilt_profile(F0, D0, dg_eval, mp).double()
    frac = np.stack([metad.fraction_at_ph(F0, t(pks).double(), float(pH[g]),
                                          mp).numpy() for g in range(G)])
    order = np.argsort(pH)
    for i, site in enumerate(rep["per_site"]):
        want = [pt["deprotonated"] for pt in site["curve"]]
        np.testing.assert_allclose(frac[order, i], want, rtol=0, atol=1e-5,
                                   err_msg=f"site {i}")
