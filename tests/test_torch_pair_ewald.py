"""Parity of the port's pair forces (ops/pair.py) and factorized Ewald
(ops/ewald.py) with the JAX package's.

- pair_forces on the same positions, charges and neighbour list (the JAX
  list, carried over by convert.neighbor_list) for DSF α 0.2, plain cut
  (α 0) and Ewald real space (cut α 0.35): forces, φ and eatom within
  1e-5 of their max, energies and virial within rtol 1e-5; and the
  port's forces equal −∇ pair_energy (autograd) within 1e-5 of max.
- make_ewald_params: every table equal to JAX's (both float64 on the host,
  cast once), on cubic and orthorhombic boxes and with kmax given.
- ewald_recip on the same seeded charges and positions: energy rtol 1e-5,
  forces, φ and eatom within 1e-5 of their max.
- The NaCl Madelung constant from the port alone (real + reciprocal +
  self), within rtol 2e-4 as tests/test_ewald.py holds the JAX package.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from constant_ph_tpu.lambda_dyn import charges as jax_charges
from constant_ph_tpu.neighbors import build_neighbor_list as jax_build
from constant_ph_tpu.ops import ewald as jewald
from constant_ph_tpu.ops.pair import pair_forces as jax_pair_forces
from constant_ph_tpu.systems.water import solvated_acid as jax_solvated_acid
from constant_ph_tpu_torch import convert, units
from constant_ph_tpu_torch import neighbors as tn
from constant_ph_tpu_torch.forcefield import make_pair_params
from constant_ph_tpu_torch.lambda_dyn import charges
from constant_ph_tpu_torch.ops import ewald as tewald
from constant_ph_tpu_torch.ops.pair import pair_energy, pair_forces
from constant_ph_tpu_torch.systems.water import solvated_acid

torch.set_num_threads(1)

MADELUNG_NACL = 1.747564594633
# 1,537 atoms in a 25.6 Å box, rc 6, skin 1.5: the cell path on a 3³ grid
SYSTEM = dict(n_side=8, cutoff=6.0, skin=1.5, seed=7, pH=5.0)


def scaled_err(got, ref):
    ref = np.asarray(ref)
    return np.abs(got.numpy() - ref).max() / max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("style,alpha", [("dsf", 0.2), ("cut", 0.0),
                                         ("cut", 0.35)])
def test_pair_forces_match_jax(style, alpha):
    jsys = jax_solvated_acid(coul_style=style, alpha=alpha, **SYSTEM)
    tsys = solvated_acid(coul_style=style, alpha=alpha, device="cpu",
                         **SYSTEM)
    jnb = jax.jit(jax_build)(jsys.state.x, jsys.state.box, jsys.nbr_params,
                             jsys.ff.excl_idx, jsys.ff.excl_code)
    assert not bool(jnb.overflow)
    tnb = convert.neighbor_list({f.name: np.asarray(getattr(jnb, f.name))
                                 for f in dataclasses.fields(jnb)},
                                device="cpu")
    # λ = 0.5 charges, the same on both sides
    jq = jax_charges(jsys.ff.q0, jsys.spec, jsys.state.lam)
    tq = charges(tsys.ff.q0, tsys.spec, tsys.state.lam)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    ref = jax.jit(jax_pair_forces)(jsys.state.x, jq, jsys.ff.type,
                                   jsys.state.box, jnb, jsys.ff.pair)
    got = pair_forces(tsys.state.x, tq, tsys.ff.type, tsys.state.box, tnb,
                      tsys.ff.pair)
    for name in ("force", "phi", "eatom"):
        assert scaled_err(getattr(got, name), getattr(ref, name)) < 1e-5, \
            name
    for name in ("e_lj", "e_coul", "virial"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(ref, name)), rtol=1e-5,
                                   err_msg=name)
    # the excluded pairs are in the list and change the answer
    assert (tnb.code > 0).any()
    # the force is −∇ pair_energy on the fixed list (autograd)
    x = tsys.state.x.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(
        pair_energy(x, tq, tsys.ff.type, tsys.state.box, tnb, tsys.ff.pair),
        x)
    assert scaled_err(got.force, -grad.numpy()) < 1e-5


def test_ewald_tables_and_recip_match_jax():
    cases = [(np.array([25.6] * 3), 0.35, dict(accuracy=1e-5)),
             (np.array([64.0] * 3), 0.30, dict(accuracy=1e-5)),
             (np.array([20.0, 24.0, 31.0]), 0.3, dict()),
             (np.array([11.28] * 3), 3.0 / 5.5, dict(kmax=6))]
    for box, alpha, kw in cases:
        j = jewald.make_ewald_params(box, alpha, **kw)
        t = tewald.make_ewald_params(box, alpha, device="cpu", **kw)
        assert convert.ewald_params(
            {f.name: getattr(j, f.name) for f in dataclasses.fields(j)},
            device="cpu").nmax == t.nmax == j.nmax
        assert (t.alpha, t.volume) == (j.alpha, j.volume)
        for name in ("kx", "ky", "kz", "A", "ky_idx", "kz_idx"):
            np.testing.assert_array_equal(getattr(t, name).numpy(),
                                          np.asarray(getattr(j, name)),
                                          err_msg=name)
    assert tewald.make_ewald_params(np.array([64.0] * 3), 0.30,
                                    accuracy=1e-5, device="cpu").A.shape \
        == (20, 39 * 39)
    assert tewald.suggest_alpha(8.0, 1e-5) == jewald.suggest_alpha(8.0, 1e-5)

    # ewald_recip on seeded charges (net charge 0.5 e: the background
    # term) and positions
    rng = np.random.default_rng(11)
    n = 600
    box = np.array([22.0, 25.0, 28.0])
    x = (rng.uniform(size=(n, 3)) * box).astype(np.float32)
    q = rng.normal(size=n)
    q = (q - q.mean()).astype(np.float32)
    q[0] += 0.5
    j = jewald.make_ewald_params(box, 0.32, accuracy=1e-5)
    t = tewald.make_ewald_params(box, 0.32, accuracy=1e-5, device="cpu")
    ref = jewald.ewald_recip(jnp.asarray(x), jnp.asarray(q), j)
    got = tewald.ewald_recip(torch.as_tensor(x), torch.as_tensor(q), t)
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-5)
    for name, g, r in zip(("force", "phi", "eatom"), got[1:], ref[1:]):
        assert scaled_err(g, r) < 1e-5, name
    # the per-dimension form gives the same numbers
    e, f, phi, eatom = tewald.ewald_recip_xd(
        tuple(torch.as_tensor(x[:, d]) for d in range(3)),
        torch.as_tensor(q), t)
    assert torch.equal(torch.stack(f, dim=-1), got[1])
    assert torch.equal(phi, got[2]) and float(e) == float(got[0])


def test_nacl_madelung_constant():
    """Rock salt, ±1 on a simple cubic grid of r0 2.82 Å, 64 ions: the
    erfc real space over an all-pairs list plus reciprocal space gives
    E = −(N/2)·M·C/r0."""
    r0, n_cells = 2.82, 2
    m = 2 * n_cells
    pts = np.array([[i, j, k] for i in range(m) for j in range(m)
                    for k in range(m)], dtype=np.float64)
    x = torch.as_tensor(pts * r0, dtype=torch.float32)
    q = torch.as_tensor(np.where(pts.sum(1) % 2 == 0, 1.0, -1.0),
                        dtype=torch.float32)
    box = torch.full((3,), 2 * r0 * n_cells, dtype=torch.float32)
    n = x.shape[0]
    rc, alpha = 5.5, 3.0 / 5.5
    pp = make_pair_params([0.0], [1.0], rc, alpha=alpha, shift=False,
                          device="cpu")
    nbp = tn.make_neighbor_params(box.numpy(), rc, n_atoms=n, skin=0.5,
                                  use_cells=False, capacity=n)
    none = torch.full((n, 1), -1, dtype=torch.int64)
    nbr = tn.build_neighbor_list(x, box, nbp, none, torch.zeros_like(none))
    pr = pair_forces(x, q, torch.zeros(n, dtype=torch.int64), box, nbr, pp)
    ep = tewald.make_ewald_params(box.numpy(), alpha, accuracy=1e-6,
                                  device="cpu")
    e_rec = tewald.ewald_recip(x, q, ep)[0]
    want = -0.5 * n * MADELUNG_NACL * units.QQR2E / r0
    np.testing.assert_allclose(float(pr.e_coul + e_rec), want, rtol=2e-4)
