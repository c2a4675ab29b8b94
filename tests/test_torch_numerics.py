"""Parity of the PyTorch port's numeric core with the JAX package:
lambda_dyn, integrators, state, ops/kernels, ops/bonded and
ops/constraints, on the same numpy-seeded inputs.

Tolerance: rtol 1e-6, with an atol where a value can sit near 0 or is a
difference of large terms (kcal/mol scale stated at each check) —
float32 elementwise math whose only differences are the libraries'
exp/erf/erfc/atan2 implementations (a few ulp).
"""
import numpy as np
import jax.numpy as jnp
import torch

from constant_ph_tpu import integrators as j_int
from constant_ph_tpu import lambda_dyn as j_lam
from constant_ph_tpu import state as j_state
from constant_ph_tpu.forcefield import BondedParams as JBonded
from constant_ph_tpu_torch import convert
from constant_ph_tpu_torch import integrators as t_int
from constant_ph_tpu_torch import lambda_dyn as t_lam
from constant_ph_tpu_torch import state as t_state

# the suite runs six xdist workers on the same cores: one torch thread
# each keeps the port tests from oversubscribing them
torch.set_num_threads(1)

RTOL = 1e-6


def close(got, ref, atol=1e-6, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def T(a):
    return torch.as_tensor(np.array(a), dtype=torch.float32)


def J(a):
    return jnp.asarray(np.asarray(a), dtype=jnp.float32)


def _specs():
    rng = np.random.default_rng(0)
    q_prot = rng.uniform(-0.6, 0.6, 4)
    q_dep = q_prot + rng.uniform(-0.3, 0.3, 4)
    kw = dict(buffer_idx=[7, 8, 9], m_lambda=20.0, dG_ref=1.5)
    js = j_lam.make_single_site([0, 1, 2, 3], q_prot, q_dep, 4.25, **kw)
    ts = t_lam.make_single_site([0, 1, 2, 3], q_prot, q_dep, 4.25,
                                device="cpu", **kw)
    return js, ts


def test_make_single_site_and_convert():
    js, ts = _specs()
    for name in ("pK", "dG_ref", "m_lambda", "atom_idx", "dq", "atom_mask"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    conv = convert.lambda_spec(
        {n: np.asarray(getattr(js, n)) for n in
         ("pK", "dG_ref", "m_lambda", "atom_idx", "dq", "atom_mask")},
        device="cpu")
    np.testing.assert_array_equal(conv.dq.numpy(), ts.dq.numpy())


def test_lambda_dyn_matches():
    js, ts = _specs()
    p = j_lam.BiasParams()
    tp = t_lam.BiasParams()
    rng = np.random.default_rng(1)
    lam = np.concatenate([np.linspace(-0.3, 1.3, 33), rng.uniform(0, 1, 31)])
    for jf, tf in ((j_lam.switching, t_lam.switching),
                   (j_lam.bias, t_lam.bias)):
        for a, b in zip(jf(J(lam), p), tf(T(lam), tp)):
            # the erf walls reach 200 kcal/mol: atol is rtol × the scale
            close(b, a, atol=RTOL * max(1.0, float(np.abs(a).max())))

    lam1 = np.array([0.37])
    q0 = rng.uniform(-0.8, 0.8, 12)
    close(t_lam.charges(T(q0), ts, T(lam1)), j_lam.charges(J(q0), js,
                                                            J(lam1)))
    phi = rng.uniform(-30, 30, 12)
    dU = j_lam.dq_dlambda_dot(js, J(phi))
    close(t_lam.dq_dlambda_dot(ts, T(phi)), dU, atol=1e-5)
    for pH in (3.0, 7.5):
        for jf, tf in ((j_lam.ph_energy, t_lam.ph_energy),):
            for a, b in zip(jf(J(lam1), js, J(pH), 300.0, p),
                            tf(T(lam1), ts, T(pH), 300.0, tp)):
                close(b, a, atol=1e-5)
        for a, b in zip(
                j_lam.lambda_force(J(lam1), dU, js, J(pH), 300.0, p),
                t_lam.lambda_force(T(lam1), T(np.asarray(dU)), ts, T(pH),
                                   300.0, tp)):
            close(b, a, atol=1e-4)
        close(t_lam.analytic_lambda_force(T(lam1), ts, T(pH), 300.0, tp),
              j_lam.analytic_lambda_force(J(lam1), js, J(pH), 300.0, p),
              atol=1e-4)
    v = np.array([0.013])
    close(t_lam.lambda_kinetic(T(v), ts), j_lam.lambda_kinetic(J(v), js))
    close(t_lam.lambda_temperature(T(v), ts),
          j_lam.lambda_temperature(J(v), js))


def test_nhc_matches():
    rng = np.random.default_rng(2)
    xi = rng.normal(scale=0.01, size=3)
    for ke2 in (800.0, 1500.0):
        a = j_int.nhc_halfstep(J(xi), J(ke2), 300, 0.596, 100.0, 2.0)
        b = t_int.nhc_halfstep(T(xi), T(ke2), 300, 0.596, 100.0, 2.0)
        close(b[0], a[0])
        close(b[1], a[1], atol=1e-9)
    close(t_int.nhc_energy(T(xi), 300, 0.596, 100.0),
          j_int.nhc_energy(J(xi), 300, 0.596, 100.0), atol=1e-9)


def test_maxwell_boltzmann_port():
    mass = torch.as_tensor(np.tile([15.9994, 1.008, 1.008], 400),
                           dtype=torch.float32)
    g = torch.Generator().manual_seed(5)
    v = t_int.maxwell_boltzmann(g, mass, 300.0)
    assert v.shape == (1200, 3)
    assert torch.abs((mass[:, None] * v).sum(0)).max() < 1e-2
    T_inst = float((mass[:, None] * v * v).sum()) * 2390.057 / (
        3 * 1200 * 0.0019872067)
    assert 270.0 < T_inst < 330.0
    # same seed, same velocities
    v2 = t_int.maxwell_boltzmann(torch.Generator().manual_seed(5), mass,
                                 300.0)
    assert torch.equal(v, v2)


def test_state_helpers_match():
    rng = np.random.default_rng(3)
    box = np.array([20.0, 23.0, 31.0])
    dx = rng.uniform(-60, 60, size=(50, 3))
    close(t_state.min_image(T(dx), T(box)), j_state.min_image(J(dx), J(box)),
          atol=1e-5)
    close(t_state.wrap(T(dx), T(box)), j_state.wrap(J(dx), J(box)),
          atol=1e-5)


def _bonded_case():
    """Random geometry with bonds, angles, dihedrals and impropers."""
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 6, size=(10, 3))
    box = np.array([12.0, 12.0, 12.0])
    idx2 = np.array([[0, 1], [1, 2], [2, 3], [4, 5], [5, 9]])
    idx3 = np.array([[0, 1, 2], [1, 2, 3], [4, 5, 9]])
    idx4 = np.array([[0, 1, 2, 3], [6, 7, 8, 9]])
    d = dict(
        bond_idx=idx2, bond_k=rng.uniform(300, 600, 5),
        bond_r0=rng.uniform(0.9, 1.5, 5), bond_mask=np.ones(5),
        angle_idx=idx3, angle_k=rng.uniform(40, 90, 3),
        angle_t0=rng.uniform(1.7, 2.1, 3), angle_mask=np.ones(3),
        dihedral_idx=idx4, dihedral_k=rng.uniform(0.1, 2, 2),
        dihedral_n=np.array([2.0, 3.0]), dihedral_d=rng.uniform(0, 3, 2),
        dihedral_mask=np.ones(2),
        improper_idx=idx4[:1], improper_k=np.array([20.0]),
        improper_x0=np.array([0.3]), improper_mask=np.ones(1))
    jbp = JBonded(**{k: (jnp.asarray(v, jnp.int32) if k.endswith("idx")
                         else J(v)) for k, v in d.items()})
    return x, box, jbp, convert.bonded_params(d, device="cpu")
