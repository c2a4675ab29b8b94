"""Parity of the port's pair kernels, bonded forces and rigid-triatomic
constraints with the JAX package, at the bars of
tests/test_torch_numerics.py (split from that file so that no port test
file collects more than five tests).
"""
import numpy as np
import jax
import pytest
import torch
from constant_ph_tpu.ops import bonded as j_bonded
from constant_ph_tpu.ops import constraints as j_cons
from constant_ph_tpu.ops import kernels as j_k
from constant_ph_tpu_torch.ops import bonded as t_bonded
from constant_ph_tpu_torch.ops import constraints as t_cons
from constant_ph_tpu_torch.ops import kernels as t_k

from test_torch_numerics import (  # noqa: F401  (fixtures and helpers)
    J,
    T,
    _bonded_case,
    close,
)

# the suite runs six xdist workers on the same cores: one torch thread
# each keeps the port tests from oversubscribing them
torch.set_num_threads(1)


@pytest.mark.parametrize("style,alpha", [("dsf", 0.2), ("cut", 0.35),
                                         ("cut", 0.0)])
def test_pair_kernels_match(style, alpha):
    rng = np.random.default_rng(4)
    r = rng.uniform(0.8, 9.0, 200)
    scoul = rng.choice([0.0, 0.5, 0.8333, 1.0], 200)
    r2 = r * r
    args = (r2, r, 1.0 / r2, scoul)
    a = j_k.coul_kernel(*map(J, args), alpha=alpha, style=style, rc=9.0)
    b = t_k.coul_kernel(*map(T, args), alpha=alpha, style=style, rc=9.0)
    for x, y in zip(a, b):
        close(y, x, atol=1e-6)
    c6, c12, esh = rng.uniform(100, 700, 200), rng.uniform(1e5, 7e5, 200), \
        rng.uniform(-3e-3, 0, 200)
    args = (1.0 / r2, c6, c12, esh)
    for x, y in zip(j_k.lj_kernel(*map(J, args)),
                    t_k.lj_kernel(*map(T, args))):
        close(y, x, atol=1e-3)


def test_bonded_forces_match():
    x, box, jbp, tbp = _bonded_case()
    e_j, f_j, ea_j = jax.jit(j_bonded.bonded_forces)(J(x), J(box), jbp)
    e_t, f_t, ea_t = t_bonded.bonded_forces(T(x), T(box), tbp)
    close(e_t, e_j, atol=1e-4)
    scale = float(np.abs(np.asarray(f_j)).max())
    close(f_t / scale, np.asarray(f_j) / scale, atol=1e-6)
    close(ea_t, ea_j, atol=1e-4)


def test_rigid_triatomic_matches():
    """M-SHAKE / M-RATTLE on perturbed rigid waters, both packages."""
    rng = np.random.default_rng(8)
    M = 6
    geo = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                    [np.cos(1.9106), np.sin(1.9106), 0.0]])
    ref = (geo[None] + rng.uniform(0, 9, size=(M, 1, 3))).reshape(-1, 3)
    x = ref + rng.normal(scale=0.05, size=ref.shape)
    v = rng.normal(scale=0.01, size=ref.shape)
    trip = np.arange(3 * M).reshape(M, 3)
    mass = np.tile([15.9994, 1.008, 1.008], M)
    box = np.array([10.0, 10.0, 10.0])
    d12 = 2.0 * np.sin(1.9106 / 2.0)
    jc = j_cons.RigidTriatomic(trip, mass, 1.0, d12)
    tc = t_cons.RigidTriatomic(trip, mass, 1.0, d12, device="cpu")
    xa, va = jc.positions(J(ref), J(x), J(v), J(box), 2.0)
    xb, vb = tc.positions(T(ref), T(x), T(v), T(box), 2.0)
    close(xb, xa, atol=2e-6)
    close(vb, va, atol=2e-6)
    close(tc.velocities(xb, T(v), T(box)), jc.velocities(xa, J(v), J(box)),
          atol=2e-6)
