"""Parity of the PyTorch port's PME (ops/pme.py) and of the tiled engine's
PME path with the JAX package, on the dilute grid-4³ box of
tests/test_pallas_ww.py ('cut' Coulomb, α 0.35, rc 8 Å; tile_safety 0.2,
W = 20) with a 40³ mesh (spacing 1.5, p = 6).

Tolerances, from the float32 differences measured on the CPU between the
two packages (both run the same float32 arithmetic; sums and FFTs are
taken in other orders):
- make_pme_params: the tables are built in float64 numpy by the same
  formulas and cast once, so they are equal.
- pme_recip_tiled (JAX run op by op, as the port runs): energy within
  rtol 2e-5. It is −3.5e4 kcal/mol, nearly all self term −Cα/√π·Σq²; the
  JAX package's float32 Σq² on this box is 7.4e-6 below the float64 value
  (torch's 6e-8), and that is the whole measured difference (7.4e-6).
  Forces and φ scaled by max(1, |ref|max) within 2e-6 (measured ≤ 4.2e-7).
- engine compute_forces with PME (JAX under jit, which fuses the
  contractions otherwise): forces, φ, dU/dλ, f_λ and tallies scaled
  within 2.5e-4 (measured ≤ 1.25e-4, on fw, whose max is only 7.1
  kcal/mol/Å on this dilute box; the port's float32 PME forces are
  1.1e-4 – 1.4e-4 of their max from its own float64 evaluation, which
  test_pme_float32_against_float64 measures and bounds at 3e-4).
  Energies within rtol 2e-5 plus an atol of 2e-5 of the self term
  Cα/√π·Σq² (0.72 kcal/mol here; measured 0.26, the Σq² sum above).

The NVE trajectory at kspace_every = 2 is in test_torch_pme_nve.py: its
JAX run loop alone takes ~40 s to compile, so it runs as a file of its
own on another worker.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from constant_ph_tpu.ops import pme as jpme
from constant_ph_tpu_torch import convert
from constant_ph_tpu_torch.ops import pme as tpme

from test_torch_layout import fields_dict, jax_tiled, port_of

# the suite runs six xdist workers on the same cores: one torch thread
# each keeps the port tests from oversubscribing them
torch.set_num_threads(1)

ALPHA = 0.35
MESH = dict(spacing=1.5, p=6)
NVE = dict(dt=1.0, thermostat="nve", lambda_thermostat="none",
           rebuild_every=4)   # shared with test_torch_pme_nve.py


def build_case():
    """(jts, jst, tts, tst, jpp, tpp): the JAX tiles, state and PME
    params, and the port's counterparts."""
    _, jts, jst = jax_tiled("cut", ALPHA)
    tts, tst = port_of(jts, jst)
    jpp = jpme.make_pme_params(np.asarray(jst.box), jts.params.grid, ALPHA,
                               **MESH)
    return jts, jst, tts, tst, jpp, convert.pme_params(fields_dict(jpp),
                                                       device="cpu")


@pytest.fixture(scope="module")
def case():
    return build_case()


def _e_atol(jts, jst):
    """2e-5 of the PME self term Cα/√π·Σq² (float64), in kcal/mol."""
    vm = np.repeat(np.asarray(jst.wvalid, np.float64), 3, axis=-1)
    q2 = (np.sum(np.tile(jts.water.q_pattern, jts.params.W) ** 2 * vm)
          + np.sum(np.asarray(jts.solute.q0, np.float64) ** 2))
    return 2e-5 * 332.06371 * ALPHA / np.sqrt(np.pi) * q2


def _scaled_close(got, ref, atol, name):
    ref = np.asarray(ref)
    scale = max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(np.asarray(got) / scale, ref / scale,
                               atol=atol, err_msg=name)


def test_make_pme_params_tables(case):
    jts, jst, _, _, jpp, cpp = case
    tpp = tpme.make_pme_params(np.asarray(jst.box), jts.params.grid, ALPHA,
                               device="cpu", **MESH)
    assert tpp.mesh == jpp.mesh == (40, 40, 40)
    for f in dataclasses.fields(tpp):
        a, b, c = (getattr(o, f.name) for o in (jpp, tpp, cpp))
        if isinstance(b, torch.Tensor):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f.name)
            assert torch.equal(b, c), f.name
        else:
            assert b == a == c, f.name
    with pytest.raises(ValueError, match="even"):
        tpme.make_pme_params(np.asarray(jst.box), jts.params.grid, ALPHA,
                             spacing=1.5, p=5, device="cpu")


def _recip_inputs(jts, jst):
    """Water coords/charges and λ-perturbed solute charges, as numpy."""
    p = jts.params
    gx, gy, gz = p.grid
    A = 3 * p.W
    vm = np.repeat(np.asarray(jst.wvalid), 3, axis=-1)
    wq = np.tile(jts.water.q_pattern, p.W)[None, :] * vm
    smask = np.asarray(jts.solute.smask)
    qs = (np.asarray(jts.solute.q0) + 0.1 * np.sin(
        np.arange(smask.shape[0]))) * smask
    return (np.asarray(jst.wx).reshape(3, gx, gy, gz, A),
            wq.reshape(gx, gy, gz, A).astype(np.float32),
            np.asarray(jst.sx), qs.astype(np.float32))


@pytest.mark.parametrize("need_water_phi,live_box", [
    (False, False), (True, False), (True, True)],
    ids=["forces", "water-phi", "live-box"])
def test_pme_recip_tiled_matches(case, need_water_phi, live_box):
    jts, jst, _, _, jpp, tpp = case
    wxg, wq, sx, qs = _recip_inputs(jts, jst)
    # a live box 0.4% larger than the baked one (an NPT excursion)
    box = np.asarray(jst.box) * 1.004 if live_box else None
    ref = jpme.pme_recip_tiled(
        jnp.asarray(wxg), jnp.asarray(wq), jnp.asarray(sx), jnp.asarray(qs),
        jpp, need_water_phi=need_water_phi,
        box=None if box is None else jnp.asarray(box))
    got = tpme.pme_recip_tiled(
        *(torch.tensor(a) for a in (wxg, wq, sx, qs)), tpp,
        need_water_phi=need_water_phi,
        box=None if box is None else torch.as_tensor(box,
                                                     dtype=torch.float32))
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=2e-5)
    for g, r, name in zip(got[1:], ref[1:], ("fw", "fs", "phi_s", "phi_w")):
        if r is None:
            assert g is None
        else:
            _scaled_close(g.numpy(), r, 2e-6, name)


def test_pme_float32_against_float64(case):
    """The port's float32 PME against the same call in float64 (params
    and inputs cast up): the truncated-power B-splines cancel terms of
    ~1e3, so float32 forces and φ sit 1.1e-4 – 1.4e-4 of their max from
    float64 here, and the energy 1.6e-7 relative. Bars 3e-4 and 1e-6."""
    jts, jst, _, _, _, tpp = case
    args = [torch.tensor(a) for a in _recip_inputs(jts, jst)]
    p64 = dataclasses.replace(tpp, **{
        f.name: getattr(tpp, f.name).double() for f in dataclasses.fields(tpp)
        if isinstance(getattr(tpp, f.name), torch.Tensor)
        and getattr(tpp, f.name).is_floating_point()})
    got = tpme.pme_recip_tiled(*args, tpp, need_water_phi=True)
    ref = tpme.pme_recip_tiled(*(a.double() for a in args), p64,
                               need_water_phi=True)
    assert ref[0].dtype == torch.float64
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-6)
    for g, r, name in zip(got[1:], ref[1:], ("fw", "fs", "phi_s", "phi_w")):
        _scaled_close(g.double().numpy(), r.numpy(), 3e-4, name)
