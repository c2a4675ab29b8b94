"""Parity of the PyTorch port's titration module with the JAX package.

- The never-crossed guard (titration.never_crossed / check_crossed) on
  tables filled in one basin and in both.
- apply_dG_ref, parse_class_offsets, apply_dG_ref_per_class and
  lambda_dyn.stack_sites against JAX.
- calibrate_dG_ref_tiled (λ frozen, NVE: deterministic) on 2 nodes against
  JAX, from the same JAX-built state. Over 4 sample steps a node the two
  packages' mean dU/dλ differed by at most 2.8e-7 relative and ΔG_ref by
  1.7e-7 (CPU, float32); the bar is rtol 3e-6.
- calibrate_dG_ref_metad on the port alone: survey mode and refusal.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from constant_ph_tpu import titration as jtitration
from constant_ph_tpu.engine import EngineConfig as JConfig
from constant_ph_tpu_torch import convert, metad, titration
from constant_ph_tpu_torch.engine import EngineConfig

from test_torch_layout import fields_dict, jax_tiled, port_of

# the suite runs six xdist workers on the same cores: one torch thread
# each keeps the port tests from oversubscribing them
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def acid():
    """The dilute grid-4³ acid box, JAX-built, and its port."""
    jsys, jts, jst = jax_tiled("dsf", 0.2)
    return (jsys, jts, jst) + port_of(jts, jst)


def test_never_crossed_guard():
    mp = metad.MetadParams(nbins=121, sigma=0.05, h0=0.4)
    grid = mp.grid()
    V0, dV0 = metad.init_tables(2, mp, device="cpu")
    # site 0 fills only the protonated well, site 1 only the deprotonated
    one = metad.deposit_many(V0, dV0, torch.tensor([[0.02, 0.97]] * 12), mp)
    with pytest.raises(RuntimeError, match=r"never crossed .* sites \[0, 1\]"):
        titration.check_crossed(one[0].numpy(), grid.numpy(), mp.h0)
    assert titration.never_crossed(one[0].numpy(), grid.numpy(),
                                   mp.h0).tolist() == [True, True]
    both = metad.deposit_many(one[0], one[1],
                              torch.tensor([[0.98, 0.03]] * 12), mp)
    titration.check_crossed(both[0].numpy(), grid.numpy(), mp.h0)
    # a non-finite ΔF fails the check even when both wells are filled
    with pytest.raises(RuntimeError, match=r"sites \[1\]"):
        titration.check_crossed(both[0].numpy(), grid.numpy(), mp.h0,
                                np.array([0.3, np.inf]))


def test_dG_ref_installers_match(acid):
    jsys = acid[0]
    from constant_ph_tpu.lambda_dyn import stack_sites as jstack
    from constant_ph_tpu_torch.lambda_dyn import stack_sites

    jspec = jstack([jsys.spec.replace(pK=jnp.asarray([pk], jnp.float32))
                    for pk in (4.25, 3.65, 6.5, 4.25)])
    spec = stack_sites([convert.lambda_spec(fields_dict(jsys.spec),
                                            device="cpu")] * 4)
    spec.pK = torch.as_tensor(np.array(jspec.pK))
    for name, val in fields_dict(jspec).items():
        np.testing.assert_array_equal(getattr(spec, name).numpy(), val)
    text = " 4.25:-0.89, 6.5:0.12,,3.65:0 "
    assert titration.parse_class_offsets(text) == \
        jtitration.parse_class_offsets(text)
    assert titration.parse_class_offsets(None) == {}
    for dg in (-39.37, np.array([-39.0, -38.5, -38.0, -37.5])):
        np.testing.assert_array_equal(
            titration.apply_dG_ref(spec, dg).dG_ref.numpy(),
            np.asarray(jtitration.apply_dG_ref(jspec, dg).dG_ref))
    offs = titration.parse_class_offsets(text)
    np.testing.assert_array_equal(
        titration.apply_dG_ref_per_class(spec, -39.37, offs).dG_ref.numpy(),
        np.asarray(jtitration.apply_dG_ref_per_class(jspec, -39.37,
                                                     offs).dG_ref))
    for mod, s in ((titration, spec), (jtitration, jspec)):
        with pytest.raises(ValueError, match="no site has that pK"):
            mod.apply_dG_ref_per_class(s, -39.37, {5.0: 0.1})


def test_calibrate_tiled_matches_jax(acid):
    _, jts, jst, tts, tst = acid
    kw = dict(dt=1.0, thermostat="nve", lambda_thermostat="none",
              rebuild_every=4)
    nodes, weights = [0.2, 0.8], [0.5, 0.5]
    ref = jtitration.calibrate_dG_ref_tiled(
        jts, jst, JConfig(**kw), equil_steps=0, sample_steps=4,
        nodes=nodes, weights=weights, return_profile=True)
    got = titration.calibrate_dG_ref_tiled(
        tts, tst, EngineConfig(**kw), equil_steps=0, sample_steps=4,
        nodes=nodes, weights=weights, return_profile=True)
    np.testing.assert_allclose(got[1][1], ref[1][1], rtol=3e-6)
    np.testing.assert_allclose(got[0], ref[0], rtol=3e-6)
    assert np.isfinite(got[0])


def test_calibrate_metad_survey_and_refusal(acid):
    """calibrate_dG_ref_metad on the port alone (the JAX run loop's
    compile would double this file's time), NVE so deterministic, a hill
    every 2 steps: from the barrier top one hill fills neither well, the
    guard stays quiet and the site gets a finite ΔG_ref; from deep in the
    deprotonated well three hills fill it alone, so survey mode returns
    NaN and the default mode refuses."""
    tts, tst = acid[3], acid[4]
    mp = metad.MetadParams(nbins=61, sigma=0.05, h0=0.4, gamma=10.0,
                           stride=2)
    cfg = EngineConfig(dt=1.0, thermostat="nve", lambda_thermostat="none",
                       rebuild_every=2)
    kw = dict(metad_params=mp, chunk=2)
    top = dataclasses.replace(tst, lam=torch.full_like(tst.lam, 0.5))
    got = titration.calibrate_dG_ref_metad(tts, top, cfg, n_steps=2, **kw)
    assert got.shape == (1,) and np.isfinite(got).all()
    deep = dataclasses.replace(tst, lam=torch.full_like(tst.lam, 0.98))
    assert np.isnan(titration.calibrate_dG_ref_metad(
        tts, deep, cfg, n_steps=6, on_stuck="nan", **kw)).all()
    with pytest.raises(RuntimeError, match="never crossed"):
        titration.calibrate_dG_ref_metad(tts, deep, cfg, n_steps=6, **kw)
