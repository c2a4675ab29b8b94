"""Parity of the port's reference Engine (constant_ph_tpu_torch/engine.py)
with the JAX package's, on a 1,537-atom box (solvated_acid n_side 8, rc 6,
the cell path on a 3³ grid), both packages on the same float32 positions
and velocities and the same neighbour list.

- compute_forces with DSF α 0.2 and with 'cut' α 0.35 + the factorized
  Ewald hook: forces, φ, eatom, dU/dλ and f_λ, each scaled by
  max(1, |ref|max), within 1e-5. Energies are float32 sums of terms far
  larger than the totals (DSF e_coul 10.6 kcal/mol out of Σ|eatom| 8,192;
  Ewald e_kspace −35,515 against e_pot 591), so each is held within 1e-6
  of the energy scale S = max(Σ|eatom|, Σ|energy terms|): measured 4.3e-4
  kcal/mol (DSF e_coul) and 7.8e-3 (Ewald e_kspace, 2 float32 ulps of it)
  against 8.2e-3 and 7.2e-2. compute_Hs against JAX's tallies and the sum
  rule.
- A 2 × 4-step NVE make_run ('cut' + Ewald, rigid water, λ moving with
  the λ-RESPA drift) whose skin of 0.2 Å makes the second block rebuild
  the list. Measured divergence between the packages over these 8 steps
  on the CPU: positions 2.7e-5 Å, velocities 6.6e-6 Å/fs, λ 0,
  h_conserved 0.012 kcal/mol (the e_kspace ulps); the bars are the tiled
  engine's (tests/test_torch_engine.py) 1e-4 Å, 2e-5 Å/fs and 1e-6, and
  h_conserved within 1e-6 of S.
- The refusals the JAX Engine makes, and the port's force_cap refusal.

All JAX reference values come from one jitted function (one compile).
"""
import dataclasses

import numpy as np
import jax
import pytest
import torch

from constant_ph_tpu.engine import EngineConfig as JConfig
from constant_ph_tpu.ops.ewald import make_ewald_params as jax_ewald_params
from constant_ph_tpu.ops.ewald import make_kspace_fn as jax_kspace_fn
from constant_ph_tpu.systems.water import solvated_acid as jax_solvated_acid
from constant_ph_tpu_torch import convert
from constant_ph_tpu_torch.engine import Engine, EngineConfig
from constant_ph_tpu_torch.ops.ewald import make_ewald_params, make_kspace_fn
from constant_ph_tpu_torch.systems.water import solvated_acid

from test_torch_layout import fields_dict

torch.set_num_threads(1)

SYSTEM = dict(n_side=8, cutoff=6.0, skin=0.2, seed=9, pH=5.0)
STYLES = {"dsf": dict(coul_style="dsf", alpha=0.2),
          "ewald": dict(coul_style="cut", alpha=0.35)}
NVE = dict(dt=1.0, thermostat="nve", lambda_thermostat="none",
           rebuild_every=4)


def energy_scale(frc):
    """max(Σ|eatom|, Σ|energy terms|): the size of the float32 terms the
    energy totals sum."""
    terms = sum(abs(float(getattr(frc, n))) for n in
                ("e_lj", "e_coul", "e_bonded", "e_kspace", "e_site"))
    return max(float(np.abs(np.asarray(frc.eatom)).sum()), terms)


def list_dict(nbr):
    return {f.name: np.asarray(getattr(nbr, f.name))
            for f in dataclasses.fields(nbr)}


@pytest.fixture(scope="module")
def case():
    jsys = {k: jax_solvated_acid(**SYSTEM, **v) for k, v in STYLES.items()}
    tsys = {k: solvated_acid(device="cpu", **SYSTEM, **v)
            for k, v in STYLES.items()}
    box = np.asarray(jsys["ewald"].state.box)
    jeng = {"dsf": jsys["dsf"].make_engine(JConfig(**NVE)),
            "ewald": jsys["ewald"].make_engine(
                JConfig(**NVE), kspace_fn=jax_kspace_fn(
                    jax_ewald_params(box, 0.35, accuracy=1e-5)))}
    teng = {"dsf": tsys["dsf"].make_engine(EngineConfig(**NVE)),
            "ewald": tsys["ewald"].make_engine(
                EngineConfig(**NVE), kspace_fn=make_kspace_fn(
                    make_ewald_params(box, 0.35, accuracy=1e-5,
                                      device="cpu")))}

    @jax.jit
    def jax_refs(st):
        nbr = jeng["ewald"].build_neighbors(st.x, st.box)
        frc = {k: e.compute_forces(st.x, st.lam, st.box, st.pH, nbr)
               for k, e in jeng.items()}
        return nbr, frc, jeng["ewald"].make_run(8)(st, nbr)

    jst = jsys["ewald"].state
    nbr, frc, run = jax_refs(jst)
    # the port starts from the JAX state: its velocities too
    tst = convert.system_state(fields_dict(jst), device="cpu")
    return dict(tsys=tsys, teng=teng, jst=jst, tst=tst, nbr=nbr, frc=frc,
                run=run)


@pytest.mark.parametrize("style", ["dsf", "ewald"])
def test_compute_forces_match_jax(case, style):
    ref = case["frc"][style]
    st = case["tst"]
    eng = case["teng"][style]
    nbr = convert.neighbor_list(list_dict(case["nbr"]), device="cpu")
    assert not bool(nbr.overflow)
    got = eng.compute_forces(st.x, st.lam, st.box, st.pH, nbr)
    for name in ("f", "phi", "eatom", "dUdlam", "f_lam"):
        a = np.asarray(getattr(ref, name))
        scale = max(1.0, np.abs(a).max())
        np.testing.assert_allclose(getattr(got, name).numpy() / scale,
                                   a / scale, atol=1e-5, err_msg=name)
    S = energy_scale(ref)
    for name in ("e_lj", "e_coul", "e_bonded", "e_kspace", "e_site",
                 "e_pot"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(ref, name)), rtol=0,
                                   atol=1e-6 * S, err_msg=name)
    assert (float(got.e_kspace) != 0.0) == (style == "ewald")
    # compute_Hs: JAX's tallies, and the sum rule
    HA, HB = eng.compute_Hs(st, nbr, case["tsys"][style].groupH_mask)
    eatom = np.asarray(ref.eatom, np.float64)
    gH = case["tsys"][style].groupH_mask.numpy()
    np.testing.assert_allclose(float(HA), eatom.sum(), rtol=0,
                               atol=1e-6 * S)
    np.testing.assert_allclose(float(HB), eatom[~gH].sum(), rtol=0,
                               atol=1e-6 * S)
    np.testing.assert_allclose(
        float(HA), float(got.e_lj + got.e_coul + got.e_bonded
                         + got.e_kspace), rtol=0, atol=1e-6 * S)
    assert abs(float(HA) - float(HB)) > 1e-3


def test_nve_run_crosses_a_rebuild(case):
    jst2, jnbr2, jobs = case["run"]
    tst2, tnbr2, tobs = case["teng"]["ewald"].make_run(8)(
        case["tst"], convert.neighbor_list(list_dict(case["nbr"]),
                                           device="cpu"))
    x0 = np.asarray(case["jst"].x)
    # the second block started from a new list in both packages
    assert not np.array_equal(np.asarray(jnbr2.x_ref), x0)
    np.testing.assert_allclose(tnbr2.x_ref.numpy(), np.asarray(jnbr2.x_ref),
                               atol=1e-5)
    assert not bool(tnbr2.overflow) and not bool(jnbr2.overflow)
    np.testing.assert_allclose(tst2.x.numpy(), np.asarray(jst2.x), atol=1e-4)
    np.testing.assert_allclose(tst2.v.numpy(), np.asarray(jst2.v), atol=2e-5)
    np.testing.assert_allclose(tobs.lam.numpy(), np.asarray(jobs.lam),
                               atol=1e-6)
    assert float(torch.abs(tobs.lam[-1] - tobs.lam[0]).max()) > 1e-5
    np.testing.assert_allclose(tobs.h_conserved.numpy(),
                               np.asarray(jobs.h_conserved), rtol=0,
                               atol=1e-6 * energy_scale(case["frc"]["ewald"]))
    assert int(tst2.step) == tst2.step_host == 8


def test_refusals(case):
    tsys = case["tsys"]["dsf"]
    for kw, match in ((dict(kspace_every=2), "kspace_every"),
                      (dict(kspace_live_box=True), "kspace_live_box"),
                      (dict(force_cap=50.0), "force_cap")):
        with pytest.raises(ValueError, match=match):
            tsys.make_engine(EngineConfig(**kw))
    with pytest.raises(ValueError, match="kspace_every"):
        Engine(tsys.ff, tsys.nbr_params, EngineConfig(kspace_every=3))
