"""The tiled engine's factorized-Ewald k-space in the port, on the dilute
grid-4³ box of tests/test_pallas_ww.py ('cut' Coulomb, α 0.35, rc 8 Å;
tile_safety 0.2, W 20), Ewald at accuracy 1e-5.

- Against the JAX package (one jitted function for all three): at
  kspace_every 1, and at kspace_every 2 on a boundary step (reciprocal
  forces ×2) and an off-boundary step (no reciprocal force, the carried
  φ). Forces, φ, dU/dλ, f_λ, the carried reciprocal φ and the tallies
  scaled by max(1, |ref|max) within 1e-5; energies within rtol 2e-5 plus
  2e-5 of the self term Cα/√π·Σq² (the JAX package's float32 Σq² sits
  7.4e-6 below float64 on this box, tests/test_torch_pme.py).
- The port's tiled Ewald against the port's reference engine + Ewald on
  the same positions, at the bars and on the system (190 atoms, rc 6)
  of tests/test_tiled.py::test_tiled_ewald_matches_reference: Coulomb
  total (real + reciprocal) within rtol 3e-3, solute forces within 2e-4
  of max|f| (the JAX test's comparison), each water molecule's net force
  within 2e-4 of max|f| as well (the intra-water erf forces the
  reference adds act along the bonds and cancel in it), dU/dλ within
  rtol 1e-3 / atol 1e-2.
- The port's tiled PME (spacing 1.0, p 6) against its tiled Ewald
  (accuracy 1e-6) at the bars of tests/test_tiled.py
  test_pme_matches_factorized_ewald: e_kspace within 0.3 kcal/mol, forces
  within 5e-4 of max, dU/dλ within rtol 2e-3 / atol 1e-2; and the tally
  sum rule within 1e-3, k-space included, on both.
"""
import dataclasses

import numpy as np
import jax
import pytest
import torch

from constant_ph_tpu.engine import EngineConfig as JConfig
from constant_ph_tpu.ops import ewald as jewald
from constant_ph_tpu.tiled.engine import TiledEngine as JEngine
from constant_ph_tpu_torch import convert
from constant_ph_tpu_torch.engine import EngineConfig
from constant_ph_tpu_torch.ops import ewald as tewald
from constant_ph_tpu_torch.ops.pme import make_pme_params
from constant_ph_tpu_torch.systems.water import solvated_acid
from constant_ph_tpu_torch.tiled.engine import TiledEngine
from constant_ph_tpu_torch.tiled.layout import split_system, to_tiled

from test_torch_layout import fields_dict, jax_tiled, port_of

torch.set_num_threads(1)

ALPHA = 0.35
NVE = dict(dt=1.0, thermostat="nve", lambda_thermostat="none",
           rebuild_every=4)
CASES = ("k1", "k2-boundary", "k2-off-boundary")


def tiled_forces_to_canonical(ts, st, fw, fs):
    """Tile force arrays (3, G, 3W) and (Ns, 3) → (N, 3) in atom order."""
    f = np.zeros((ts.n_atoms, 3))
    c, s = np.nonzero(st.wvalid.numpy() > 0.5)
    m = st.wid.numpy()[c, s]
    fw = fw.numpy()
    for a in range(3):
        f[ts.water_atom_ids[m, a]] = fw[:, c, 3 * s + a].T
    f[ts.solute_ids] = fs.numpy()[:len(ts.solute_ids)]
    return f


def self_term_atol(ts, st):
    """2e-5 of Cα/√π·Σq² (float64), kcal/mol."""
    vm = np.repeat(st.wvalid.numpy().astype(np.float64), 3, axis=-1)
    q2 = (np.sum(np.tile(ts.water.q_pattern, ts.params.W) ** 2 * vm)
          + np.sum(ts.solute.q0.numpy().astype(np.float64) ** 2))
    return 2e-5 * 332.06371 * ALPHA / np.sqrt(np.pi) * q2


@pytest.fixture(scope="module")
def case():
    _, jts, jst = jax_tiled("cut", ALPHA)
    tts, tst = port_of(jts, jst)
    jep = jewald.make_ewald_params(np.asarray(jst.box), ALPHA,
                                   accuracy=1e-5)
    tep = convert.ewald_params(fields_dict(jep), device="cpu")
    j1 = JEngine(jts, JConfig(**NVE), kspace_ep=jep)
    j2 = JEngine(jts, JConfig(kspace_every=2, **NVE), kspace_ep=jep)

    @jax.jit
    def jax_refs(st):
        b = j2.compute_forces(st, kspace_impulse=True)
        off = j2.compute_forces(st.replace(step=st.step + 1),
                                kspace_impulse=True,
                                phi_recip_prev=b.phi_recip_s)
        return {"k1": j1.compute_forces(st, kspace_impulse=True),
                "k2-boundary": b, "k2-off-boundary": off}

    return dict(jts=jts, jst=jst, tts=tts, tst=tst, tep=tep,
                ref=jax_refs(jst))


@pytest.mark.parametrize("which", CASES)
def test_tiled_ewald_matches_jax(case, which):
    tts, tst, tep = case["tts"], case["tst"], case["tep"]
    ref = case["ref"][which]
    k_ev = 1 if which == "k1" else 2
    eng = TiledEngine(tts, EngineConfig(kspace_every=k_ev, **NVE),
                      kspace_ep=tep)
    st, prev = tst, None
    if which == "k2-off-boundary":
        prev = eng.compute_forces(tst, kspace_impulse=True).phi_recip_s
        st = dataclasses.replace(tst, step=tst.step + 1,
                                 step_host=tst.step_host + 1)
    got = eng.compute_forces(st, kspace_impulse=True, phi_recip_prev=prev)
    for name in ("fw", "fs", "f_lam", "phi_s", "dUdlam", "phi_recip_s",
                 "eatom_w", "eatom_s"):
        a = np.asarray(getattr(ref, name))
        scale = max(1.0, np.abs(a).max())
        np.testing.assert_allclose(getattr(got, name).numpy() / scale,
                                   a / scale, atol=1e-5, err_msg=name)
    atol = self_term_atol(tts, tst)
    for name in ("e_lj", "e_coul", "e_bonded", "e_kspace", "e_site",
                 "e_pot"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(ref, name)), rtol=2e-5,
                                   atol=atol, err_msg=name)
    assert (float(got.e_kspace) == 0.0) == (which == "k2-off-boundary")


def test_tiled_ewald_matches_reference_engine():
    # the system tests/test_tiled.py::test_tiled_ewald_matches_reference
    # sets these bars on (190 atoms, rc 6); on the dilute test box the
    # Coulomb total is a −31.7 kcal/mol residue of ±35,000 terms, where
    # the two engines' treatments of the intra-water terms differ by 0.13
    # kcal/mol in both packages
    tsys = solvated_acid(n_side=4, rigid_water=True, lambda_coupled=True,
                         cutoff=6.0, skin=1.5, coul_style="cut",
                         alpha=ALPHA, seed=3, pH=5.0, device="cpu")
    tts = split_system(tsys, skin=1.5, device="cpu")
    tst = to_tiled(tts, tsys.state)
    ep = tewald.make_ewald_params(tsys.state.box.numpy(), ALPHA,
                                  accuracy=1e-5, device="cpu")
    ref_eng = tsys.make_engine(EngineConfig(**NVE),
                               kspace_fn=tewald.make_kspace_fn(ep))
    state = tsys.state
    nbr = ref_eng.build_neighbors(state.x, state.box)
    assert not bool(nbr.overflow)
    rf = ref_eng.compute_forces(state.x, state.lam, state.box, state.pH,
                                nbr)
    tf = TiledEngine(tts, EngineConfig(**NVE),
                     kspace_ep=ep).compute_forces(tst)
    # the reference sums the intra-water erf terms in real space; the
    # tiled path replaces them with an exact constant (e_corr)
    np.testing.assert_allclose(float(tf.e_coul + tf.e_kspace),
                               float(rf.e_coul + rf.e_kspace), rtol=3e-3)
    f_t = tiled_forces_to_canonical(tts, tst, tf.fw, tf.fs)
    f_r = rf.f.numpy()
    scale = np.abs(f_r).max()
    # the intra-molecular erf forces act along the bonds of the rigid
    # waters (the reference has them, the tiled path does not): compare
    # the solute atoms and each water molecule's net force, which they
    # leave unchanged
    np.testing.assert_allclose(f_t[tts.solute_ids] / scale,
                               f_r[tts.solute_ids] / scale, atol=2e-4)
    wids = tts.water_atom_ids
    np.testing.assert_allclose(f_t[wids].sum(1) / scale,
                               f_r[wids].sum(1) / scale, atol=2e-4)
    np.testing.assert_allclose(tf.dUdlam.numpy(), rf.dUdlam.numpy(),
                               rtol=1e-3, atol=1e-2)


def test_pme_matches_ewald_with_tally_sum_rule(case):
    tts, tst = case["tts"], case["tst"]
    box = tst.box.numpy()
    ep = tewald.make_ewald_params(box, ALPHA, accuracy=1e-6, device="cpu")
    pp = make_pme_params(box, tts.params.grid, ALPHA, spacing=1.0, p=6,
                         device="cpu")
    eng_ew = TiledEngine(tts, EngineConfig(**NVE), kspace_ep=ep)
    eng_pm = TiledEngine(tts, EngineConfig(**NVE), kspace_ep=pp)
    tf_ew = eng_ew.compute_forces(tst, need_tally=True)
    tf_pm = eng_pm.compute_forces(tst, need_tally=True)
    assert eng_ew.e_corr == eng_pm.e_corr != 0.0
    np.testing.assert_allclose(float(tf_pm.e_kspace), float(tf_ew.e_kspace),
                               atol=0.3)
    vm = torch.repeat_interleave(tst.wvalid, 3, dim=-1)
    scale = float(torch.abs(tf_ew.fw).max())
    np.testing.assert_allclose((tf_pm.fw * vm).numpy() / scale,
                               (tf_ew.fw * vm).numpy() / scale, atol=5e-4)
    np.testing.assert_allclose(tf_pm.fs.numpy(), tf_ew.fs.numpy(),
                               atol=5e-4 * scale)
    np.testing.assert_allclose(tf_pm.dUdlam.numpy(), tf_ew.dUdlam.numpy(),
                               rtol=2e-3, atol=1e-2)
    for eng, tf in ((eng_ew, tf_ew), (eng_pm, tf_pm)):
        HA, _ = eng.compute_Hs(tst, tf)
        want = float(tf.e_lj + tf.e_coul + tf.e_bonded + tf.e_kspace
                     - eng.e_corr)
        np.testing.assert_allclose(float(HA), want, rtol=1e-3)
    # NPT k-space needs PME: the Ewald tables are baked for one box
    with pytest.raises(ValueError, match="kspace_live_box requires PME"):
        TiledEngine(tts, EngineConfig(kspace_live_box=True), kspace_ep=ep)
