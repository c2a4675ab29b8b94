"""ΔG_ref calibration and titration utilities (port of
constant_ph_tpu/titration.py).

The site Hamiltonian term is f(λ)·[kT·ln10·(pK − pH) − ΔG_ref]
(lambda_dyn.ph_energy), where ΔG_ref = G_ff(λ=1) − G_ff(λ=0) of the
reference compound in solution. It comes from thermodynamic integration
over frozen-λ windows,

    ΔG_ref = ∫₀¹ ⟨dU_elec/dλ⟩_λ dλ        (7-point Gauss–Legendre)

on the tiled engine (``calibrate_dG_ref_tiled``) or the reference engine
(``calibrate_dG_ref``), or per site from one well-tempered
λ-metadynamics run (``calibrate_dG_ref_metad``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from constant_ph_tpu_torch import metad as metad_mod, units
from constant_ph_tpu_torch.lambda_dyn import BiasParams

# 7-point Gauss–Legendre nodes/weights on [0, 1]
_GL_X = np.array([0.02544604, 0.12923441, 0.29707742, 0.5,
                  0.70292258, 0.87076559, 0.97455396])
_GL_W = np.array([0.06474248, 0.13985270, 0.19091503, 0.20897959,
                  0.19091503, 0.13985270, 0.06474248])


def calibrate_dG_ref_tiled(
    tsys,
    tstate,
    cfg,
    *,
    bias=None,
    kspace_ep=None,
    site: int = 0,
    equil_steps: int = 500,
    sample_steps: int = 2000,
    call_steps: int | None = None,
    nodes=None,
    weights=None,
    return_profile: bool = False,
):
    """TI calibration on the tiled engine: at each node λ_site is set
    (the other sites at 0, v_λ = 0) and held (cfg.lambda_frozen), the
    state equilibrates for ``equil_steps`` and ⟨dU/dλ_site⟩ is averaged
    over ``sample_steps``. Returns ΔG_ref (and the (nodes, means) profile
    if asked). ``call_steps`` splits each phase into run calls of at most
    that many steps (same physics; the per-call means are averaged with
    equal weights). The input state should be equilibrated."""
    from constant_ph_tpu_torch.tiled.engine import TiledEngine

    if bias is None:
        bias = BiasParams()
    nodes = _GL_X if nodes is None else np.asarray(nodes)
    weights = _GL_W if weights is None else np.asarray(weights)

    cfg_frozen = dataclasses.replace(cfg, lambda_frozen=True)
    eng = TiledEngine(tsys, cfg_frozen, bias=bias, kspace_ep=kspace_ep)
    if call_steps is None:
        call_steps = max(equil_steps, sample_steps, 1)
    eq_chunk = max(1, min(equil_steps, call_steps))
    n_eq = -(-equil_steps // eq_chunk) if equil_steps else 0
    samp_chunk = max(1, min(sample_steps, call_steps))
    n_samp = -(-sample_steps // samp_chunk)
    run_eq = eng.make_run(eq_chunk)
    run_samp = eng.make_run(samp_chunk)

    means = []
    for lam_val in nodes:
        lam = torch.zeros_like(tstate.lam)
        lam[site] = float(lam_val)
        st = dataclasses.replace(tstate, lam=lam,
                                 v_lam=torch.zeros_like(tstate.v_lam))
        for _ in range(n_eq):
            st, _, _ = run_eq(st)
        acc = 0.0
        for _ in range(n_samp):
            st, _, obs = run_samp(st)
            acc += float(torch.mean(obs.dUdlam[:, site]))
        means.append(acc / n_samp)
    dG = float(np.dot(weights, np.asarray(means)))
    if return_profile:
        return dG, (np.asarray(nodes), np.asarray(means))
    return dG


def calibrate_dG_ref(
    system,
    cfg,
    *,
    bias=None,
    site: int = 0,
    kspace_fn=None,
    equil_steps: int = 500,
    sample_steps: int = 2000,
    minimize_steps: int = 300,
    nodes=None,
    weights=None,
):
    """TI calibration on the reference engine: the system's state is
    FIRE-minimised (``minimize_steps``), then at each node λ_site is set
    (the other sites at 0, v_λ = 0) and held, the state equilibrates for
    ``equil_steps`` from the minimised state and ⟨dU/dλ_site⟩ is averaged
    over ``sample_steps``. Every node starts from the list built on the
    minimised state; the noise comes from the engine's generator. Returns
    ΔG_ref."""
    from constant_ph_tpu_torch.minimize import fire_minimize

    if bias is None:
        bias = BiasParams()
    nodes = _GL_X if nodes is None else np.asarray(nodes)
    weights = _GL_W if weights is None else np.asarray(weights)

    cfg_frozen = dataclasses.replace(cfg, lambda_frozen=True)
    eng = system.make_engine(cfg_frozen, bias=bias, kspace_fn=kspace_fn)
    state0 = system.state
    if minimize_steps:
        state0, _ = fire_minimize(eng, state0, n_steps=minimize_steps)
    run_eq = eng.make_run(equil_steps)
    run_samp = eng.make_run(sample_steps)
    nbr = eng.build_neighbors(state0.x, state0.box)

    means = []
    for lam_val in nodes:
        lam = torch.zeros_like(state0.lam)
        lam[site] = float(lam_val)
        st = dataclasses.replace(state0, lam=lam,
                                 v_lam=torch.zeros_like(state0.v_lam))
        st, _, _ = run_eq(st, nbr)
        st, _, obs = run_samp(st, nbr)
        means.append(torch.mean(obs.dUdlam[:, site]))
    # one read at the end
    return float(np.dot(weights, torch.stack(means).cpu().numpy()))


def apply_dG_ref(spec, dG_ref):
    """A LambdaSpec with per-site ΔG_ref installed (a scalar broadcasts; a
    length-S array sets sites individually)."""
    val = torch.as_tensor(np.asarray(dG_ref), dtype=spec.dG_ref.dtype,
                          device=spec.dG_ref.device)
    return dataclasses.replace(
        spec, dG_ref=torch.broadcast_to(val, spec.dG_ref.shape).clone())


def parse_class_offsets(text):
    """Parse a per-pK-class ΔG_ref offset spec "pK:off[,pK:off...]"
    (e.g. "4.25:-0.89,6.5:0.12") into {pK: offset_kcal}; empty or None
    gives {}."""
    out = {}
    for item in (text or "").split(","):
        item = item.strip()
        if not item:
            continue
        k, _, v = item.partition(":")
        out[float(k)] = float(v)
    return out


def apply_dG_ref_per_class(spec, dG_base, class_offsets, tol=1e-3):
    """Install per-site ΔG_ref = dG_base + offset(pK class of the site).
    ``class_offsets`` maps a pK value (matched to spec.pK within ``tol``)
    to its offset in kcal/mol; a key that matches no site raises (a typo
    would otherwise install the base constant)."""
    pks = spec.pK.detach().cpu().numpy()
    dg = np.full(pks.shape, float(dG_base))
    for pk, off in (class_offsets or {}).items():
        m = np.abs(pks - float(pk)) <= tol
        if not m.any():
            raise ValueError(
                f"dG_ref class offset for pK={pk}: no site has that pK "
                f"(spec classes: {sorted(set(np.round(pks, 4).tolist()))})")
        dg[m] += float(off)
    return apply_dG_ref(spec, dg)


def never_crossed(V, grid, h0: float) -> np.ndarray:
    """(S,) bool: the site's hills all landed in one basin, so its walker
    never crossed the λ barrier and the basin ΔF would read back the fill
    height. Tests the well windows (λ < 0.25 and λ > 0.75), not the half
    lines: a thermal excursion can drop a hill in the barrier region of
    the far basin, but only a crossing reaches the far well bottom. Fires
    when one well holds less than h0/2 of bias and the other more than
    2·h0. V: (S, nbins) on the host grid ``grid``."""
    V = np.asarray(V)
    grid = np.asarray(grid)
    fill_prot = V[:, grid < 0.25].max(axis=1)
    fill_dep = V[:, grid > 0.75].max(axis=1)
    return ((np.minimum(fill_dep, fill_prot) < 0.5 * h0)
            & (np.maximum(fill_dep, fill_prot) > 2.0 * h0))


def check_crossed(V, grid, h0: float, df=None, *, gamma=None,
                  n_steps=None):
    """Raise RuntimeError naming the sites that ``never_crossed`` flags or
    whose ΔF estimate ``df`` (S,) is not finite; return None when every
    site crossed."""
    bad = np.where(never_crossed(V, grid, h0))[0].tolist()
    if df is not None:
        bad = sorted(set(bad) | set(np.where(~np.isfinite(df))[0].tolist()))
    if bad:
        raise RuntimeError(
            f"metad calibration never crossed the λ barrier on sites {bad}"
            f" after {n_steps} steps (hills in one basin only): the basin "
            f"free-energy difference would read back the fill height, not "
            f"physics. The well-tempered fill saturates near (γ−1)·kT, so "
            f"γ must satisfy γ ≳ 1 + F_barrier/kT (got γ={gamma}); "
            f"full-Δq landscapes need γ ~ 25-40, σ ~ 0.05, h0 ~ 0.4. Raise "
            f"gamma, run longer (n_steps) or spread the compensating "
            f"charge over more buffer waters.")


def calibrate_dG_ref_metad(
    tsys,
    tstate,
    cfg,
    *,
    bias=None,
    kspace_ep=None,
    metad_params=None,
    n_steps: int = 60_000,
    chunk: int | None = None,
    tail_frac: float = 0.5,
    on_stuck: str = "raise",
):
    """Per-site ΔG_ref from one well-tempered λ-metadynamics run: at the
    state's pH Henderson–Hasselbalch wants ΔF_s = kT·ln10·(pK_s − pH), so

        ΔG_ref_s ← ΔG_ref_s(current) + (ΔF_s(measured) − ΔF_s(wanted))

    with ΔF_s the tail-time average (last ``tail_frac`` of the chunks) of
    metad.delta_f_sites. Returns the (S,) array; install it with
    apply_dG_ref. A site whose walker never crossed or whose ΔF is not
    finite raises (``check_crossed``), or with ``on_stuck="nan"`` comes
    back as NaN."""
    from constant_ph_tpu_torch.tiled.engine import TiledEngine

    if bias is None:
        bias = BiasParams()
    # campaign-strength default: γ must satisfy γ ≳ 1 + F_barrier/kT
    mp = metad_params or metad_mod.MetadParams(
        nbins=241, sigma=0.05, h0=0.4, gamma=30.0,
        stride=max(1, int(round(50.0 / cfg.dt))))
    S = tsys.spec.n_sites
    V0, dV0 = metad_mod.init_tables(S, mp, device=tstate.lam.device)
    st = dataclasses.replace(tstate, metad_v=V0, metad_dv=dV0,
                             v_lam=torch.zeros_like(tstate.v_lam))
    eng = TiledEngine(tsys, cfg, bias=bias, kspace_ep=kspace_ep, metad=mp)
    if chunk is None:
        chunk = 50 * cfg.rebuild_every
    run = eng.make_run(chunk)
    n_chunks = max(1, n_steps // chunk)
    dfs = []
    for _ in range(n_chunks):
        st, _, _ = run(st)
        dfs.append(metad_mod.delta_f_sites(st.metad_v, mp).cpu().numpy())
    tail = max(1, int(round(tail_frac * len(dfs))))
    df_meas = np.mean(np.stack(dfs[-tail:]), axis=0)              # (S,)
    V_fin = st.metad_v.cpu().numpy()
    grid = mp.grid().numpy()
    if on_stuck == "nan":
        # survey mode: the stuck sites come back as NaN
        stuck = never_crossed(V_fin, grid, mp.h0) | ~np.isfinite(df_meas)
        df_meas = np.where(stuck, np.nan, df_meas)
    else:
        check_crossed(V_fin, grid, mp.h0, df_meas, gamma=mp.gamma,
                      n_steps=n_steps)
    kT = units.BOLTZ * cfg.T
    pH = float(tstate.pH)
    df_want = kT * units.LN10 * (tsys.spec.pK.cpu().numpy() - pH)
    dG_now = tsys.spec.dG_ref.cpu().numpy()
    return dG_now + (df_meas - df_want)
