"""The plain reference against the port at a small size, within each
cell's limits, and the control (the reference in TF32) outside them."""
import pytest
import torch

from cph_bench import prepare
from cph_bench.reference import forces as rf
from cph_bench.tests.small import cell, cells


def _port(c, seed):
    from constant_ph_tpu_torch import convert
    from constant_ph_tpu_torch.ops.pme import make_pme_params
    from constant_ph_tpu_torch.tiled.engine import TiledEngine
    from constant_ph_tpu_torch.tiled.layout import split_system, to_tiled

    d = prepare.inputs(c.config, seed)
    system = convert.system(d, "cpu")
    ts = split_system(system, device="cpu", **c.config["split"])
    ts = prepare.with_dG_ref(ts, c.config["dG_ref"])
    st = to_tiled(ts, system.state)
    pme = None
    if c.config.get("pme"):
        pc = c.config["pme"]
        pme = make_pme_params(system.state.box.numpy(), ts.params.grid,
                              pc["alpha"], spacing=pc["spacing"], p=pc["p"],
                              skin=c.config["split"]["skin"], device="cpu")
        assert list(pme.mesh) == pc["mesh"]
    eng = TiledEngine(ts, prepare.engine_config(c.config["engine"], seed),
                      kspace_ep=pme)
    return d, st, eng.compute_forces(st)


def _gaps(ref, F, e, f_lam):
    Fr = ref.f_short + ref.f_recip
    return dict(
        force_gap=float(torch.max(torch.abs(F - Fr))
                        / torch.max(torch.abs(Fr))),
        energy_gap=abs(e - ref.e_pot) / ref.scale,
        lambda_force_gap=float(torch.max(torch.abs(f_lam - ref.f_lam)))
        / max(1.0, float(torch.max(torch.abs(ref.du_elec)))))


@pytest.mark.parametrize("name", cells())
def test_reference_holds_the_port_and_fails_the_control(name):
    c = cell(name)
    d, st, frc = _port(c, 21)
    top = rf.topology(d, "cpu")
    batch = type("B", (), dict(wvalid=st.wvalid[None], wid=st.wid[None]))
    X = prepare.atom_order(top, batch, st.wx[None], st.sx[None])[0]
    pc = c.config.get("pme")
    kw = dict(T=c.config["engine"]["T"], dG_ref=c.config["dG_ref"],
              pme=pc and dict(alpha=pc["alpha"], mesh=pc["mesh"], p=pc["p"]))
    ref = rf.evaluate(X, st.box, st.lam, float(st.pH), top, **kw)
    low = rf.evaluate(X, st.box, st.lam, float(st.pH), top,
                      prec=rf.Precision("tf32"), **kw)
    program = _gaps(ref, prepare.atom_order(top, batch, frc.fw[None],
                                            frc.fs[None])[0],
                    float(frc.e_pot), frc.f_lam.to(torch.float64))
    control = _gaps(ref, low.f_short + low.f_recip, low.e_pot,
                    low.f_lam)
    limits = c.config["limits"]
    for k, v in program.items():
        assert v <= limits[k], (k, v, limits[k])
    assert any(v > 3 * limits[k] for k, v in control.items()), control
