"""The frozen builders give the systems chip_smoke.py runs, and the
benchmark's own pair count is the port's."""
import copy

import numpy as np
import pytest
import torch

from cph_bench import harness, prepare, roofline
from cph_bench.reference import forces as rf
from cph_bench.tests.small import ACID, ROOT, cell


def _acid_24k():
    """chip_smoke's PME main path: the acid in 24,001 atoms."""
    cfg = copy.deepcopy(ACID)
    cfg["builder"]["params"]["n_side"] = 20
    return cfg


def _campaign():
    return harness.load_cell(ROOT, "peptide20_dsf_27k.metad_r12").config


@pytest.mark.parametrize("config,shape", [
    (_campaign, dict(atoms=27300, sites=20, grid=[6, 6, 6], W=80, Ns=600)),
    (_acid_24k, dict(atoms=24001, sites=1, grid=[6, 6, 6], W=76)),
], ids=["campaign", "pme"])
def test_frozen_builders_give_the_campaign_and_pme_shapes(config, shape):
    from constant_ph_tpu_torch import convert
    from constant_ph_tpu_torch.tiled.layout import split_system

    cfg = config()
    system = convert.system(prepare.inputs(cfg, 3), "cpu")
    ts = split_system(system, device="cpu", **cfg["split"])
    got = prepare.shape_of(system, ts)
    assert {k: got[k] for k in shape} == shape
    assert {k: got[k] for k in (cfg["shape"] or {})} == (cfg["shape"] or {})


def test_a_seed_changes_the_system_and_not_its_shape():
    cfg = _campaign()
    a, b = (prepare.inputs(cfg, s) for s in (5, 2**31 + 7))
    assert a["state"]["x"].shape == b["state"]["x"].shape
    assert not np.allclose(a["state"]["x"], b["state"]["x"])
    np.testing.assert_array_equal(
        prepare.inputs(cfg, 5)["state"]["x"], a["state"]["x"])


def test_pair_count_is_the_ports():
    from constant_ph_tpu_torch import convert
    from constant_ph_tpu_torch.tiled import forces
    from constant_ph_tpu_torch.tiled.layout import split_system, to_tiled

    c = cell("acid_pme_tiny.rex_r16")
    d = prepare.inputs(c.config, 11)
    system = convert.system(d, "cpu")
    ts = split_system(system, device="cpu", **c.config["split"])
    st = to_tiled(ts, system.state)
    p = ts.params
    wxg = st.wx.reshape(3, *p.grid, 3 * p.W)
    port = int(forces.water_pairs_in_cutoff(wxg, p, st.box, p.cutoff))
    top = rf.topology(d, "cpu")
    x = torch.as_tensor(d["state"]["x"], dtype=torch.float32)
    ours = roofline.water_pairs_in_cutoff(
        x[torch.as_tensor(top.tiled_waters)],
        torch.as_tensor(d["state"]["box"], dtype=torch.float32), p.cutoff)
    assert ours == port > 0
