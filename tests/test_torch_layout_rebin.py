"""Parity of the port's rebin and retile with the JAX package, slot for
slot, on the box of tests/test_torch_layout.py (split from that file so
that no port test file collects more than five tests).
"""
import numpy as np
import pytest
import torch
from constant_ph_tpu.tiled import layout as jl
from constant_ph_tpu_torch.tiled import layout as tl

from test_torch_layout import (  # noqa: F401  (fixtures and helpers)
    _perturbed,
    assert_same_tiles,
    built,
    port_of,
)

# the suite runs six xdist workers on the same cores: one torch thread
# each keeps the port tests from oversubscribing them
torch.set_num_threads(1)


@pytest.mark.parametrize("fill_cell", [False, True])
def test_rebin_slot_for_slot(built, fill_cell):
    _, jts, jst, _ = built
    jst = _perturbed(jst, jts, fill_cell)
    tts, tst = port_of(jts, jst)
    jnew, jov = jl.rebin(jst, jts.params)
    tnew, tov = tl.rebin(tst, tts.params)
    assert bool(tov) == bool(jov) == fill_cell
    assert_same_tiles(jnew, tnew)
    assert int(tnew.wvalid.sum()) == len(jts.water_atom_ids)


def test_retile_matches(built):
    _, jts, jst, _ = built
    tts, tst = port_of(jts, jst)
    W = int(np.asarray(jst.wvalid).sum(axis=1).max()) + 4
    jts2, jst2 = jl.retile(jts, jst, W)
    tts2, tst2 = tl.retile(tts, tst, W)
    assert tts2.params.W == jts2.params.W
    assert_same_tiles(jst2, tst2)


def test_tiled_system_to_moves_every_table(built):
    """TiledSystem.to copies every table (the solute constraints' too) to
    the device it is given and leaves the original where it was."""
    import dataclasses

    _, jts, jst, _ = built
    tts, _ = port_of(jts, jst)
    moved = tts.to("meta")

    def tensors(ts):
        out = {"groupH_mask": ts.groupH_mask}
        for name in ("solute", "spec", "bonded"):
            obj = getattr(ts, name)
            if obj is not None:
                out.update({f"{name}.{f.name}": getattr(obj, f.name)
                            for f in dataclasses.fields(obj)
                            if isinstance(getattr(obj, f.name),
                                          torch.Tensor)})
        out.update({f"constraints.{k}": v
                    for k, v in vars(ts.solute_constraints).items()
                    if isinstance(v, torch.Tensor)})
        return out

    before, after = tensors(tts), tensors(moved)
    assert before.keys() == after.keys()
    assert any(k.startswith("constraints.") for k in after)
    assert all(t.device.type == "meta" for t in after.values())
    assert all(t.device.type == "cpu" for t in before.values())
    assert moved.device.type == "meta" and tts.device.type == "cpu"
    for name in ("params", "water", "n_atoms", "coul_style", "alpha",
                 "cutoff"):
        assert getattr(moved, name) == getattr(tts, name)
    assert np.array_equal(moved.solute_ids, tts.solute_ids)
