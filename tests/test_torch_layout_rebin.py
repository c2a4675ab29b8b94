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
