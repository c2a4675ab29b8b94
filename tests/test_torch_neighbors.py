"""Parity of the port's neighbour list (constant_ph_tpu_torch/neighbors.py)
with the JAX package's.

- make_neighbor_params: every field equal, on the all-pairs and the cell
  path (grids of 3 and more cells a dimension), and the same refusal.
- build_neighbor_list on the same float32 positions: each row holds the
  same neighbour ids with the same special-bond codes. Rows are compared
  sorted by id: torch.topk and jax.lax.top_k may order equal distances
  otherwise.
- Both overflow flags (list capacity and cell capacity) as JAX sets them.
- needs_rebuild at skin/2 ± 1e-3 Å, also across the box boundary.
"""
import dataclasses

import numpy as np
import jax
import pytest
import torch

from constant_ph_tpu import neighbors as jn
from constant_ph_tpu.systems.water import solvated_acid as jax_solvated_acid
from constant_ph_tpu_torch import convert, neighbors as tn
from constant_ph_tpu_torch.systems.water import solvated_acid

torch.set_num_threads(1)

# n_side 8 at the default 3.2 Å spacing: 1,537 atoms in a 25.6 Å box, rc 6
# + skin 1.5 → a 3³ cell grid; n_side 4: 190 atoms, the all-pairs path
CELLS = dict(n_side=8, cutoff=6.0, skin=1.5, seed=5, coul_style="dsf",
             alpha=0.2)
ALL_PAIRS = dict(CELLS, n_side=4)


def jax_list_dict(nbr):
    return {f.name: np.asarray(getattr(nbr, f.name))
            for f in dataclasses.fields(nbr)}


def sorted_rows(idx, code):
    order = np.argsort(idx, axis=1, kind="stable")
    return (np.take_along_axis(idx, order, 1),
            np.take_along_axis(code, order, 1))


def build(kw):
    jsys = jax_solvated_acid(**kw)
    tsys = solvated_acid(device="cpu", **kw)
    excl = (torch.as_tensor(tsys.ff.excl_idx, dtype=torch.int64),
            torch.as_tensor(tsys.ff.excl_code, dtype=torch.int64))
    return jsys, tsys, excl


@pytest.fixture(scope="module")
def systems():
    return {"cells": build(CELLS), "all_pairs": build(ALL_PAIRS)}


def test_make_neighbor_params_fields():
    cases = [
        (np.array([25.6] * 3), 6.0, dict(n_atoms=1537, skin=1.5)),
        (np.array([64.0] * 3), 8.0, dict(n_atoms=24001, skin=0.8)),
        (np.array([30.0, 40.0, 50.0]), 9.0, dict(n_atoms=5000)),
        (np.array([16.2] * 3), 8.0, dict(n_atoms=108)),
        (np.array([40.0] * 3), 6.0, dict(n_atoms=2000, capacity=100,
                                         target_cells_per_cutoff=2,
                                         use_cells=True, safety=1.2)),
    ]
    for box, rc, kw in cases:
        j = jn.make_neighbor_params(box, rc, **kw)
        t = tn.make_neighbor_params(box, rc, **kw)
        for f in dataclasses.fields(j):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert tn.make_neighbor_params(np.array([64.0] * 3), 8.0,
                                   n_atoms=24001, skin=0.8).grid == (7, 7, 7)
    with pytest.raises(ValueError, match="half the smallest box"):
        tn.make_neighbor_params(np.array([10.0] * 3), 6.0, n_atoms=10)


@pytest.mark.parametrize("path", ["cells", "all_pairs"])
def test_build_matches_jax_row_by_row(systems, path):
    jsys, tsys, excl = systems[path]
    jp, tp = jsys.nbr_params, tsys.nbr_params
    assert tp == convert.neighbor_params(
        {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})
    assert tp.use_cells == (min(tp.grid) >= 3)
    jnb = jax.jit(jn.build_neighbor_list)(jsys.state.x, jsys.state.box, jp,
                                          jsys.ff.excl_idx,
                                          jsys.ff.excl_code)
    tnb = tn.build_neighbor_list(tsys.state.x, tsys.state.box, tp, *excl)
    assert not bool(jnb.overflow) and not bool(tnb.overflow)
    ji, jc = sorted_rows(np.asarray(jnb.idx), np.asarray(jnb.code))
    ti, tc = sorted_rows(tnb.idx.numpy(), tnb.code.numpy())
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tc, jc)
    # the special codes are there: water 1-2 and 1-3 pairs
    assert (tc == 1).any() and (tc == 2).any()
    np.testing.assert_array_equal(tnb.x_ref.numpy(), np.asarray(jnb.x_ref))


def test_overflow_flags_match(systems):
    jbuild = jax.jit(jn.build_neighbor_list)
    cases = [("cells", dict(capacity=64)),           # the list's capacity
             ("all_pairs", dict(capacity=64)),
             ("cells", dict(cell_capacity=16))]      # a cell's capacity
    for path, change in cases:
        jsys, tsys, excl = systems[path]
        jp = jsys.nbr_params
        jq = dataclasses.replace(jp, **change)
        tq = dataclasses.replace(tsys.nbr_params, **change)
        jnb = jbuild(jsys.state.x, jsys.state.box, jq, jsys.ff.excl_idx,
                     jsys.ff.excl_code)
        tnb = tn.build_neighbor_list(tsys.state.x, tsys.state.box, tq,
                                     *excl)
        assert bool(jnb.overflow) and bool(tnb.overflow), (path, change)


def test_needs_rebuild_at_half_skin(systems):
    jsys, tsys, excl = systems["cells"]
    jp, tp = jsys.nbr_params, tsys.nbr_params
    jnb = jn.build_neighbor_list(jsys.state.x, jsys.state.box, jp,
                                 jsys.ff.excl_idx, jsys.ff.excl_code)
    tnb = convert.neighbor_list(jax_list_dict(jnb), device="cpu")
    box = tsys.state.box
    x0 = tsys.state.x
    i_edge = int(torch.argmax(x0[:, 0]))          # nearest the +x face
    for eps, want in ((1e-3, True), (-1e-3, False)):
        d = 0.5 * tp.skin + eps
        for i, shift in ((7, d), (i_edge, d - float(box[0]))):
            x = x0.clone()
            x[i, 0] += shift
            got = bool(tn.needs_rebuild(tnb, x, box, tp))
            ref = bool(jn.needs_rebuild(jnb, jax.numpy.asarray(x.numpy()),
                                        jsys.state.box, jp))
            assert got == ref == want, (eps, i)
    assert not bool(tn.needs_rebuild(tnb, x0, box, tp))
