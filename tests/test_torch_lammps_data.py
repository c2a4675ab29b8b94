"""Parity of the port's LAMMPS deck I/O and exclusion builder with the JAX
package (constant_ph_tpu_torch/systems/lammps_data.py, forcefield.py,
native/).

The deck is the one of tests/test_data_roundtrip.py:27 (a 6-residue
solvated polypeptide, 24 Å box, 3 sites), written by the JAX writer.
- Both of the port's readers (its own C++ parser and the Python one)
  give the JAX reader's arrays exactly, and the port's writers give the
  JAX writers' bytes on the same System (carried across by
  convert.system).
- system_from_deck builds the JAX package's System field by field: force
  field, masked rigid-water springs, state, sites in both the dq form
  and the q_prot/q_deprot + buffer form, groupH_mask, neighbour sizing.
- The native exclusion builder gives the JAX package's tables exactly
  (JAX builds them with the same C++ walk), and the same (partner, code)
  set in every row as the Python builder, which sorts partners by id.
- The four malformed decks of tests/test_lammps_data.py raise the JAX
  reader's errors, or parse to its arrays.
No JAX function with a force evaluation is compiled here.
"""
import dataclasses

import numpy as np
import pytest
import torch

from constant_ph_tpu import forcefield as jff
from constant_ph_tpu.systems import lammps_data as jld
from constant_ph_tpu.systems.protein import solvated_polypeptide
from constant_ph_tpu_torch import convert, forcefield as tff
from constant_ph_tpu_torch.systems import lammps_data as tld

from test_torch_layout import fields_dict

torch.set_num_threads(1)

POLY = dict(n_residues=6, sites_every=2, box_len=24.0, water_spacing=3.4,
            cutoff=6.0, skin=1.5, coul_style="dsf", alpha=0.2, pH=5.0,
            seed=3)
DECK = dict(cutoff=6.0, skin=1.5, coul_style="dsf", alpha=0.2,
            rigid_water_types=[6, 7], pH=5.0)


def jax_system_dict(s):
    """A JAX System → the numpy dict convert.system takes."""
    ff, p, c = s.ff, s.ff.pair, s.constraints

    def opt(x):
        return None if x is None else fields_dict(x)

    return dict(
        ff=dict(mass=np.asarray(ff.mass), q0=np.asarray(ff.q0),
                type=np.asarray(ff.type),
                pair=dict(c12=np.asarray(p.c12), c6=np.asarray(p.c6),
                          e_shift=np.asarray(p.e_shift), cutoff=p.cutoff,
                          coul_cutoff=p.coul_cutoff, alpha=p.alpha,
                          coul_style=p.coul_style,
                          special_lj=np.asarray(p.special_lj),
                          special_coul=np.asarray(p.special_coul)),
                bonded=fields_dict(ff.bonded),
                excl_idx=np.asarray(ff.excl_idx),
                excl_code=np.asarray(ff.excl_code)),
        state=fields_dict(s.state),
        nbr_params=dataclasses.asdict(s.nbr_params),
        bonded=opt(s.bonded), spec=opt(s.spec),
        constraints=None if c is None else dict(
            triplets=np.asarray(c.triplets), masses=np.asarray(ff.mass),
            d01=float(np.sqrt(c.d2[0])), d12=float(np.sqrt(c.d2[2]))),
        groupH_mask=(None if s.groupH_mask is None
                     else np.asarray(s.groupH_mask)))


def assert_same_system(jsys, tsys):
    """Every field of a port System equals the JAX System's (values and
    shapes; integer widths may differ)."""
    def same(a, b, name):
        if isinstance(b, torch.Tensor):
            b = b.numpy()
        if isinstance(a, (str, float, int, tuple)) and not isinstance(
                a, np.ndarray):
            assert a == b, name
            return
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)

    jd = jax_system_dict(jsys)
    for key in ("ff", "state", "bonded", "spec"):
        if jd[key] is None:
            assert getattr(tsys, key) is None, key
            continue
        obj = getattr(tsys, key)
        for name, val in jd[key].items():
            if name == "key":
                continue
            if isinstance(val, dict):
                for sub, v in val.items():
                    same(v, getattr(getattr(obj, name), sub),
                         f"{key}.{name}.{sub}")
            else:
                same(val, getattr(obj, name), f"{key}.{name}")
    assert dataclasses.asdict(tsys.nbr_params) == jd["nbr_params"]
    np.testing.assert_array_equal(tsys.constraints.triplets.numpy(),
                                  np.asarray(jsys.constraints.triplets))
    np.testing.assert_array_equal(tsys.constraints.d2, jsys.constraints.d2)
    np.testing.assert_array_equal(tsys.groupH_mask.numpy(),
                                  np.asarray(jsys.groupH_mask))


@pytest.fixture(scope="module")
def deck(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("deck")
    jsys = solvated_polypeptide(**POLY)
    path, sidecar = str(tmp / "poly.data"), str(tmp / "poly.sites.json")
    jld.write_lammps_data(path, jsys)
    jld.write_sites_json(sidecar, jsys)
    return jsys, path, sidecar, tmp


def test_readers_and_writers_match_jax(deck):
    jsys, path, sidecar, tmp = deck
    want = jld.read_lammps_data(path)
    for reader in (tld._read_native, tld._read_python):
        got = reader(path)
        assert set(got) == set(want) - {"coeffs"}
        for k, v in got.items():
            assert v.dtype == want[k].dtype, k
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    got = tld.read_lammps_data(path)
    assert tld.read_lammps_data.last_reader == "native"
    assert got["coeffs"] == want["coeffs"]
    # the port's writers on the same System: the JAX writers' bytes
    tsys = convert.system(jax_system_dict(jsys), device="cpu")
    tld.write_lammps_data(str(tmp / "port.data"), tsys)
    tld.write_sites_json(str(tmp / "port.sites.json"), tsys)
    for a, b in ((path, "port.data"), (sidecar, "port.sites.json")):
        with open(a, "rb") as fa, open(tmp / b, "rb") as fb:
            assert fa.read() == fb.read(), b


def _buffer_form_sites(jsys):
    """The sidecar's sites in the q_prot/q_deprot + buffer form: the acid
    atoms' end-state charges, the buffer water atoms listed apart."""
    q0 = np.asarray(jsys.ff.q0, np.float64)
    sites = []
    for s in range(int(jsys.spec.pK.shape[0])):
        m = np.asarray(jsys.spec.atom_mask[s]) > 0.5
        atoms = np.asarray(jsys.spec.atom_idx[s])[m]
        dq = np.asarray(jsys.spec.dq[s], np.float64)[m]
        sites.append(dict(
            atoms=atoms[:4].tolist(), q_prot=q0[atoms[:4]].tolist(),
            q_deprot=(q0[atoms[:4]] + dq[:4]).tolist(),
            buffer=atoms[4:].tolist(), pK=float(jsys.spec.pK[s]),
            hydrogen=int(atoms[3])))
    return sites


def test_system_from_deck_matches_jax(deck):
    jsys, path, sidecar, _ = deck
    jd = jld.system_from_deck(path, sites_json=sidecar, **DECK)
    td = tld.system_from_deck(path, sites_json=sidecar, device="cpu", **DECK)
    assert_same_system(jd, td)
    # the rigid-water springs are masked out of System.bonded only
    n_rigid = 2 * int(td.constraints.triplets.shape[0])
    assert int((td.bonded.bond_mask == 0).sum()) == n_rigid
    assert int((td.ff.bonded.bond_mask == 0).sum()) == 0
    # the q_prot/q_deprot + buffer form gives the same site table
    sites = _buffer_form_sites(jsys)
    kw = {k: v for k, v in DECK.items() if k != "rigid_water_types"}
    jb = jld.system_from_lammps_data(
        path, rigid_water_types=(6, 7), titratable_sites=sites, **kw)
    tb = tld.system_from_lammps_data(
        path, rigid_water_types=(6, 7), titratable_sites=sites,
        device="cpu", **kw)
    assert_same_system(jb, tb)
    np.testing.assert_allclose(tb.spec.dq.numpy(), td.spec.dq.numpy(),
                               atol=1e-7)


def test_exclusion_builders_agree(deck):
    jsys, _, _, _ = deck
    bonds = np.concatenate([np.asarray(jsys.bonded.bond_idx),
                            np.asarray(jsys.constraints.triplets)[:, [0, 1]],
                            np.asarray(jsys.constraints.triplets)[:, [0, 2]],
                            np.asarray(jsys.constraints.triplets)[:, [1, 2]]])
    # a branched chain as well (tests/test_lammps_data.py's graph)
    chain = [(i - 1, i) for i in range(1, 200)]
    chain += [(i, i + 3) for i in range(7, 197, 7)]
    for n, b, ke in ((int(jsys.ff.mass.shape[0]), bonds, 24),
                     (200, np.asarray(chain), 32)):
        native = tff.build_exclusions(n, b, max_excl=ke)
        assert tff.build_exclusions.last_path == "native"
        for got, want in zip(native, jff.build_exclusions(n, b,
                                                          max_excl=ke)):
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, np.asarray(want))
        idx, code = tff._build_exclusions_python(n, b, ke)
        for i in range(n):
            assert (sorted(zip(idx[i], code[i]))
                    == sorted(zip(native[0][i], native[1][i]))), i
    for build in (tff._build_exclusions_native,
                  tff._build_exclusions_python):
        with pytest.raises(ValueError, match="exclusion capacity 4"):
            build(200, np.asarray(chain), 4)


MALFORMED = {
    "style": lambda t: t.replace("Atoms # full", "Atoms # molecular"),
    "tilt": lambda t: t.replace("zlo zhi", "zlo zhi\n2.5 0.0 0.0 xy xz yz"),
    "tilt0": lambda t: t.replace("zlo zhi", "zlo zhi\n0.0 0.0 0.0 xy xz yz"),
    "pairij": lambda t: t + "\nPairIJ Coeffs\n\n1 1 0.1 3.0\n",
}


def _reordered(text):
    """Sections emitted in reverse order, with comments and blank lines
    injected (tests/test_lammps_data.py's benign mutation)."""
    import re

    lines = text.splitlines()
    first = next(i for i, line in enumerate(lines[1:], 1)
                 if re.match(r"^[A-Za-z]", line.split("#")[0].strip()))
    head, body = lines[:first], lines[first:]
    secs, cur = [], []
    for line in body:
        if re.match(r"^[A-Za-z]", line.split("#")[0].strip()) and cur:
            secs.append(cur)
            cur = [line]
        else:
            cur.append(line)
    secs.append(cur)
    out = head + ["# injected comment"]
    for s in reversed(secs):
        out += s + ["", "# another comment"]
    return "\n".join(out) + "\n"


def test_malformed_decks_raise_as_jax(deck):
    _, path, _, tmp = deck
    text = open(path).read()
    cases = dict(MALFORMED, reordered=_reordered)
    raised = []
    for name, mutate in cases.items():
        out = str(tmp / f"{name}.data")
        with open(out, "w") as fh:
            fh.write(mutate(text))
        try:
            want = jld.read_lammps_data(out)
        except ValueError as err:
            with pytest.raises(ValueError) as got:
                tld.read_lammps_data(out)
            assert str(got.value) == str(err), name
            raised.append(name)
            continue
        got = tld.read_lammps_data(out)
        for k in ("x", "v", "q", "type", "bonds", "angles", "box"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=name)
    assert raised == ["style", "tilt", "pairij"]
