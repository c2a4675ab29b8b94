"""LAMMPS data-file reader and writer → System (port of
constant_ph_tpu/systems/lammps_data.py).

The bulky sections (Atoms, Velocities, Bonds, …) are parsed by the port's
native C++ reader (native/lammps_data.cpp, built with g++ at first use)
where g++ is available, else by the Python parser; the coefficient
sections (Masses, Pair/Bond/Angle/Dihedral/Improper Coeffs) are parsed
here. Styles assumed: pair lj/cut/coul/* (eps sigma), harmonic
bonds/angles (k r0 / k theta0[deg]), CHARMM dihedrals (k n d[deg] ...),
harmonic impropers (k chi0[deg]) — the LAMMPS "real" conventions.
Deck features both parsers would mis-read (a triclinic tilt, another
Atoms style, an unknown section) are refused by name.

Builders take ``dtype`` and ``device`` (default ``"cuda"``, which raises
without CUDA); parsing and topology work stay on the host.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import re

import numpy as np
import torch

from constant_ph_tpu_torch import resolve_device
from constant_ph_tpu_torch.forcefield import (
    BondedParams,
    ForceField,
    build_exclusions,
    make_pair_params,
)
from constant_ph_tpu_torch.lambda_dyn import make_single_site, stack_sites
from constant_ph_tpu_torch.neighbors import make_neighbor_params
from constant_ph_tpu_torch.ops.constraints import RigidTriatomic
from constant_ph_tpu_torch.state import make_state
from constant_ph_tpu_torch.systems.base import System


def _host(a) -> np.ndarray:
    """A tensor (or array) as a host numpy array of its own dtype."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _read_native(path: str):
    """The C++ parser's arrays (None without g++)."""
    from constant_ph_tpu_torch.native.build import load_library

    lib = load_library("lammps_data")
    if lib is None:
        return None
    lib.ld_open.restype = ctypes.c_int64
    sizes = (ctypes.c_int64 * 6)()
    if lib.ld_open(str(path).encode(), sizes) != 0:
        lib.ld_close()
        raise IOError(f"cannot parse {path}")
    na, nb, nan, nd, ni, nt = [int(s) for s in sizes]

    def d(n):
        return np.zeros(n, dtype=np.float64)

    def i(n):
        return np.zeros(n, dtype=np.int64)

    x, v, q = d(na * 3), d(na * 3), d(na)
    ty, mol = i(na), i(na)
    mass_t, eps_t, sig_t = d(nt), d(nt), d(nt)
    bonds, angles = i(nb * 3), i(nan * 4)
    dihedrals, impropers = i(nd * 5), i(ni * 5)
    box = d(6)

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    def ipt(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    lib.ld_fill(ptr(x), ptr(v), ptr(q), ipt(ty), ipt(mol), ptr(mass_t),
                ptr(eps_t), ptr(sig_t), ipt(bonds), ipt(angles),
                ipt(dihedrals), ipt(impropers), ptr(box))
    lib.ld_close()
    return {
        "x": x.reshape(na, 3), "v": v.reshape(na, 3), "q": q,
        "type": ty, "mol": mol, "mass_by_type": mass_t,
        "pair_eps": eps_t, "pair_sig": sig_t,
        "bonds": bonds.reshape(nb, 3), "angles": angles.reshape(nan, 4),
        "dihedrals": dihedrals.reshape(nd, 5),
        "impropers": impropers.reshape(ni, 5), "box": box,
    }


def _read_python(path: str):
    """The Python parser (same subset as the native reader)."""
    header = {}
    box = np.zeros(6)
    sections: dict = {}
    cur = None
    lines = open(path).read().splitlines()
    for raw in lines[1:]:
        line = raw.split("#")[0].strip()
        if not line:
            continue
        if re.match(r"^[A-Za-z]", line):
            # keep the raw line: the style comment ("Atoms # charge") matters
            cur = raw.strip()
            sections[cur] = []
            continue
        low = line.lower()
        if low.endswith("atoms"):
            header["atoms"] = int(line.split()[0]); continue
        if low.endswith("bonds"):
            header["bonds"] = int(line.split()[0]); continue
        if low.endswith("angles"):
            header["angles"] = int(line.split()[0]); continue
        if low.endswith("dihedrals"):
            header["dihedrals"] = int(line.split()[0]); continue
        if low.endswith("impropers"):
            header["impropers"] = int(line.split()[0]); continue
        if low.endswith("atom types"):
            header["types"] = int(line.split()[0]); continue
        if "xlo xhi" in low:
            box[0:2] = [float(t) for t in line.split()[:2]]; continue
        if "ylo yhi" in low:
            box[2:4] = [float(t) for t in line.split()[:2]]; continue
        if "zlo zhi" in low:
            box[4:6] = [float(t) for t in line.split()[:2]]; continue
        if cur is not None:
            sections[cur].append(line)

    na = header.get("atoms", 0)
    nt = header.get("types", 0)
    out = {
        "x": np.zeros((na, 3)), "v": np.zeros((na, 3)), "q": np.zeros(na),
        "type": np.zeros(na, np.int64), "mol": np.zeros(na, np.int64),
        "mass_by_type": np.zeros(nt), "pair_eps": np.zeros(nt),
        "pair_sig": np.zeros(nt),
        "bonds": np.zeros((header.get("bonds", 0), 3), np.int64),
        "angles": np.zeros((header.get("angles", 0), 4), np.int64),
        "dihedrals": np.zeros((header.get("dihedrals", 0), 5), np.int64),
        "impropers": np.zeros((header.get("impropers", 0), 5), np.int64),
        "box": box,
    }
    for name, rows in sections.items():
        key = name.split()[0]
        if key == "Masses":
            for r in rows:
                t, m = r.split()[:2]
                out["mass_by_type"][int(t) - 1] = float(m)
        elif name.startswith("Pair Coeffs"):
            for r in rows:
                t, e, s = r.split()[:3]
                out["pair_eps"][int(t) - 1] = float(e)
                out["pair_sig"][int(t) - 1] = float(s)
        elif key == "Atoms":
            full = "charge" not in name
            for r in rows:
                p = r.split()
                if full:
                    aid, mol, t, q = int(p[0]), int(p[1]), int(p[2]), float(p[3])
                    xyz = [float(u) for u in p[4:7]]
                else:
                    aid, t, q = int(p[0]), int(p[1]), float(p[2])
                    mol = 0
                    xyz = [float(u) for u in p[3:6]]
                out["mol"][aid - 1] = mol
                out["type"][aid - 1] = t - 1
                out["q"][aid - 1] = q
                out["x"][aid - 1] = xyz
        elif key == "Velocities":
            for r in rows:
                p = r.split()
                out["v"][int(p[0]) - 1] = [float(u) for u in p[1:4]]
        elif key in ("Bonds", "Angles", "Dihedrals", "Impropers"):
            arr = out[key.lower()]
            w = arr.shape[1]
            for r in rows:
                p = [int(u) for u in r.split()[: w + 1]]
                arr[p[0] - 1] = [u - 1 for u in p[1:]]
    return out


def _read_coeffs(path: str):
    """Bond/Angle/Dihedral/Improper Coeffs sections (Python-side)."""
    coeffs = {"Bond": {}, "Angle": {}, "Dihedral": {}, "Improper": {}}
    cur = None
    for raw in open(path).read().splitlines()[1:]:
        line = raw.split("#")[0].strip()
        if not line:
            continue
        if re.match(r"^[A-Za-z]", line):
            cur = None
            for kind in coeffs:
                if line.startswith(f"{kind} Coeffs"):
                    cur = kind
            continue
        if cur:
            p = line.split()
            coeffs[cur][int(p[0]) - 1] = [float(u) for u in p[1:]]
    return coeffs


# sections this reader understands. A deck section OUTSIDE this set that
# carries physics (PairIJ Coeffs overriding mixed pairs, triclinic tilt,
# a non-charge/full atom style changing the Atoms column layout) must be
# a NAMED error, not a silent mis-parse — the host input world the
# reference fix rides on (fix_constant_pH.cpp:15-25) errors on unknown
# sections too.
_KNOWN_SECTIONS = {
    "Masses", "Pair Coeffs", "Atoms", "Velocities", "Bonds", "Angles",
    "Dihedrals", "Impropers", "Bond Coeffs", "Angle Coeffs",
    "Dihedral Coeffs", "Improper Coeffs",
}
_ATOM_STYLES = {"full", "charge"}


def _scan_deck_guards(path: str) -> None:
    """Reject deck features both parsers would otherwise mis-parse."""
    for raw in open(path).read().splitlines()[1:]:
        line = raw.split("#")[0].strip()
        low = line.lower()
        if "xy xz yz" in low:
            tilt = [float(t) for t in line.split()[:3]]
            if any(abs(t) > 1e-12 for t in tilt):
                raise ValueError(
                    f"triclinic tilt {tilt} unsupported: the tiled cell "
                    f"grid assumes an orthorhombic box — re-shape the "
                    f"cell or use an orthorhombic deck")
            continue
        if line and re.match(r"^[A-Za-z]", line):
            name = " ".join(line.split())
            base = name if name in _KNOWN_SECTIONS else name.split()[0]
            if name in _KNOWN_SECTIONS or base in ("Atoms",):
                if base == "Atoms" or name == "Atoms":
                    style = raw.split("#", 1)
                    if len(style) == 2:
                        st = style[1].strip().split()[0].lower()
                        if st not in _ATOM_STYLES:
                            raise ValueError(
                                f"Atoms section style '{st}' unsupported "
                                f"(column layout differs); supported: "
                                f"{sorted(_ATOM_STYLES)}")
                continue
            # not a section we know — header keyword lines (counts,
            # bounds) never start with a letter, so anything left is an
            # unknown section
            raise ValueError(
                f"unknown data-file section '{name}': this reader "
                f"parses {sorted(_KNOWN_SECTIONS)}; refusing to "
                f"silently skip physics")


def read_lammps_data(path: str) -> dict:
    """The deck's arrays (and its "coeffs"). The reader that ran is
    recorded in ``read_lammps_data.last_reader`` ("native" or
    "python")."""
    _scan_deck_guards(path)
    raw = _read_native(path)
    read_lammps_data.last_reader = "native"
    if raw is None:
        raw = _read_python(path)
        read_lammps_data.last_reader = "python"
    raw["coeffs"] = _read_coeffs(path)
    return raw


read_lammps_data.last_reader = None




def write_lammps_data(path: str, system: System, *, pair_eps=None,
                      pair_sig=None) -> None:
    """Export a System to LAMMPS data format (atom_style full), the same
    bytes the JAX package's writer gives for the same system.

    The deck round-trips through :func:`system_from_lammps_data`:
    per-instance bonded parameters are compressed into types, rigid-water
    triplets are exported as SHAKE-style O-H bonds + an H-O-H angle (the
    reader rebuilds the RigidTriatomic set from the bond topology and
    ``rigid_water_types``), impropers get their own sections, and molecule
    ids tell each water from the solute. Pair ε/σ per type default to the
    diagonal of the mixed tables.
    """
    ff = system.ff
    n = int(ff.mass.shape[0])
    x = _host(system.state.x)
    v = _host(system.state.v)
    q = _host(ff.q0)
    types = _host(ff.type)
    ntypes = int(types.max()) + 1
    box = _host(system.state.box)
    c6 = _host(ff.pair.c6)
    c12 = _host(ff.pair.c12)
    if pair_eps is None:
        with np.errstate(divide="ignore", invalid="ignore"):
            sig6 = np.where(c6.diagonal() > 0,
                            c12.diagonal() / np.maximum(c6.diagonal(), 1e-30),
                            1.0)
            pair_sig = sig6 ** (1.0 / 6.0)
            pair_eps = np.where(c6.diagonal() > 0,
                                c6.diagonal() / (4.0 * sig6), 0.0)

    bp = system.bonded
    mass = _host(ff.mass)
    mass_by_type = np.zeros(ntypes)
    for i in range(n):
        mass_by_type[types[i]] = mass[i]

    # molecule ids: solute = mol 1; each rigid-water triple its own mol
    mol = np.ones(n, dtype=int)
    # mask-0 spring rows are the constraint-derived bonds/angles of a
    # deck-read system; they are re-added from the triplets below, so
    # keeping them would duplicate every O-H bond on re-export
    b_rows = ([tuple(r) + (float(k), float(r0)) for r, k, r0, bm in
               zip(_host(bp.bond_idx), _host(bp.bond_k), _host(bp.bond_r0),
                   _host(bp.bond_mask))
               if bm != 0.0] if bp is not None else [])
    a_rows = ([tuple(r) + (float(k), float(np.rad2deg(t0))) for r, k, t0, am
               in zip(_host(bp.angle_idx), _host(bp.angle_k),
                      _host(bp.angle_t0), _host(bp.angle_mask))
               if am != 0.0] if bp is not None else [])
    cons = system.constraints
    if cons is not None and getattr(cons, "triplets", None) is not None:
        trips = _host(cons.triplets)
        d_oh = float(np.sqrt(cons.d2[0]))
        d_hh = float(np.sqrt(cons.d2[2]))
        th = float(np.rad2deg(2.0 * np.arcsin(0.5 * d_hh / d_oh)))
        for m, (o, h1, h2) in enumerate(trips):
            mol[[o, h1, h2]] = m + 2
            # nominal SPC/E-stiff coeffs: the reader rebuilds the rigid
            # constraint from topology, not from these spring constants
            b_rows.append((int(o), int(h1), 450.0, d_oh))
            b_rows.append((int(o), int(h2), 450.0, d_oh))
            a_rows.append((int(h1), int(o), int(h2), 55.0, th))

    def compress(params):
        seen: dict = {}
        out = []
        for row in params:
            key = tuple(np.round(row, 8))
            if key not in seen:
                seen[key] = len(seen)
            out.append(seen[key])
        return np.array(out, dtype=int), [list(k) for k in seen]

    lines = ["generated by constant_ph_tpu", ""]
    nb = len(b_rows)
    na = len(a_rows)
    nd = int(bp.dihedral_idx.shape[0]) if bp is not None else 0
    ni = int(bp.improper_idx.shape[0]) if bp is not None else 0
    lines.append(f"{n} atoms")
    lines.append(f"{nb} bonds")
    lines.append(f"{na} angles")
    lines.append(f"{nd} dihedrals")
    lines.append(f"{ni} impropers")
    lines.append(f"{ntypes} atom types")

    if nb:
        b_t, b_coeffs = compress([r[2:] for r in b_rows])
        lines.append(f"{len(b_coeffs)} bond types")
    if na:
        a_t, a_coeffs = compress([r[3:] for r in a_rows])
        lines.append(f"{len(a_coeffs)} angle types")
    if nd:
        d_t, d_coeffs = compress(np.stack(
            [_host(bp.dihedral_k), _host(bp.dihedral_n),
             np.rad2deg(_host(bp.dihedral_d))], -1))
        lines.append(f"{len(d_coeffs)} dihedral types")
    if ni:
        i_t, i_coeffs = compress(np.stack(
            [_host(bp.improper_k), np.rad2deg(_host(bp.improper_x0))], -1))
        lines.append(f"{len(i_coeffs)} improper types")
    lines += ["", f"0.0 {box[0]} xlo xhi", f"0.0 {box[1]} ylo yhi",
              f"0.0 {box[2]} zlo zhi", "", "Masses", ""]
    for t in range(ntypes):
        lines.append(f"{t + 1} {mass_by_type[t]}")
    lines += ["", "Pair Coeffs", ""]
    for t in range(ntypes):
        lines.append(f"{t + 1} {pair_eps[t]:.6f} {pair_sig[t]:.6f}")
    if nb:
        lines += ["", "Bond Coeffs", ""]
        for t, (k, r0) in enumerate(b_coeffs):
            lines.append(f"{t + 1} {k} {r0}")
    if na:
        lines += ["", "Angle Coeffs", ""]
        for t, (k, t0) in enumerate(a_coeffs):
            lines.append(f"{t + 1} {k} {t0}")
    if nd:
        lines += ["", "Dihedral Coeffs", ""]
        for t, (k, mult, d) in enumerate(d_coeffs):
            lines.append(f"{t + 1} {k} {int(mult)} {int(round(d))}")
    if ni:
        lines += ["", "Improper Coeffs", ""]
        for t, (k, x0) in enumerate(i_coeffs):
            lines.append(f"{t + 1} {k} {x0}")
    lines += ["", "Atoms # full", ""]
    for i in range(n):
        lines.append(f"{i + 1} {mol[i]} {types[i] + 1} {q[i]:.6f} "
                     f"{x[i, 0]:.8f} {x[i, 1]:.8f} {x[i, 2]:.8f}")
    lines += ["", "Velocities", ""]
    for i in range(n):
        lines.append(f"{i + 1} {v[i, 0]:.8e} {v[i, 1]:.8e} {v[i, 2]:.8e}")
    if nb:
        lines += ["", "Bonds", ""]
        for b, r in enumerate(b_rows):
            lines.append(f"{b + 1} {b_t[b] + 1} {r[0] + 1} {r[1] + 1}")
    if na:
        lines += ["", "Angles", ""]
        for a, r in enumerate(a_rows):
            lines.append(f"{a + 1} {a_t[a] + 1} {r[0] + 1} "
                         f"{r[1] + 1} {r[2] + 1}")
    if nd:
        lines += ["", "Dihedrals", ""]
        di = _host(bp.dihedral_idx)
        for d in range(nd):
            lines.append(f"{d + 1} {d_t[d] + 1} {di[d, 0] + 1} "
                         f"{di[d, 1] + 1} {di[d, 2] + 1} {di[d, 3] + 1}")
    if ni:
        lines += ["", "Impropers", ""]
        ii = _host(bp.improper_idx)
        for d in range(ni):
            lines.append(f"{d + 1} {i_t[d] + 1} {ii[d, 0] + 1} "
                         f"{ii[d, 1] + 1} {ii[d, 2] + 1} {ii[d, 3] + 1}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def write_sites_json(path: str, system: System) -> None:
    """Export the titration metadata (groups, pK, charge end states: what
    the reference fix's command line carries) as a JSON sidecar next to
    the data file; LAMMPS decks carry no λ-site information. Sites are
    written in the ``dq`` form (q_deprot − q_prot per listed atom, buffer
    compensation folded in: the LambdaSpec row), which
    :func:`system_from_lammps_data` accepts alongside the
    q_prot/q_deprot form."""
    spec = system.spec
    if spec is None:
        raise ValueError("system has no titratable sites")
    gh = (_host(system.groupH_mask)
          if system.groupH_mask is not None else None)
    sites = []
    atom_idx = _host(spec.atom_idx)
    dq = _host(spec.dq)
    mask = _host(spec.atom_mask) > 0.5
    pk = _host(spec.pK).reshape(-1)
    dg = _host(spec.dG_ref).reshape(-1)
    m_lam = _host(spec.m_lambda).reshape(-1)
    for s in range(pk.shape[0]):
        m = mask[s]
        d = {
            "atoms": atom_idx[s][m].tolist(),
            "dq": dq[s][m].astype(float).tolist(),
            "pK": float(pk[s]),
            "dG_ref": float(dg[s]),
            "m_lambda": float(m_lam[s]),
        }
        if gh is not None:
            hyd = [int(a) for a in atom_idx[s][m] if gh[a]]
            if len(hyd) == 1:
                d["hydrogen"] = hyd[0]
        sites.append(d)
    with open(path, "w") as fh:
        json.dump({"sites": sites}, fh, indent=1)


def sites_from_json(path: str) -> list:
    """The titratable-site dicts written by :func:`write_sites_json`
    (pass as ``titratable_sites=`` to :func:`system_from_lammps_data`)."""
    with open(path) as fh:
        return json.load(fh)["sites"]


def system_from_lammps_data(
    path: str,
    *,
    cutoff: float = 9.0,
    skin: float = 2.0,
    coul_style: str = "dsf",
    alpha: float = 0.2,
    special_lj=(1.0, 0.0, 0.0, 0.5),
    special_coul=(1.0, 0.0, 0.0, 0.8333),
    rigid_water_types=None,       # (O_type, H_type) 1-based, or None
    titratable_sites=(),          # dicts: atoms, q_prot, q_deprot, pK,
                                  # buffer (atom ids), dG_ref, m_lambda
    pH: float = 7.0,
    dtype=torch.float32,
    max_excl: int = 24,
    device="cuda",
) -> System:
    """A runnable System from a LAMMPS data file. Rigid waters are the
    triplets of ``rigid_water_types`` found in the bond graph; their
    SHAKE-style bonds and angles are masked out of the bonded terms of
    ``System.bonded`` (``ff.bonded`` keeps them unmasked, as the JAX
    builder does)."""
    dev = resolve_device(device)
    raw = read_lammps_data(path)
    n = raw["x"].shape[0]
    box = raw["box"][1::2] - raw["box"][0::2]
    x = raw["x"] - raw["box"][0::2][None, :]

    co = raw["coeffs"]
    nb = raw["bonds"].shape[0]
    na = raw["angles"].shape[0]
    nd = raw["dihedrals"].shape[0]
    ni = raw["impropers"].shape[0]

    def coeff(kind, t, idx, default=0.0):
        row = co[kind].get(int(t), [])
        return row[idx] if idx < len(row) else default

    def f(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                               device=dev)

    def i(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

    def col(kind, rows, idx):
        return [coeff(kind, t, idx) for t in rows[:, 0]]

    bonded = BondedParams(
        bond_idx=i(raw["bonds"][:, 1:3]),
        bond_k=f(col("Bond", raw["bonds"], 0)),
        bond_r0=f(col("Bond", raw["bonds"], 1)),
        bond_mask=f(np.ones(nb)),
        angle_idx=i(raw["angles"][:, 1:4]),
        angle_k=f(col("Angle", raw["angles"], 0)),
        angle_t0=f(np.deg2rad(col("Angle", raw["angles"], 1))),
        angle_mask=f(np.ones(na)),
        dihedral_idx=i(raw["dihedrals"][:, 1:5]),
        dihedral_k=f(col("Dihedral", raw["dihedrals"], 0)),
        dihedral_n=f(col("Dihedral", raw["dihedrals"], 1)),
        dihedral_d=f(np.deg2rad(col("Dihedral", raw["dihedrals"], 2))),
        dihedral_mask=f(np.ones(nd)),
        improper_idx=i(raw["impropers"][:, 1:5]),
        improper_k=f(col("Improper", raw["impropers"], 0)),
        improper_x0=f(np.deg2rad(col("Improper", raw["impropers"], 1))),
        improper_mask=f(np.ones(ni)),
    )

    excl_idx, excl_code = build_exclusions(
        n, raw["bonds"][:, 1:3], max_excl=max_excl)

    mass = raw["mass_by_type"][raw["type"]]
    ff = ForceField(
        mass=f(mass), q0=f(raw["q"]), type=i(raw["type"]),
        pair=make_pair_params(
            raw["pair_eps"], raw["pair_sig"], cutoff,
            coul_style=coul_style, alpha=alpha,
            special_lj=special_lj, special_coul=special_coul, dtype=dtype,
            device=dev),
        bonded=bonded, excl_idx=excl_idx, excl_code=excl_code,
    )

    constraints = None
    if rigid_water_types is not None:
        o_t, h_t = (t - 1 for t in rigid_water_types)
        trips = []
        bmap: dict = {}
        for _, a, b in raw["bonds"]:
            bmap.setdefault(a, []).append(b)
            bmap.setdefault(b, []).append(a)
        for a in range(n):
            if raw["type"][a] == o_t:
                hs = [b for b in bmap.get(a, []) if raw["type"][b] == h_t]
                if len(hs) == 2:
                    trips.append((a, hs[0], hs[1]))
        if trips:
            t0 = trips[0]
            d_oh = float(np.linalg.norm(x[t0[0]] - x[t0[1]]))
            d_hh = float(np.linalg.norm(x[t0[1]] - x[t0[2]]))
            constraints = RigidTriatomic(np.asarray(trips), mass, d_oh, d_hh,
                                         dtype=dtype, device=dev)
            # the constraint solver owns the rigid-water geometry: its
            # SHAKE-style springs leave the bonded forces
            rigid = np.zeros(n, dtype=bool)
            rigid[np.asarray(trips).reshape(-1)] = True
            if nb:
                bi = raw["bonds"][:, 1:3]
                bm = ~(rigid[bi[:, 0]] & rigid[bi[:, 1]])
                bonded = dataclasses.replace(bonded, bond_mask=f(bm))
            if na:
                ai = raw["angles"][:, 1:4]
                am = ~(rigid[ai[:, 0]] & rigid[ai[:, 1]] & rigid[ai[:, 2]])
                bonded = dataclasses.replace(bonded, angle_mask=f(am))

    spec = None
    groupH_mask = None
    if titratable_sites:
        specs = []
        gh = np.zeros(n, dtype=bool)
        for s in titratable_sites:
            if "dq" in s:
                # dq form (write_sites_json): q_deprot − q_prot per atom,
                # buffer compensation folded in
                q_prot = np.zeros(len(s["atoms"]))
                q_deprot = np.asarray(s["dq"], dtype=np.float64)
                buffer_idx = None
            else:
                q_prot, q_deprot = s["q_prot"], s["q_deprot"]
                buffer_idx = s.get("buffer")
            specs.append(make_single_site(
                atom_idx=s["atoms"], q_prot=q_prot, q_deprot=q_deprot,
                pK=s["pK"], buffer_idx=buffer_idx,
                dG_ref=s.get("dG_ref", 0.0),
                m_lambda=s.get("m_lambda", 20.0), dtype=dtype, device=dev))
            if "hydrogen" in s:
                gh[s["hydrogen"]] = True
        spec = stack_sites(specs)
        groupH_mask = torch.as_tensor(gh, device=dev)

    nbr_params = make_neighbor_params(box, cutoff, n_atoms=n, skin=skin)
    state = make_state(
        x, v=raw["v"], box=box,
        lam=np.zeros(len(titratable_sites)) if titratable_sites else None,
        pH=pH, dtype=dtype, device=dev)
    return System(ff=ff, state=state, nbr_params=nbr_params, bonded=bonded,
                  constraints=constraints, spec=spec,
                  groupH_mask=groupH_mask)


def system_from_deck(path: str, *, sites_json: str | None = None,
                     rigid_water_types=None, **kw) -> System:
    """The CLI's deck builder: a LAMMPS data file plus an optional λ-site
    JSON sidecar (written by :func:`write_sites_json`). Registered as the
    ``lammps_data`` builder of the CLI, so a JSON config can point at a
    deck:

        {"system": {"builder": "lammps_data", "path": "hewl.data",
                    "sites_json": "hewl.sites.json",
                    "rigid_water_types": [6, 7], "cutoff": 9.0, ...}}
    """
    sites = sites_from_json(sites_json) if sites_json else ()
    if rigid_water_types is not None:
        rigid_water_types = tuple(int(t) for t in rigid_water_types)
    return system_from_lammps_data(
        path, rigid_water_types=rigid_water_types,
        titratable_sites=sites, **kw)
