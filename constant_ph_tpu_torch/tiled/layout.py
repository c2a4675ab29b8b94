"""Tile layout: molecule-binned cell tiles + canonical⇄tiled conversion
(port of constant_ph_tpu/tiled/layout.py).

- WATER: rigid 3-site solvent, binned by molecule centroid into (G, W)
  molecule slots; atom arrays are (3dims, G, 3W) with each molecule's
  O, H1, H2 in consecutive slots. Empty slots are PARKED far outside the
  box at unique positions, so the hot pair path needs no validity mask.
- SOLUTE: everything else (the acid AND each λ site's buffer water), dense
  (Ns,) with exact pairwise LJ/special tables.

Host-side construction (split_system, to_tiled) runs in float64 numpy and
casts to float32 once, as the JAX package does; rebin runs on the device
between run blocks.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from constant_ph_tpu_torch import resolve_device
from constant_ph_tpu_torch.batching import PerReplica, state_batched
from constant_ph_tpu_torch.lambda_dyn import LambdaSpec
from constant_ph_tpu_torch.ops.constraints import RigidTriatomic
from constant_ph_tpu_torch.state import SystemState

# invalid tile slots are parked at PARK_BASE + PARK_SPACING·flat_slot on all
# three axes: unique positions ≥ √3·10 Å apart and ≥ 10⁴ Å from any real
# atom, so the fast pair path needs no validity masking
PARK_BASE = 1.0e4
PARK_SPACING = 10.0
# the largest tile capacity the CUDA water-water kernels take
# (tiled/cuda_ww.py): they code a candidate as (cell << 8) | molecule in a
# short, so W < 256, and W is a multiple of 4
W_MAX = 252


@dataclasses.dataclass(frozen=True)
class TileParams:
    grid: tuple
    W: int                   # molecules per cell
    half_stencil: tuple      # 13 of the 26 neighbour offsets
    cutoff: float
    skin: float

    @property
    def G(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


@dataclasses.dataclass
class TiledState(PerReplica):
    """Complete dynamic state in tile layout. A batch of R replicas
    (parallel.replica.stack_replicas) gives every tensor field a leading
    R; ``step_host`` stays one host int shared by the batch."""

    _probe = ("wx", 3)

    wx: torch.Tensor       # (3, G, 3W) water atom coords per dim
    wv: torch.Tensor       # (3, G, 3W)
    wvalid: torch.Tensor   # (G, W) 1.0 for real molecules
    wid: torch.Tensor      # (G, W) int32 original water-molecule index
    sx: torch.Tensor       # (Ns, 3) solute coords
    sv: torch.Tensor       # (Ns, 3)
    box: torch.Tensor      # (3,)
    lam: torch.Tensor      # (S,)
    v_lam: torch.Tensor    # (S,)
    pH: torch.Tensor       # ()
    step: torch.Tensor     # () int32
    nhc_xi: torch.Tensor
    nhc_lam_xi: torch.Tensor
    ext_work: torch.Tensor  # () cumulative thermostat energy injection
    # (Ns,) reciprocal-space φ on solute atoms from the last k-space
    # evaluation: the k-space MTS carry, kept across run calls so λ forces
    # between kspace_every boundaries use the stale φ (zeros before the
    # first evaluation and without k-space)
    phi_recip_s: torch.Tensor
    # (S, nbins) metadynamics λ-bias tables, V and dV/dλ on the λ grid
    # (metad.py); (0, 0) when metadynamics is off. Part of the dynamic
    # state because the bias is history-dependent
    metad_v: torch.Tensor
    metad_dv: torch.Tensor
    # host copy of `step`, advanced with it: the MTS boundary test
    # (step % kspace_every == 0) reads it, so choosing whether to run PME
    # never waits for the device
    step_host: int


@dataclasses.dataclass
class SoluteTables:
    """Static solute interaction tables (exact mixing — Ns is small)."""

    q0: torch.Tensor         # (Ns,) base charges (λ=0)
    mass: torch.Tensor       # (Ns,) (padding gets mass 1, zero charge/LJ)
    smask: torch.Tensor      # (Ns,) 1.0 for real solute atoms
    c6: torch.Tensor         # (Ns, Ns) incl. special-LJ scaling, zero diag
    c12: torch.Tensor
    eshift: torch.Tensor
    scoul: torch.Tensor      # (Ns, Ns) Coulomb special factors, zero diag
    c6_cross: torch.Tensor   # (Ns,) vs water O
    c12_cross: torch.Tensor
    eshift_cross: torch.Tensor


class WaterModel:
    """Static 3-site water constants (SPC/E by default)."""

    def __init__(self, qO, qH, c6_OO, c12_OO, eshift_OO, d_OH, d_HH,
                 mO, mH):
        self.q_pattern = (qO, qH, qH)
        self.mass_pattern = (mO, mH, mH)
        self.c6_OO = c6_OO
        self.c12_OO = c12_OO
        self.eshift_OO = eshift_OO
        self.d_OH = d_OH
        self.d_HH = d_HH


def make_tile_params(box, cutoff, *, skin=2.0, mol_radius=1.0,
                     water_density=0.034, safety=1.6) -> TileParams:
    """Host-side sizing. Cell size ≥ cutoff + skin + 2·mol_radius because
    molecules are binned by their centroid."""
    box = np.asarray(box, dtype=np.float64)
    need = cutoff + skin + 2.0 * mol_radius
    grid = tuple(int(max(1, np.floor(b / need))) for b in box)
    if min(grid) < 3:
        # a ±1 roll stencil double-counts (grid 2) or self-pairs (grid 1)
        grid = (1, 1, 1)
        offsets = ()
    else:
        # half stencil: 13 of the 26 neighbour offsets (unique up to sign)
        offsets = tuple(
            (ox, oy, oz)
            for ox in (-1, 0, 1) for oy in (-1, 0, 1) for oz in (-1, 0, 1)
            if (ox, oy, oz) > (-ox, -oy, -oz)
        )
    cell_vol = float(np.prod(box / np.maximum(np.array(grid), 1)))
    W = int(np.ceil(water_density * cell_vol * safety)) + 2
    W = max(4, -(-W // 4) * 4)
    return TileParams(grid=grid, W=W, half_stencil=offsets,
                      cutoff=float(cutoff), skin=float(skin))


class TiledSystem:
    """Host-side bundle: tile params + static tables + index maps back to
    the canonical atom order, with the device the tables live on."""

    def __init__(self, params, water, solute_tables, spec, bonded,
                 groupH_mask, water_atom_ids, solute_ids, n_atoms,
                 solute_constraints=None, coul_style="cut", alpha=0.0,
                 cutoff=9.0, device="cuda"):
        self.params = params
        self.water = water                      # WaterModel
        self.solute = solute_tables             # SoluteTables
        self.spec = spec                        # solute-indexed LambdaSpec
        self.bonded = bonded                    # solute-indexed BondedParams
        self.groupH_mask = groupH_mask          # (Ns,) bool
        self.water_atom_ids = water_atom_ids    # (Mw, 3) canonical atom ids
        self.solute_ids = solute_ids            # (Ns_real,) canonical ids
        self.n_atoms = n_atoms
        self.solute_constraints = solute_constraints
        self.coul_style = coul_style
        self.alpha = alpha
        self.cutoff = cutoff
        self.device = torch.device(device)

    def to(self, device) -> "TiledSystem":
        """A copy with every table on ``device``."""
        dev = torch.device(device)

        def move(obj):
            if obj is None:
                return None
            return dataclasses.replace(obj, **{
                f.name: getattr(obj, f.name).to(dev)
                for f in dataclasses.fields(obj)
                if isinstance(getattr(obj, f.name), torch.Tensor)})

        sc = self.solute_constraints
        return TiledSystem(
            self.params, self.water, move(self.solute), move(self.spec),
            move(self.bonded), self.groupH_mask.to(dev), self.water_atom_ids,
            self.solute_ids, self.n_atoms,
            solute_constraints=None if sc is None else sc.to(dev),
            coul_style=self.coul_style, alpha=self.alpha,
            cutoff=self.cutoff, device=dev)


def _np(t):
    return t.detach().cpu().numpy()


def split_system(system, *, skin=2.0, tile_safety=1.6,
                 device="cuda") -> TiledSystem:
    """Classify atoms of a systems.base.System into water tiles + solute.

    Water = rigid triatomics from system.constraints, EXCEPT molecules
    containing λ-site atoms (buffer waters), which become solute."""
    dev = resolve_device(device)
    ff = system.ff
    n = int(ff.mass.shape[0])
    trip = (_np(system.constraints.triplets)
            if system.constraints is not None else np.zeros((0, 3), np.int64))

    site_atoms = set()
    if system.spec is not None:
        site_atoms = set(_np(system.spec.atom_idx).reshape(-1).tolist())

    water_rows = []
    solute_ids = set(range(n))
    buffer_trips = []
    for t in trip:
        if site_atoms & set(t.tolist()):
            buffer_trips.append(t)
            continue  # buffer water → solute
        water_rows.append(t)
        solute_ids -= set(t.tolist())
    water_atom_ids = np.array(water_rows, dtype=np.int64).reshape(-1, 3)
    solute_ids = np.array(sorted(solute_ids), dtype=np.int64)
    ns_real = len(solute_ids)
    Ns = max(8, -(-ns_real // 8) * 8)

    # canonical → solute-local index map
    sol_local = -np.ones(n, dtype=np.int64)
    sol_local[solute_ids] = np.arange(ns_real)

    pp = ff.pair
    types = _np(ff.type)
    c6_t = _np(pp.c6)
    c12_t = _np(pp.c12)
    esh_t = _np(pp.e_shift)
    # identify the water O type from the first water triplet
    if len(water_rows) or len(buffer_trips):
        o_type = int(types[(water_rows or buffer_trips)[0][0]])
    else:
        o_type = 0

    st = types[solute_ids]
    c6 = c6_t[st[:, None], st[None, :]]
    c12 = c12_t[st[:, None], st[None, :]]
    esh = esh_t[st[:, None], st[None, :]]
    scoul = np.ones((ns_real, ns_real))
    slj = np.ones((ns_real, ns_real))
    sp_lj = _np(pp.special_lj)
    sp_c = _np(pp.special_coul)
    ei = np.asarray(ff.excl_idx)
    ec = np.asarray(ff.excl_code)
    for li, ci in enumerate(solute_ids):
        for s in range(ei.shape[1]):
            j = ei[ci, s]
            if j < 0:
                continue
            lj_ = sol_local[j]
            if lj_ < 0:
                continue
            code = ec[ci, s]
            slj[li, lj_] = sp_lj[code]
            scoul[li, lj_] = sp_c[code]
    np.fill_diagonal(scoul, 0.0)
    np.fill_diagonal(slj, 0.0)

    def pad2(a, fill=0.0):
        out = np.full((Ns, Ns), fill, dtype=np.float64)
        out[:ns_real, :ns_real] = a
        return out

    def pad1(a, fill=0.0):
        out = np.full((Ns,), fill, dtype=np.float64)
        out[:ns_real] = a
        return out

    dtype = ff.q0.dtype
    mass_np = _np(ff.mass)
    qs = _np(ff.q0)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    tables = SoluteTables(
        q0=t(pad1(qs[solute_ids])),
        mass=t(pad1(mass_np[solute_ids], 1.0)),
        smask=t(pad1(np.ones(ns_real))),
        c6=t(pad2(c6 * slj)),
        c12=t(pad2(c12 * slj)),
        eshift=t(pad2(esh * slj)),
        scoul=t(pad2(scoul)),
        c6_cross=t(pad1(c6_t[st, o_type])),
        c12_cross=t(pad1(c12_t[st, o_type])),
        eshift_cross=t(pad1(esh_t[st, o_type])),
    )

    # water model constants from the force field; rigid distances come
    # from the System's constraint object
    ow = water_atom_ids[0][0] if len(water_rows) else buffer_trips[0][0]
    hw = water_atom_ids[0][1] if len(water_rows) else buffer_trips[0][1]
    cons = system.constraints
    d_OH = float(np.sqrt(cons.d2[0])) if cons is not None else 1.0
    d_HH = float(np.sqrt(cons.d2[2])) if cons is not None else 1.633
    water = WaterModel(
        qO=float(qs[ow]), qH=float(qs[hw]),
        c6_OO=float(c6_t[o_type, o_type]),
        c12_OO=float(c12_t[o_type, o_type]),
        eshift_OO=float(esh_t[o_type, o_type]),
        d_OH=d_OH, d_HH=d_HH,
        mO=float(mass_np[ow]), mH=float(mass_np[hw]),
    )

    # remap λ spec + bonded + groupH to solute-local indices
    spec = system.spec
    if spec is not None:
        new_idx = sol_local[_np(spec.atom_idx)]
        if not (new_idx >= 0).all():
            raise ValueError("λ-site atom not in the solute set")
        spec = LambdaSpec(**{
            f.name: getattr(spec, f.name).to(dev)
            for f in dataclasses.fields(LambdaSpec)})
        spec.atom_idx = torch.as_tensor(new_idx, device=dev)
    bonded = system.bonded
    if bonded is not None and int(bonded.bond_idx.shape[0]):
        bonded = _remap_bonded(bonded, sol_local, dev)
    gh = np.zeros(Ns, dtype=bool)
    if system.groupH_mask is not None:
        gh[:ns_real] = _np(system.groupH_mask)[solute_ids]

    # buffer waters stay rigid: small solute-indexed constraint set
    solute_constraints = None
    if buffer_trips:
        bt = sol_local[np.array(buffer_trips)]
        solute_constraints = RigidTriatomic(
            bt, _np(tables.mass), d_OH, d_HH, dtype=dtype, device=dev)

    box = _np(system.state.box)
    # centroid binning: max atom-to-centroid distance for a rigid
    # triatomic is |2·h1 − h2|/3 ≈ 0.84·d_OH (plus slack)
    params = make_tile_params(box, pp.cutoff, skin=skin,
                              mol_radius=0.87 * d_OH + 0.05,
                              safety=tile_safety)
    return TiledSystem(
        params=params, water=water, solute_tables=tables, spec=spec,
        bonded=bonded, groupH_mask=torch.as_tensor(gh, device=dev),
        water_atom_ids=water_atom_ids, solute_ids=solute_ids, n_atoms=n,
        solute_constraints=solute_constraints,
        coul_style=pp.coul_style, alpha=pp.alpha, cutoff=pp.cutoff,
        device=dev,
    )


def _remap_bonded(bonded, sol_local, dev):
    """Solute-local bonded terms; mask-0 rows are dropped first (rigid
    water springs, whose atoms are by construction not solute)."""
    out = {}
    for fam, fields in (("bond", ("k", "r0")), ("angle", ("k", "t0")),
                        ("dihedral", ("k", "n", "d")),
                        ("improper", ("k", "x0"))):
        idx = _np(getattr(bonded, f"{fam}_idx"))
        mask = _np(getattr(bonded, f"{fam}_mask"))
        keep = mask > 0.5
        m = sol_local[idx[keep]]
        if not (m >= 0).all():
            raise ValueError(f"{fam} atom not in the solute set (flexible "
                             "water is unsupported on the tiled path)")
        out[f"{fam}_idx"] = torch.as_tensor(m.reshape(-1, idx.shape[1]),
                                            device=dev)
        for name in ("mask",) + fields:
            out[f"{fam}_{name}"] = torch.as_tensor(
                _np(getattr(bonded, f"{fam}_{name}"))[keep], device=dev)
    return type(bonded)(**out)


def to_tiled(ts: TiledSystem, state: SystemState) -> TiledState:
    """Canonical SystemState → TiledState on ts.device (host-side; run
    boundaries only)."""
    p = ts.params
    G, W = p.G, p.W
    dev = ts.device
    x = _np(state.x).astype(np.float64)
    v = _np(state.v)
    box = _np(state.box).astype(np.float64)
    dtype = state.x.dtype

    grid = np.array(p.grid)
    cell = box / grid
    # bin by molecule CENTROID; unwrap satellites into the O image first in
    # case input molecules straddle the box seam
    xm_all = x[ts.water_atom_ids]                         # (Mw, 3atoms, 3)
    rel = xm_all - xm_all[:, :1, :]
    rel -= box[None, None, :] * np.round(rel / box[None, None, :])
    cen = xm_all[:, 0, :] + rel.mean(axis=1)
    # the wrap runs in float32, as the JAX package's device-side wrap does
    cen32 = cen.astype(np.float32)
    box32 = box.astype(np.float32)
    o_pos = cen32 - box32 * np.floor(cen32 / box32)
    ci = np.clip((o_pos.astype(np.float64) // cell).astype(np.int64), 0,
                 grid - 1)
    cid = (ci[:, 0] * grid[1] + ci[:, 1]) * grid[2] + ci[:, 2]
    # slot = rank of the molecule within its cell in stable cid order
    order = np.argsort(cid, kind="stable")
    cid_s = cid[order]
    slot = np.empty_like(cid)
    slot[order] = (np.arange(len(cid_s))
                   - np.searchsorted(cid_s, cid_s, side="left"))
    if len(slot) and slot.max() >= W:
        raise ValueError("tile capacity W exceeded at build")

    # invalid slots are PARKED at unique far positions; real molecules
    # are stored box-wrapped (by centroid image) so rolled tiles need only
    # per-cell boundary shifts, not per-pair min-image
    park = PARK_BASE + PARK_SPACING * np.arange(G * W, dtype=np.float64)
    wx = np.broadcast_to(np.repeat(park.reshape(G, W), 3, axis=1),
                         (3, G, 3 * W)).copy()
    wv = np.zeros((3, G, 3 * W))
    wvalid = np.zeros((G, W))
    wid = np.full((G, W), -1, dtype=np.int32)
    img = box[None, :] * np.floor(cen / box[None, :])      # (Mw, 3)
    for a in range(3):
        ids = ts.water_atom_ids[:, a]
        wx[:, cid, 3 * slot + a] = (x[ids] - img).T
        wv[:, cid, 3 * slot + a] = v[ids].T
    wvalid[cid, slot] = 1.0
    wid[cid, slot] = np.arange(len(cid))

    ns_real = len(ts.solute_ids)
    Ns = ts.solute.q0.shape[0]
    sx = np.zeros((Ns, 3))
    sv = np.zeros((Ns, 3))
    sx[:ns_real] = x[ts.solute_ids]
    sv[:ns_real] = v[ts.solute_ids]
    # park padded solute atoms far outside the box (masked anyway)
    sx[ns_real:] = box * 2.0 + np.arange(Ns - ns_real)[:, None]

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    return TiledState(
        wx=t(wx), wv=t(wv), wvalid=t(wvalid),
        wid=torch.as_tensor(wid, device=dev), sx=t(sx), sv=t(sv),
        box=state.box.to(dev), lam=state.lam.to(dev),
        v_lam=state.v_lam.to(dev), pH=state.pH.to(dev),
        step=state.step.to(dev), nhc_xi=state.nhc_xi.to(dev),
        nhc_lam_xi=state.nhc_lam_xi.to(dev),
        ext_work=state.ext_work.to(dev),
        phi_recip_s=torch.zeros((Ns,), dtype=dtype, device=dev),
        metad_v=torch.zeros((0, 0), dtype=dtype, device=dev),
        metad_dv=torch.zeros((0, 0), dtype=dtype, device=dev),
        step_host=int(state.step),
    )


def to_canonical(ts: TiledSystem, tstate: TiledState) -> SystemState:
    """TiledState → canonical SystemState (host-side; run boundaries
    only)."""
    n = ts.n_atoms
    x = np.zeros((n, 3))
    v = np.zeros((n, 3))
    c, s = np.nonzero(_np(tstate.wvalid) > 0.5)
    m = _np(tstate.wid)[c, s]
    wx = _np(tstate.wx)
    wv = _np(tstate.wv)
    for a in range(3):
        ids = ts.water_atom_ids[m, a]
        x[ids] = wx[:, c, 3 * s + a].T
        v[ids] = wv[:, c, 3 * s + a].T
    ns_real = len(ts.solute_ids)
    x[ts.solute_ids] = _np(tstate.sx)[:ns_real]
    v[ts.solute_ids] = _np(tstate.sv)[:ns_real]
    dev = tstate.sx.device
    dtype = tstate.sx.dtype
    return SystemState(
        x=torch.as_tensor(x, dtype=dtype, device=dev),
        v=torch.as_tensor(v, dtype=dtype, device=dev),
        box=tstate.box, lam=tstate.lam, v_lam=tstate.v_lam,
        step=tstate.step, pH=tstate.pH, nhc_xi=tstate.nhc_xi,
        nhc_lam_xi=tstate.nhc_lam_xi, ext_work=tstate.ext_work,
        step_host=tstate.step_host,
    )


def retile(ts: TiledSystem, tstate: TiledState, W: int):
    """Re-tile with a new per-cell capacity W (host-side; run boundaries
    only). Measure occupancy after equilibration (max over cells of
    tstate.wvalid.sum(-1)) and retile with W = max_occ + margin. Returns
    (new TiledSystem, new TiledState)."""
    W = max(4, -(-int(W) // 4) * 4)
    state = to_canonical(ts, tstate)
    ts2 = copy.copy(ts)
    ts2.params = dataclasses.replace(ts.params, W=W)
    # the k-space MTS carry (per solute atom) and the metadynamics tables
    # are independent of the tiles
    return ts2, dataclasses.replace(
        to_tiled(ts2, state), phi_recip_s=tstate.phi_recip_s,
        metad_v=tstate.metad_v, metad_dv=tstate.metad_dv,
        step_host=tstate.step_host)


def retile_auto(ts: TiledSystem, tstate: TiledState, occ: int, *,
                margin_min: int = 6):
    """Retile to the occupancy ``occ`` plus ``margin_min`` free slots,
    rounded up to a multiple of 4. The JAX package's retile_auto picks W
    in [occ + margin_min, occ + margin_max] by a model of the TPU's
    128-lane padding (_pair_cost); the port's kernels pad nothing, so the
    port takes the smallest W. Raises when occ + margin_min exceeds
    W_MAX, the kernels' limit."""
    if occ + margin_min > W_MAX:
        raise ValueError(f"occupancy {occ} + margin {margin_min} exceeds "
                         f"W_MAX = {W_MAX}, the largest tile capacity the "
                         "CUDA water-water kernels take; split the system "
                         "into more cells")
    return retile(ts, tstate, -(-(occ + margin_min) // 4) * 4)


# ---------------------------------------------------------------------------
# device-side re-binning (runs between run blocks)
# ---------------------------------------------------------------------------

@state_batched
def rebin(tstate: TiledState, p: TileParams):
    """Re-bin water molecules by current centroid. Molecule-level row
    moves only; returns (new_tstate, overflow_flag) with the flag a 0-d
    bool tensor on the device (no host sync).

    A batch (every tensor field with a leading replica axis R) is rebinned
    in one pass and gets an (R,) flag: one stable argsort over all R·G·W
    molecule keys, replica r's offset by r·(G + 1), so its parked rows
    (key G) sort after its cells and before replica r + 1. Each replica's
    result is bitwise its own rebin's: the same rows, keys and order."""
    G, W = p.G, p.W
    GW = G * W
    dtype = tstate.wx.dtype
    dev = tstate.wx.device
    gx, gy, gz = p.grid
    R = tstate.wx.shape[0]
    # each row's box: replica r's box on its G·W rows
    box = tstate.box.repeat_interleave(GW, dim=0)        # (R*G*W, 3)

    # pack per-molecule rows: x(9) + v(9) = (R*G*W, 18); wid/valid separate
    xm = tstate.wx.reshape(R, 3, G, W, 3).permute(0, 2, 3, 1, 4).reshape(
        R * GW, 9)
    vm = tstate.wv.reshape(R, 3, G, W, 3).permute(0, 2, 3, 1, 4).reshape(
        R * GW, 9)
    valid = tstate.wvalid.reshape(R * GW)
    wid = tstate.wid.reshape(R * GW)

    # row layout is (dim, atom)-flattened: [xO xH1 xH2 yO yH1 yH2 zO ...];
    # bin by centroid with the satellites unwrapped into the O image
    o_only = xm[:, ::3]                                 # (R*G*W, 3) O
    mol = xm.reshape(-1, 3, 3)                          # (R*G*W, dim, atom)
    rel = mol - o_only[:, :, None]
    rel = rel - box[:, :, None] * torch.round(rel / box[:, :, None])
    o_pos = o_only + torch.mean(rel, dim=2)             # centroid
    img = box * torch.floor(o_pos / box)
    ow = o_pos - img
    # wrap the whole molecule into the box by its centroid image
    rows = torch.cat([xm - torch.repeat_interleave(img, 3, dim=1), vm],
                     dim=1)                             # (R*G*W, 18)
    # per-row box lengths, not host tensors: a host copy would synchronise
    ci = [torch.clamp((ow[:, d] / (box[:, d] / g)).to(torch.int32), 0, g - 1)
          for d, g in enumerate(p.grid)]
    cid = (ci[0] * gy + ci[1]) * gz + ci[2]
    key = torch.where(valid > 0.5, cid, torch.full_like(cid, G))
    rep = torch.arange(R, dtype=key.dtype, device=dev).repeat_interleave(GW)
    order = torch.argsort(key + rep * (G + 1), stable=True)
    key_s = key[order]                   # each replica's G·W rows in turn
    kb_s = key_s + rep * (G + 1)
    first = torch.searchsorted(kb_s, kb_s, side="left")
    rank = torch.arange(R * GW, dtype=torch.int32, device=dev) - first.to(
        torch.int32)
    # flag one slot EARLY (rank == W-1 fills the last slot): the state is
    # still complete when the flag first trips, so callers can retile
    # before any molecule is dropped
    overflow = torch.any(((rank >= W - 1) & (key_s < G)).reshape(R, GW),
                         dim=1)
    slot = torch.clamp(rank, 0, W - 1)
    # rows bound for no cell land on each replica's extra row G*W, which
    # is dropped
    dest = (rep * (GW + 1) + torch.where(
        key_s < G, key_s * W + slot, torch.full_like(key_s, GW))).long()

    park = (PARK_BASE
            + PARK_SPACING * torch.arange(GW + 1, dtype=dtype, device=dev))
    new_rows = torch.cat([park[:, None].expand(GW + 1, 9),
                          torch.zeros((GW + 1, 9), dtype=dtype,
                                      device=dev)], dim=1).repeat(R, 1)
    new_rows[dest] = rows[order]
    new_valid = torch.zeros(R * (GW + 1), dtype=valid.dtype, device=dev)
    new_valid[dest] = torch.ones_like(valid)
    new_wid = torch.full((R * (GW + 1),), -1, dtype=wid.dtype, device=dev)
    new_wid[dest] = wid[order]

    new_rows = new_rows.reshape(R, GW + 1, 18)[:, :GW]
    xm2 = new_rows[..., :9].reshape(R, G, W, 3, 3).permute(0, 3, 1, 2, 4)
    vm2 = new_rows[..., 9:].reshape(R, G, W, 3, 3).permute(0, 3, 1, 2, 4)
    new = dataclasses.replace(
        tstate, wx=xm2.reshape(R, 3, G, 3 * W),
        wv=vm2.reshape(R, 3, G, 3 * W),
        wvalid=new_valid.reshape(R, GW + 1)[:, :GW].reshape(R, G, W),
        wid=new_wid.reshape(R, GW + 1)[:, :GW].reshape(R, G, W))
    return new, overflow
