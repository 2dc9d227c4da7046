"""Slab domain decomposition of the cell pipeline over ``torch.distributed``.

Port of ``cavmd_tpu/parallel/domain.py``. The x axis of the cell grid is
cut into ``S`` slabs, one per rank. Particles reside on the rank that owns
their slab; every per-particle operation of a step (thermostats,
velocity-Verlet, the cell tile pass, the PPPM spread) runs on that rank's
resident rows, and a step communicates only through
``parallel/comm.py``:

- one halo exchange: each rank sends the positions of its first and last
  own x-layer of cell buckets to its x-neighbours (2 x H rows of 3);
- scalar sums: the group kinetic energies of the thermostats (Bussi and
  Berendsen before the first kick, MTTK after the second), the adaptive
  dt's ``sum |F|/m`` and the Langevin tally;
- one sum of the force stage, in one flat buffer: the PPPM partial charge
  grid (each rank spreads its residents; the small mesh solve is then
  repeated on every rank), the energy partials, the cavity dipole and
  photon coordinate, the coverage flag and rho(k).

Residency is rebuilt every ``rebuild_every`` steps by a global rebuild
that every rank computes alike (stable sorts and running-maximum ranks, so
the tables agree bit for bit): atoms bin to slabs by their true cell; a
molecule whose atoms share a slab is intact (one ``apm``-row slot, bonds
and exclusions by static offsets), one that straddles a slab boundary
decays to singles whose bond partners resolve through the rank's local-id
table (resident or halo). Between rebuilds the bucket structure is frozen
and only positions move; a per-step coverage invariant (every binned atom
within ``(width - r_cut)/2`` of its cell box) guards the frozen structure
and reports through the ``cell_overflow`` channel, where
``Simulation.run`` re-plans and retries the chunk.

The global ``MDState`` is replicated on every rank between chunks: a chunk
starts with each rank taking its slab's rows (scatter-in) and ends with an
all-gather of every rank's rows (scatter-out).

A replica batch over slabs: the state may be a batch of B replicas
(``parallel/replicas.py``), and then every table and every tensor of the
step carries a leading replica axis. The rebuild runs once for the batch
(each replica's sort keys offset by its (replica, slab) groups), each
replica's slab holds its own atoms, and the tile pass (K7's counterpart)
and the PPPM kernels run once a step for the batch on each replica's own
tables (types, charges, exclusions, pair keys; a charge row a replica).
The collectives carry the batch: one halo exchange of (B, 2H, 3) rows, one
sum of the force stage, one sum of the (B,) kinetic energies where one
replica sums one. A one-replica state runs as a batch of one. Over R x S
ranks (``make_domain_runner(n_replicas=R)``) rank (r, s) runs slab s of
the r-th slice of the batch.

Differences from the JAX module:

- the tile pass is the cell kernel of ``ops/cell_kernels.py`` launched
  over the own cells of the slab-extended grid (``cell_pair_force_slab``,
  the counterpart of K7, ``fused_cell_cols_slab_pallas``); its plain twin
  is the tile path of ``ops/neighbor.py``, which is what the JAX step runs
  off the TPU. The TPU layout options (``prewrap``, ``s1``, ``jsplit``,
  the Pallas pack rows) are not taken;
- the pair pass compares particles by a pair key, the resident id of a
  halo copy's particle when that particle is resident on the same rank
  (only at S = 1, where the halo layers are copies of the rank's own edge
  layers). At S = 1 the JAX module compares raw local ids, so a bonded
  pair that straddles the periodic x boundary inside one intact molecule
  meets through the halo copy unexcluded (an LJ + Ewald term at bond
  length); see ``ROADMAP.md`` Queue 3.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cavmd_tpu_torch.core.box import minimum_image, rewrap, unwrap_positions
from cavmd_tpu_torch.core.units import PhysicalConstants
from cavmd_tpu_torch.integrate.integrator import (
    ObsBuffer,
    StreamNoise,
    _set_at,
    group_slot,
)
from cavmd_tpu_torch.integrate.thermostats import (
    MTTKState,
    berendsen_factor,
    bussi_rescale_factor,
    kinetic_energy,
    mttk_advance,
    mttk_rescale_factor,
)
from cavmd_tpu_torch.ops.cell_kernels import (
    cell_pair_force_slab,
)
from cavmd_tpu_torch.ops.ewald import _excl_pair_terms, ewald_self_energy
from cavmd_tpu_torch.ops.neighbor import (
    CellList,
    CellListConfig,
    _rank_and_bucket,
    replica_list,
)
from cavmd_tpu_torch.ops.pppm import mesh_energy
from cavmd_tpu_torch.ops.pppm_kernels import interpolate_grad, spread_grid
from cavmd_tpu_torch.parallel.comm import Communicator, grid_communicators
from cavmd_tpu_torch.parallel.replicas import PER_REPLICA, replica_rows


class DomainPlan(NamedTuple):
    """Static geometry of the slab decomposition (host side); the fields
    of the JAX ``DomainPlan``."""

    S: int  # slabs (ranks)
    ncells: tuple  # global cell grid (cx, cy, cz), cx = S * cxl
    cxl: int  # own x-layers per slab
    widths: tuple  # cell widths (wx, wy, wz)
    r_cut: float
    cap: int  # bucket capacity
    nb_cap: int  # intact-molecule slots per slab (apm rows each)
    ns_cap: int  # straddler-single atom slots per slab
    Mrow: int  # resident rows per slab = apm*nb_cap + ns_cap + tail
    tail: int
    apm: int  # atoms per molecule
    nbm: int  # bonds per molecule
    B: int  # most bonds of one atom (the pair-exclusion width)
    bond_offs: tuple  # nbm x (o0, o1) in-molecule bond endpoints
    n_mol: int
    n_atoms: int  # bonded-molecule rows = apm * n_mol
    n0: int  # particle rows (molecules + photon)
    photon_row: int  # the photon's row, -1 if none
    mol_bonds: object = None  # (n_mol, nbm) bond id per molecule slot
    abond_partner: object = None  # (n_atoms, B) partner row (n0 = none)
    abond_bond: object = None  # (n_atoms, B) bond id (n_bonds = none)
    excl_offs: object = None  # (apm, B) in-molecule partner offset, -1 none

    @property
    def C_own(self):
        return self.cxl * self.ncells[1] * self.ncells[2]

    @property
    def C_ext(self):
        return (self.cxl + 2) * self.ncells[1] * self.ncells[2]

    @property
    def H(self):  # halo rows per side: one x-layer of buckets
        return self.ncells[1] * self.ncells[2] * self.cap

    @property
    def Mtot(self):  # local table rows: residents + both halos
        return self.Mrow + 2 * self.H

    def grow_cap(self):
        """The plan for an overflow retry: twice the bucket capacity (at
        least +4) and half again the molecule and single slots."""
        nb = max(1, min(self.nb_cap + self.nb_cap // 2 + 4, self.n_mol))
        ns = max(1, min(2 * self.ns_cap + 8, self.n_atoms))
        return self._replace(
            cap=max(self.cap + 4, self.cap * 2),
            nb_cap=nb, ns_cap=ns,
            Mrow=self.apm * nb + ns + self.tail,
        )


def _host(t):
    return t.detach().cpu().numpy()


def uniform_rcut(ff):
    """The LJ cutoff shared by every type pair with eps != 0, or None when
    they differ (the fused cell kernel's precondition in the JAX
    package)."""
    eps, rc2 = _host(ff.lj_eps), _host(ff.lj_rcut2).astype(np.float64)
    vals = np.unique(rc2[eps != 0])
    return float(np.sqrt(vals[0])) if len(vals) == 1 else None


def _analyze_topology(snapshot):
    """``(apm, nbm, bond_offs, n_mol, mol_bonds, abond_partner,
    abond_bond, B, excl_offs)`` for consecutive homogeneous molecules: the
    bond graph's components must tile the first ``apm * n_mol`` rows in
    equal consecutive blocks with one bond pattern. Raises ValueError
    otherwise."""
    bg = _host(snapshot.bond_group).reshape(-1, 2).astype(np.int64)
    nb = bg.shape[0]
    if nb == 0:
        raise ValueError("domain decomposition needs bonded molecules")
    hi = int(bg.max()) + 1
    parent = np.arange(hi)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for a, b in bg:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    root = np.array([find(a) for a in range(hi)])
    roots, counts = np.unique(root, return_counts=True)
    apm = int(counts[0])
    if not np.all(counts == apm):
        raise ValueError("domain decomposition needs homogeneous "
                         "molecules (equal atoms per molecule)")
    n_mol = len(roots)
    n_atoms = apm * n_mol
    if hi != n_atoms or not np.array_equal(
            root, np.repeat(np.arange(0, n_atoms, apm), apm)):
        raise ValueError("domain decomposition needs molecule-major "
                         "consecutive atom blocks")
    mol_of_bond = bg[:, 0] // apm
    offs = np.sort(bg - (mol_of_bond * apm)[:, None], axis=1)
    order = np.lexsort((offs[:, 1], offs[:, 0], mol_of_bond))
    offs_s = offs[order]
    nbm = nb // n_mol
    if nbm * n_mol != nb:
        raise ValueError("domain decomposition needs homogeneous "
                         "molecules (equal bonds per molecule)")
    pat = offs_s[:nbm]
    if not np.array_equal(
            np.broadcast_to(pat, (n_mol, nbm, 2)).reshape(nb, 2), offs_s):
        raise ValueError("domain decomposition needs identical bond "
                         "topology across molecules")
    mol_bonds = np.asarray(order.reshape(n_mol, nbm), np.int32)
    bond_offs = tuple((int(a), int(b)) for a, b in pat)
    B = max(int(np.bincount(pat.ravel()).max()), 1)
    abond_partner = np.full((n_atoms, B), snapshot.N, np.int32)
    abond_bond = np.full((n_atoms, B), nb, np.int32)
    fill = np.zeros(n_atoms, np.int64)
    for bid, (a, b) in enumerate(bg):
        for x, y in ((a, b), (b, a)):
            abond_partner[x, fill[x]] = y
            abond_bond[x, fill[x]] = bid
            fill[x] += 1
    excl_offs = np.where(abond_partner[:apm] < apm,
                         abond_partner[:apm], -1).astype(np.int32)
    return (apm, nbm, bond_offs, n_mol, mol_bonds, abond_partner,
            abond_bond, B, excl_offs)


def plan_domain(snapshot, ff, S: int, *, skin: float = 0.5,
                cap: int | None = None, nb_margin: float = 1.1) -> DomainPlan:
    """Plan ``S`` slabs for a snapshot and a cell-mode ForceField, as the
    JAX ``plan_domain`` does (same keywords and defaults, same fields, same
    rejections): the cell width is ``r_cut + skin`` on every axis, at
    least 3 cells per axis and at least one x-layer per slab; the drift
    margin the step's coverage invariant allows is the realized
    ``(width - r_cut) / 2`` after the integer cell snap. ``cap`` overrides
    the planned bucket capacity; ``nb_margin`` scales the intact-molecule
    slots a slab holds (mean * nb_margin + 6 sigma). Raises ValueError for
    what the slab path does not take, custom forces among them."""
    if ff.pair_mode != "cell":
        raise ValueError("domain decomposition needs pair_mode='cell'")
    if uniform_rcut(ff) is None or not (ff.enable_lj and ff.enable_coulomb):
        raise ValueError("domain decomposition needs the uniform-cutoff "
                         "fused LJ+Ewald cell kernel")
    if ff.custom_forces:
        raise ValueError("custom forces not supported in the domain path")
    (apm, nbm, bond_offs, n_mol, mol_bonds, abond_partner, abond_bond,
     B, excl_offs) = _analyze_topology(snapshot)
    n_atoms = apm * n_mol
    box_L = _host(snapshot.box_L).astype(float)
    r_cut = float(ff.coulomb_rcut)
    w = r_cut + skin
    cy = int(box_L[1] // w)
    cz = int(box_L[2] // w)
    cxl = int(box_L[0] // w) // S
    cx = S * cxl
    if cxl < 1 or min(cx, cy, cz) < 3:
        raise ValueError(
            f"box too small for {S} slabs at width {w:.1f}: "
            f"grid ({cx},{cy},{cz}) needs >=3 cells per axis")
    # a straddling molecule may span at most two adjacent slabs
    r_bond1 = float(np.max(_host(ff.bond_r0))) * 1.25 + 0.5
    r_mol = (apm - 1) * r_bond1
    if r_mol >= cxl * (box_L[0] / cx):
        raise ValueError(
            f"molecule extent {r_mol:.1f} exceeds the slab width — "
            f"box too small for {S} slabs")

    typeid = _host(snapshot.typeid)
    n0 = snapshot.N
    l_typeid = ff.l_typeid
    # every row past the molecules must be pair-inert: the photon, or the
    # ghosts of pad_snapshot_to, which hold no slot and keep their state
    tail_rows = typeid[n_atoms:]
    if not np.all((tail_rows == l_typeid) | (tail_rows == ff.ghost_typeid)):
        raise ValueError("non-bonded rows past the molecules must be "
                         "pair-inert (photon/ghost) for the domain path")
    photon_rows = np.where(typeid == l_typeid)[0]
    if len(photon_rows) > 1:
        raise ValueError("domain path supports at most one photon")
    photon_row = int(photon_rows[0]) if len(photon_rows) else -1

    # slots: mean * margin for slab imbalance, 6 sigma for fluctuations,
    # never more than all molecules; an overflow is flagged at rebuild
    # and recovered by grow_cap + retry
    mean_mol = n_mol / S
    nb_cap = int(np.ceil(mean_mol * nb_margin + 6.0 * np.sqrt(mean_mol) + 8))
    nb_cap = max(1, min(nb_cap, n_mol))
    mean_strad = apm * n_mol * max(r_mol, 1.0) / box_L[0]
    ns_cap = int(np.ceil(mean_strad * 1.5 + 6.0 * np.sqrt(mean_strad) + 16))
    ns_cap = max(1, min(ns_cap, n_atoms))
    # tail slots: fillers; the photon is pinned at the last row of the
    # last slab (pair-inert, so its slab does not matter)
    tail = 8
    Mrow = apm * nb_cap + ns_cap + tail
    if cap is None:
        vol_cell = float(np.prod(box_L)) / (cx * cy * cz)
        rho = n_atoms / float(np.prod(box_L))
        cap = int(np.ceil(rho * vol_cell * 1.8)) + 8
    return DomainPlan(
        S=S, ncells=(cx, cy, cz), cxl=cxl,
        widths=tuple(float(b / c) for b, c in zip(box_L, (cx, cy, cz))),
        r_cut=r_cut, cap=cap, nb_cap=nb_cap, ns_cap=ns_cap, Mrow=Mrow,
        tail=tail, apm=apm, nbm=nbm, B=B, bond_offs=bond_offs,
        n_mol=n_mol, n_atoms=n_atoms, n0=n0, photon_row=photon_row,
        mol_bonds=mol_bonds, abond_partner=abond_partner,
        abond_bond=abond_bond, excl_offs=excl_offs,
    )


def _ext_neighbor_table(plan: DomainPlan) -> np.ndarray:
    """(C_ext, 27) neighbour table over the extended local grid: own cells
    (x-layers 1..cxl) get their 27-neighbourhood with no x wrap (the halo
    layers stand in for the periodic images); halo cells get sentinel
    rows (C_ext), so they are only ever j cells."""
    cxl, (_, cy, cz) = plan.cxl, plan.ncells
    C_ext = plan.C_ext
    out = np.full((C_ext, 27), C_ext, np.int32)
    ids = np.arange(C_ext)
    x, y, z = ids // (cy * cz), (ids // cz) % cy, ids % cz
    own = (x >= 1) & (x <= cxl)
    k = 0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nb = ((x + dx) * cy + (y + dy) % cy) * cz + (z + dz) % cz
                out[:, k] = np.where(own, nb, C_ext)
                k += 1
    return out


class DomainData(NamedTuple):
    """The layout of one chunk (rebuilt every ``rebuild_every`` steps),
    every slab's tables, with the JAX ``DomainData`` fields plus
    ``pair_key``. Integer tables are int32. ``_rebuild`` gives each field
    (but the two flags) a leading replica axis B; ``_rebuild_one`` is one
    replica's, the shapes below."""

    perm: torch.Tensor  # (S*Mrow,) particle row per slot (n0 = filler)
    inv_slot: torch.Tensor  # (n0,) slot of each particle row
    buckets: torch.Tensor  # (S, C_ext, cap) local ids (Mtot = empty)
    slot_of: torch.Tensor  # (S, Mrow) flat ext slot (C_ext*cap = none)
    centers: torch.Tensor  # (S*Mrow, 3) assigned cell centres
    binned: torch.Tensor  # (S*Mrow,) row takes part in the tiles
    valid: torch.Tensor  # (S*Mrow,) row holds a particle
    bond_k: torch.Tensor  # (S, nb_cap, nbm) intact-slot bond parameters
    bond_r0: torch.Tensor  # (S, nb_cap, nbm)
    sing_partner: torch.Tensor  # (S, ns_cap, B) local partner ids
    sing_k: torch.Tensor  # (S, ns_cap, B)
    sing_r0: torch.Tensor  # (S, ns_cap, B)
    sing_qq: torch.Tensor  # (S, ns_cap, B) q_self * q_partner
    excl: torch.Tensor  # (S*Mrow, B) local pair-exclusion ids (Mtot none)
    send_first: torch.Tensor  # (S, H) local ids of the first own layer
    send_last: torch.Tensor  # (S, H) local ids of the last own layer
    halo_src: torch.Tensor  # (S, 2, H) particle rows of [left, right] halos
    pair_key: torch.Tensor  # (S, Mtot) id the pair pass compares by
    slab_overflow: torch.Tensor  # 0-d bool: a slab outgrew nb/ns_cap
    bucket_overflow: torch.Tensor  # 0-d bool: a bucket outgrew cap


def _rank_in_group(key):
    """Stable sort by ``key`` and the rank within each key group (a
    running maximum over group starts). Returns (order, sorted_key, rank,
    is_last)."""
    n = key.shape[0]
    order = torch.argsort(key, stable=True)
    sorted_k = key[order]
    iota = torch.arange(n, device=key.device)
    change = sorted_k[1:] != sorted_k[:-1]
    true1 = torch.ones(1, dtype=torch.bool, device=key.device)
    is_start = torch.cat([true1, change])
    first = torch.cummax(torch.where(is_start, iota, 0), dim=0).values
    return order, sorted_k, iota - first, torch.cat([change, true1])


def _place(order, sorted_k, rank, is_last, n_groups, cap, fill):
    """(n_groups * cap,) slots: group g's members at g * cap + rank. A
    rank past cap - 1 is clamped there, where the group's last member
    lands (the JAX scatter's last writer); groups >= n_groups are
    dropped."""
    dump = n_groups * cap
    flat = sorted_k * cap + torch.clamp_max(rank, cap - 1)
    target = torch.where((sorted_k < n_groups)
                         & ((rank < cap - 1) | is_last), flat, dump)
    out = torch.full((dump + 1,), fill, dtype=torch.int64,
                     device=order.device)
    return out.scatter_(0, target, order)[:dump]


def plan_tables(plan: DomainPlan, device) -> dict:
    """The plan's topology tables on ``device`` (int64): the bond ids of
    each molecule, each atom's bond partners and bond ids, the in-molecule
    exclusion offsets. Made once a runner, so that a rebuild copies
    nothing from the host."""
    return {k: torch.as_tensor(getattr(plan, k), device=device).long()
            for k in ("mol_bonds", "abond_partner", "abond_bond",
                      "excl_offs")}


def _rebuild(position, plan: DomainPlan, box_L, bond_k_per, bond_r0_per,
             pair_inert, charge, tables=None) -> DomainData:
    """The layout of every slab of each replica of ``position`` (B, N, 3),
    in one pass on the positions' device with no read-back: each replica's
    tables are the JAX ``_rebuild_one``'s of its positions. The B
    replicas' S slabs are B S groups g = b S + s: the sort keys of a
    replica's molecules, singles and bins are offset by its groups (as
    ``ops/neighbor.py:build_cell_list`` offsets a batch's bins), so every
    sort and running maximum runs once over the batch, and a stable sort
    keeps each replica's order within a group. A capacity overflow in any
    replica sets the batch's flag. Fields gain the leading B. ``tables``:
    ``plan_tables`` on the positions' device (None: made here)."""
    nrep = position.shape[0]
    S, (cx, cy, cz) = plan.S, plan.ncells
    cxl, cap, nb_cap, Mrow = plan.cxl, plan.cap, plan.nb_cap, plan.Mrow
    ns_cap, apm, nbm, B = plan.ns_cap, plan.apm, plan.nbm, plan.B
    n0, n_mol, n_atoms = plan.n0, plan.n_mol, plan.n_atoms
    C_ext, H, Mtot = plan.C_ext, plan.H, plan.Mtot
    G = nrep * S  # (replica, slab) groups
    nb_tot = n_mol * nbm
    dev, dtype = position.device, position.dtype
    box = box_L.to(dtype)
    i64 = dict(dtype=torch.int64, device=dev)
    tables = tables if tables is not None else plan_tables(plan, dev)

    def i32(t):
        return t.to(torch.int32)

    def ring(x, shift):
        """``x`` (G, ...) rolled by ``shift`` over each replica's slabs."""
        return torch.roll(x.reshape((nrep, S) + x.shape[1:]), shift,
                          dims=1).reshape(x.shape)

    # ---- per-atom global cells (true cells) ----
    frac = position / box + 0.5
    cell3 = torch.stack([
        torch.clamp(torch.floor(frac[..., d] * float(nc)).to(torch.int64),
                    0, nc - 1)
        for d, nc in enumerate((cx, cy, cz))], dim=-1)
    slab_at = cell3[:, :n_atoms, 0] // cxl
    g0 = torch.arange(0, G, S, **i64)[:, None]  # each replica's first group

    # ---- intact molecules take an apm-row slot; the atoms of a
    # straddling molecule become singles ----
    mslab = slab_at.reshape(nrep, n_mol, apm)
    mol_slab = mslab[..., 0]
    intact = torch.all(mslab == mol_slab[..., None], dim=-1)
    key_m = torch.where(intact, g0 + mol_slab, G).reshape(-1)
    order_m, sorted_m, rank_m, last_m = _rank_in_group(key_m)
    over_m = torch.any((rank_m >= nb_cap) & (sorted_m < G))
    mol_perm = _place(order_m % n_mol, sorted_m, rank_m, last_m, G, nb_cap,
                      n_mol)

    single = torch.repeat_interleave(~intact, apm, dim=-1)
    key_a = torch.where(single, g0 + slab_at, G).reshape(-1)
    order_a, sorted_a, rank_a, last_a = _rank_in_group(key_a)
    over_s = torch.any((rank_a >= ns_cap) & (sorted_a < G))
    sing_perm = _place(order_a % n_atoms, sorted_a, rank_a, last_a, G,
                       ns_cap, n0)
    slab_overflow = over_m | over_s

    # ---- slot -> particle row (the replica's row) ----
    d = torch.arange(G * Mrow, **i64)
    g_of = d // Mrow
    s_of = g_of % S
    b_of = g_of // S
    r_of = d % Mrow
    in_mol = r_of < apm * nb_cap
    mslot = g_of * nb_cap + torch.clamp_max(r_of, apm * nb_cap - 1) // apm
    mp = mol_perm[mslot]
    matom = torch.where(mp < n_mol, apm * mp + r_of % apm, n0)
    in_sing = (~in_mol) & (r_of < apm * nb_cap + ns_cap)
    satom = sing_perm[g_of * ns_cap
                      + torch.clamp(r_of - apm * nb_cap, 0, ns_cap - 1)]
    perm = torch.where(in_mol, matom, torch.where(in_sing, satom, n0))
    if plan.photon_row >= 0:  # the last slot of each replica's last slab
        perm = torch.where(d % (S * Mrow) == S * Mrow - 1, plan.photon_row,
                           perm)
    # inverse map, a replica's slots; filler slots write the dump entry n0
    inv_slot = torch.zeros(nrep * (n0 + 1), **i64).scatter_(
        0, b_of * (n0 + 1) + perm, d % (S * Mrow)).view(nrep, n0 + 1)[:, :n0]

    # ---- buckets over each slab's extended grid ----
    cell3_d = cell3[b_of, torch.clamp_max(perm, n0 - 1)]
    x_cl = torch.minimum(torch.maximum(cell3_d[:, 0], s_of * cxl),
                         (s_of + 1) * cxl - 1)
    ex = x_cl - s_of * cxl + 1  # own layers at ext x 1..cxl
    c_ext = (ex * cy + cell3_d[:, 1]) * cz + cell3_d[:, 2]
    inert = torch.cat([pair_inert, torch.ones(1, dtype=torch.bool,
                                              device=dev)])[
        torch.clamp_max(perm, n0)]
    binned = (perm < n0) & ~inert
    bin_id = torch.where(binned, g_of * C_ext + c_ext, G * C_ext)
    sort_order = torch.argsort(bin_id, stable=True)
    bucket_d, bucket_overflow, slot_of_d = _rank_and_bucket(
        sort_order, bin_id[sort_order], G * Mrow, G * C_ext + 1, cap,
        n_real_bins=G * C_ext)
    bucket_d = bucket_d[:-1].long()  # drop the dump bin
    bshard = (torch.arange(G * C_ext, **i64) // C_ext)[:, None]
    blocal = torch.where(bucket_d < G * Mrow, bucket_d - bshard * Mrow, Mtot)
    buckets = blocal.reshape(G, C_ext, cap)
    slot_of_d = slot_of_d.long()
    slot_of = torch.where(slot_of_d < G * C_ext * cap,
                          slot_of_d - g_of * C_ext * cap,
                          C_ext * cap).reshape(G, Mrow)

    # ---- halo wiring: the left halo is the left neighbour's last own
    # layer, the right halo the right neighbour's first; a halo slot holds
    # its table id where the sender's slot is occupied, Mtot where not ----
    layer = cy * cz
    own = buckets[:, layer:(cxl + 1) * layer]
    send_first = own[:, :layer].reshape(G, H).clone()
    send_last = own[:, -layer:].reshape(G, H).clone()
    hid = torch.arange(H, **i64).reshape(layer, cap)
    left_ids = torch.where(ring(own[:, -layer:] < Mtot, 1), Mrow + hid, Mtot)
    right_ids = torch.where(ring(own[:, :layer] < Mtot, -1),
                            Mrow + H + hid, Mtot)
    buckets = buckets.clone()
    buckets[:, :layer] = left_ids
    buckets[:, -layer:] = right_ids

    # ---- the halo rows' particles ----
    own_dom = bucket_d.reshape(G, C_ext, cap)[:, layer:(cxl + 1) * layer]

    def orig(slots):
        return torch.where(slots < G * Mrow,
                           perm[torch.clamp_max(slots, G * Mrow - 1)], n0)

    left_src = ring(orig(own_dom[:, -layer:]), 1).reshape(G, H)
    right_src = ring(orig(own_dom[:, :layer]), -1).reshape(G, H)
    halo_src = torch.stack([left_src, right_src], dim=1)

    # ---- assigned cell centres (the per-step coverage invariant) ----
    ncells_f = torch.stack([position.new_full((), c) for c in (cx, cy, cz)])
    g3 = torch.stack([x_cl, cell3_d[:, 1], cell3_d[:, 2]], dim=-1).to(dtype)
    centers = ((g3 + 0.5) / ncells_f - 0.5) * box

    # ---- particle row -> local id on a slab: residents by slot
    # arithmetic, halo copies through a (G, n0 + 2) table whose column
    # n0 + 1 takes the writes of empty halo slots ----
    h2l = torch.full((G, n0 + 2), Mtot, **i64)
    g_idx = torch.arange(G, **i64)[:, None, None].expand(G, 2, H)
    hsrc_w = torch.where(halo_src < n0, halo_src, n0 + 1)
    h2l[g_idx, hsrc_w] = (Mrow + torch.arange(2 * H, **i64)).reshape(
        1, 2, H).expand(G, 2, H)

    def resolve_local(g, row):
        loc_res = inv_slot[g // S, torch.clamp_max(row, n0 - 1)] \
            - (g % S) * Mrow
        is_res = (loc_res >= 0) & (loc_res < Mrow)
        out = torch.where(is_res, loc_res,
                          h2l[g, torch.where(row < n0, row, n0 + 1)])
        return torch.where(row < n0, out, Mtot)

    # ---- intact-slot bond parameters ----
    mvalid = mol_perm < n_mol
    mb = tables["mol_bonds"][torch.clamp_max(mol_perm, n_mol - 1)]
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    bond_k = torch.where(mvalid[:, None], bond_k_per[mb],
                         zero).reshape(nrep, S, nb_cap, nbm)
    bond_r0 = torch.where(mvalid[:, None], bond_r0_per[mb],
                          one).reshape(nrep, S, nb_cap, nbm)

    # ---- straddler singles: partners resident or in the halo ----
    ab_p, ab_b = tables["abond_partner"], tables["abond_bond"]
    sa = torch.clamp_max(sing_perm, n_atoms - 1)
    pgl = torch.where((sing_perm < n0)[:, None], ab_p[sa], n0)
    bid = torch.clamp_max(ab_b[sa], nb_tot)
    g_of_s = torch.arange(G * ns_cap, **i64)[:, None] // ns_cap
    sing_partner = resolve_local(g_of_s, pgl)
    k_ext = torch.cat([bond_k_per, zero[None]])
    r0_ext = torch.cat([bond_r0_per, one[None]])
    sing_k = torch.where(pgl < n0, k_ext[bid], zero)
    sing_r0 = r0_ext[bid]
    q_ext = torch.cat([charge, zero[None]])
    sing_qq = (q_ext[torch.clamp_max(sing_perm, n0)][:, None]
               * q_ext[torch.clamp_max(pgl, n0)])

    # ---- pair exclusions of every resident row: intact slots by slot
    # arithmetic (own slot base + the in-molecule offset), singles their
    # bond partners, tail rows none ----
    r_mol = torch.arange(apm * nb_cap, **i64)
    base = (r_mol - r_mol % apm)[:, None]
    off_r = tables["excl_offs"][r_mol % apm]
    mol_ok = ((perm.reshape(G, Mrow)[:, :apm * nb_cap, None] < n0)
              & (off_r >= 0)[None])
    excl_mol = torch.where(mol_ok, (base + off_r)[None], Mtot)
    excl = torch.cat([
        excl_mol,
        sing_partner.reshape(G, ns_cap, B),
        torch.full((G, Mrow - apm * nb_cap - ns_cap, B), Mtot, **i64),
    ], dim=1)

    # ---- pair keys: a halo copy of a particle resident on the same slab
    # (S = 1) compares as that resident ----
    g_col = torch.arange(G, **i64)[:, None]
    hflat = halo_src.reshape(G, 2 * H)
    h_res = inv_slot[g_col // S, torch.clamp_max(hflat, n0 - 1)] \
        - (g_col % S) * Mrow
    own_ids = (Mrow + torch.arange(2 * H, **i64))[None].expand(G, 2 * H)
    h_key = torch.where((hflat < n0) & (h_res >= 0) & (h_res < Mrow),
                        h_res, own_ids)
    pair_key = torch.cat([torch.arange(Mrow, **i64)[None].expand(G, Mrow),
                          h_key], dim=1)

    def per_rep(t):  # (G * ..., ...) -> (B, S, ...)
        return t.reshape((nrep, S) + t.shape[1:])

    def per_rep_rows(t):  # (G * Mrow, ...) -> (B, S * Mrow, ...)
        return t.reshape((nrep, S * Mrow) + t.shape[1:])

    return DomainData(
        perm=i32(perm).view(nrep, S * Mrow), inv_slot=i32(inv_slot),
        buckets=i32(per_rep(buckets)), slot_of=i32(per_rep(slot_of)),
        centers=per_rep_rows(centers), binned=per_rep_rows(binned),
        valid=per_rep_rows(perm < n0), bond_k=bond_k, bond_r0=bond_r0,
        sing_partner=i32(sing_partner.reshape(nrep, S, ns_cap, B)),
        sing_k=sing_k.reshape(nrep, S, ns_cap, B),
        sing_r0=sing_r0.reshape(nrep, S, ns_cap, B),
        sing_qq=sing_qq.reshape(nrep, S, ns_cap, B),
        excl=i32(excl).reshape(nrep, S * Mrow, B),
        send_first=i32(per_rep(send_first)),
        send_last=i32(per_rep(send_last)), halo_src=i32(per_rep(halo_src)),
        pair_key=i32(per_rep(pair_key)), slab_overflow=slab_overflow,
        bucket_overflow=bucket_overflow,
    )


def _rebuild_one(position, plan: DomainPlan, box_L, bond_k_per, bond_r0_per,
                 pair_inert, charge) -> DomainData:
    """The layout of every slab from one replica's global positions
    (N, 3): the same tables as the JAX ``_rebuild_one``."""
    data = _rebuild(position[None], plan, box_L, bond_k_per, bond_r0_per,
                    pair_inert, charge)
    return data._replace(**{k: getattr(data, k)[0]
                            for k in DomainData._fields
                            if not k.endswith("overflow")})


class LocalState(NamedTuple):
    """A slab's resident rows (Mrow each) of each of the rank's b
    replicas."""

    position: torch.Tensor  # (b, Mrow, 3)
    image: torch.Tensor  # (b, Mrow, 3) int32
    velocity: torch.Tensor  # (b, Mrow, 3)
    forces: torch.Tensor  # (b, Mrow, 3) cached F(t)
    mass: torch.Tensor  # (b, Mrow)
    charge: torch.Tensor  # (b, Mrow)
    typeid: torch.Tensor  # (b, Mrow) int32


class ShardData(NamedTuple):
    """A slab's tables for a chunk, for each of the rank's b replicas."""

    buckets: torch.Tensor  # (b, C_ext, cap) local ids
    slot: torch.Tensor  # (b, Mtot) flat ext slot per local id
    centers: torch.Tensor  # (b, Mrow, 3)
    binned: torch.Tensor  # (b, Mrow)
    valid: torch.Tensor  # (b, Mrow)
    bond_k: torch.Tensor  # (b, nb_cap, nbm)
    bond_r0: torch.Tensor  # (b, nb_cap, nbm)
    sing_partner: torch.Tensor  # (b, ns_cap, B) local ids
    sing_k: torch.Tensor  # (b, ns_cap, B)
    sing_r0: torch.Tensor  # (b, ns_cap, B)
    sing_qq: torch.Tensor  # (b, ns_cap, B)
    excl: torch.Tensor  # (b, Mtot + 1, B) local pair-exclusion ids
    send_first: torch.Tensor  # (b, H)
    send_last: torch.Tensor  # (b, H)
    typeid: torch.Tensor  # (b, Mtot) residents + halo copies
    charge: torch.Tensor  # (b, Mtot)
    pair_key: torch.Tensor  # (b, Mtot)


def slab_grid(plan: DomainPlan, device):
    """(config, neighbour table, own-cell range) of a slab's extended
    grid: the cell list the tile pass runs on, skin 0 (the layout is
    rebuilt by the runner), and the (first, count) cells that own
    particles, x-layers 1..cxl."""
    cfg = CellListConfig(ncells=(plan.cxl + 2, plan.ncells[1],
                                 plan.ncells[2]),
                         cap=plan.cap, r_cut=plan.r_cut, skin=0.0)
    ext_nb = torch.as_tensor(_ext_neighbor_table(plan), device=device)
    return cfg, ext_nb, (plan.ncells[1] * plan.ncells[2], plan.C_own)


def _rows(x, ids):
    """Rows ``ids`` (b, k) of each replica's ``x`` (b, M, 3)."""
    return torch.gather(x, 1, ids.long()[..., None].expand(-1, -1, 3))


def _position_table(pos, dat: ShardData, comm: Communicator):
    """(b, Mtot, 3): the residents, then the left and right halo rows from
    the x-neighbours (one exchange of 2 x (b, H, 3) rows for the rank's
    replicas)."""
    Mrow = pos.shape[1]
    left, right = comm.halo(
        _rows(pos, torch.clamp_max(dat.send_last, Mrow - 1)),
        _rows(pos, torch.clamp_max(dat.send_first, Mrow - 1)))
    return torch.cat([pos, left, right], dim=1)


def _tile_args(pos_tab, box_L, dat: ShardData, cfg, ext_nb, ff):
    clist = CellList(bucket_idx=dat.buckets,
                     overflow=torch.zeros(dat.buckets.shape[:1],
                                          dtype=torch.bool,
                                          device=pos_tab.device),
                     neighbor_cells=ext_nb, slot_of=dat.slot)
    return (pos_tab, box_L, clist, cfg, dat.typeid, dat.charge, ff.lj_eps,
            ff.lj_sig2, ff.lj_rcut2, ff.lj_vshift, dat.excl, ff.kappa_value)


def _as_batch(state):
    """A one-replica state as a batch of one (the slab step's form)."""
    return state.replace(**{k: getattr(state, k)[None] for k in PER_REPLICA},
                         cell_list=None, cell_anchor=None)


def tile_pass_inputs(ff, plan: DomainPlan, state):
    """The inputs of the tile pass (``cell_pair_force_slab``) of slab 0
    at ``state``'s positions, as a chunk's first step lays them
    out, with the halo rows read from the global state (what the exchange
    delivers at a chunk's start): ``(args, cells, pair_key)`` with
    ``args`` the twelve leading arguments of ``cell_pair_force_slab`` and
    of ``cell_pair_force_fused_plain``. A batched state gives the batch
    over slabs' call (every replica's slab 0 and its own tables), a
    one-replica state the one-replica call. For holding the kernel against
    its twin and timing it; needs no process group."""
    batch = state if state.batch_shape else _as_batch(state)
    data = _rebuild(batch.position, plan, batch.box_L, ff.bond_k_per,
                    ff.bond_r0_per, ff.pair_inert, batch.charge)
    loc, dat = _scatter_in(batch, data, plan, 0)
    cfg, ext_nb, own_cells = slab_grid(plan, state.position.device)
    halo = data.halo_src[:, 0].reshape(data.halo_src.shape[0], -1)
    glob = torch.cat([batch.position,
                      batch.position.new_zeros(batch.position.shape[:1]
                                               + (1, 3))], dim=1)
    pos_tab = torch.cat([loc.position, _rows(glob, halo)], dim=1)
    args = _tile_args(pos_tab, state.box_L, dat, cfg, ext_nb, ff)
    if state.batch_shape:
        return args, own_cells, dat.pair_key
    one = (args[0][0], args[1], replica_list(args[2], 0), args[3],
           args[4][0], args[5][0]) + args[6:10] + (args[10][0], args[11])
    return one, own_cells, dat.pair_key[0]


def _validate_methods(methods):
    """The methods the slab step runs, those of the JAX slab path: Bussi,
    MTTK, Berendsen and NVE baths and a single-photon cavity Langevin bath
    (anything else raises ValueError)."""
    for m in methods:
        ok = m.kind in ("bussi", "mttk", "berendsen", "nve") or (
            m.kind == "langevin" and m.group == "cavity"
            and m.indices is not None and len(m.indices) == 1)
        if not ok:
            raise ValueError(
                f"domain decomposition does not support method "
                f"kind={m.kind!r} group={m.group!r} (supported: bussi/mttk/"
                "berendsen/nve baths + single-photon cavity langevin)")


def make_domain_step(ff, methods, plan: DomainPlan, comm: Communicator, *,
                     adaptive=None, obs_spec=None, noise=None):
    """Build one slab's step ``step(loc, rep, dat) -> (loc, rep, obs)``
    for the rank's b replicas.

    The physics of ``integrator.make_step_fn`` on the resident rows of
    each replica, with the cross-slab sums of ``comm``: every tensor has a
    leading replica axis b, each kernel runs once a step for the b
    replicas (the tile pass and K2/K3 on each replica's own tables), and
    each collective carries all b replicas (one halo exchange, one sum of
    the force stage, one sum of the (b,) kinetic energies where the
    one-replica step sums one). ``rep`` is the replicated batched
    ``MDState`` of the chunk: its per-replica scalars (dt, time, counters,
    reservoirs, tolerance) advance every step and its generators draw the
    noise; its per-particle fields are not read. ``noise`` is the draw
    source of ``make_step_fn`` (default ``StreamNoise``): the same
    streams, in the same order and shapes as ``run_replica_steps`` of the
    batch, so every rank draws the same numbers.

    ``adaptive``: dict(error_tolerance, initial_fraction, time_constant_ps,
    period) runs the adaptive-dt controller at the step start (one sum of
    the (b,) ``sum |F|/m``), each replica from its own clock and forces,
    on the batch's shared step counter. ``obs_spec``: ``(dipole,
    wavevectors or None)``, the structured form of
    ``observe.make_extra_obs``, folded into the force-stage sum.
    """
    _validate_methods(methods)
    noise = noise if noise is not None else StreamNoise()
    Mrow, Mtot = plan.Mrow, plan.Mtot
    nb_cap, ns_cap, apm = plan.nb_cap, plan.ns_cap, plan.apm
    nmr = apm * nb_cap
    l_typeid = ff.l_typeid
    dev = ff.lj_eps.device
    cfg, ext_nb, own_cells = slab_grid(plan, dev)
    mesh = tuple(ff.pppm_mesh)
    order = ff.pppm_order
    kappa = ff.kappa_value
    has_photon = plan.photon_row >= 0 and ff.enable_cavity
    want_dipole = bool(obs_spec and obs_spec[0])
    wv_np = obs_spec[1] if obs_spec is not None else None
    to_ps = PhysicalConstants.TIME_PS_CONVERSION
    if adaptive is not None:
        adp_target = float(adaptive["error_tolerance"])
        adp_initial = adp_target * float(adaptive.get("initial_fraction",
                                                      1e-3))
        adp_inv_tau = 1.0 / float(adaptive.get("time_constant_ps", 50.0))
        adp_period = int(adaptive.get("period", 1))
    consts = {}

    def const(dtype):
        """Per-dtype device constants, made once."""
        if dtype not in consts:
            c = dict(
                lim=torch.tensor(plan.widths, dtype=dtype, device=dev)
                - 0.5 * plan.r_cut,
                xy=torch.tensor([1.0, 1.0, 0.0], dtype=dtype, device=dev))
            if wv_np is not None:
                c["wv"] = torch.as_tensor(np.asarray(wv_np), dtype=dtype,
                                          device=dev)
            consts[dtype] = c
        return consts[dtype]

    def per_row(x):  # a (b,) per-replica value over (b, M, 3)
        return x[:, None, None]

    def step(loc: LocalState, rep, dat: ShardData):
        dtype = loc.position.dtype
        nrep = loc.position.shape[0]
        c = const(dtype)
        box = rep.box_L
        dt = rep.dt
        err_tol = rep.error_tolerance
        if adaptive is not None and rep.step % adp_period == 0:
            fnorm = torch.sqrt(torch.sum(loc.forces * loc.forces, dim=-1))
            s_f = comm.sum(torch.sum(fnorm / loc.mass, dim=-1))
            t_ps = rep.time_au * to_ps
            tol = adp_target - (adp_target - adp_initial) * torch.exp(
                -t_ps * adp_inv_tau)
            dt = torch.sqrt(tol / torch.clamp_min(
                s_f, torch.finfo(dtype).tiny)).to(dtype)
            err_tol = tol.to(dtype)
            rep = rep.replace(dt=dt, error_tolerance=err_tol)
        v = loc.velocity
        cav_mask = dat.valid & (loc.typeid == l_typeid)
        mol_mask = dat.valid & (loc.typeid != l_typeid)
        masks = {"molecular": mol_mask, "cavity": cav_mask,
                 "all": dat.valid}
        bussi_res = rep.bussi_reservoir
        bussi_inst = rep.bussi_instantaneous
        lang_res = rep.langevin_reservoir
        xi, eta = rep.mttk_xi, rep.mttk_eta

        # ---- thermostat half 1 (group KE: local partials + one sum) ----
        for i, m in enumerate(methods):
            mask = masks[m.group][..., None]
            slot = group_slot(m.group)
            if m.kind == "mttk":
                alpha = mttk_rescale_factor(
                    MTTKState(xi[:, slot], eta[:, slot]), dt)
                v = torch.where(mask, per_row(alpha) * v, v)
            elif m.kind == "berendsen":
                K = comm.sum(kinetic_energy(v, loc.mass, mask[..., 0]))
                lam = berendsen_factor(2.0 * K / m.dof, m.kT, dt, m.tau)
                v = torch.where(mask, per_row(lam) * v, v)
            elif m.kind == "bussi":
                r1, r_gamma = noise.bussi(rep, i, m)
                K = comm.sum(kinetic_energy(v, loc.mass, mask[..., 0]))
                alpha = bussi_rescale_factor(K, m.dof, dt, m.tau, m.kT, r1,
                                             r_gamma)
                v = torch.where(mask, per_row(alpha) * v, v)
                dres = K * (1.0 - alpha * alpha)
                bussi_res = _set_at(bussi_res, slot, dres, add=True)
                bussi_inst = _set_at(bussi_inst, slot, dres, add=False)

        # ---- velocity Verlet ----
        inv_m = 1.0 / loc.mass[..., None]
        v = v + 0.5 * per_row(dt) * loc.forces * inv_m
        pos, img = rewrap(loc.position + per_row(dt) * v, loc.image, box)

        # ---- coverage invariant: every binned atom within (w - r_cut)/2
        # of its assigned cell box ----
        dctr = minimum_image(pos - dat.centers, box)
        bad = torch.any((torch.abs(dctr) > c["lim"])
                        & dat.binned[..., None], dim=(-2, -1))

        # ---- halo exchange, then the pair tile pass over the own cells
        # of every replica's extended grid (one launch) ----
        pos_tab = _position_table(pos, dat, comm)
        f_tab, e_lj, e_ew = cell_pair_force_slab(*_tile_args(
            pos_tab, box, dat, cfg, ext_nb, ff), own_cells, dat.pair_key)
        forces = f_tab[:, :Mrow]

        # ---- bonds + Ewald exclusion corrections of intact slots
        # (static in-slot offsets; filler slots carry k = q = 0) ----
        pmol = pos[:, :nmr].reshape(nrep, nb_cap, apm, 3)
        qmol = loc.charge[:, :nmr].reshape(nrep, nb_cap, apm)
        f_mol = torch.zeros_like(pmol)
        fc_mol = torch.zeros_like(pmol)
        e_bond = pos.new_zeros(nrep)
        e_corr = pos.new_zeros(nrep)
        for b, (o0, o1) in enumerate(plan.bond_offs):
            drb = minimum_image(pmol[:, :, o1] - pmol[:, :, o0], box)
            r = torch.sqrt(torch.sum(drb * drb, dim=-1))
            kb, rb = dat.bond_k[..., b], dat.bond_r0[..., b]
            safe_r = torch.where(r > 0, r, torch.ones_like(r))
            fj = (-kb * (r - rb) / safe_r)[..., None] * drb
            f_mol[:, :, o1] += fj
            f_mol[:, :, o0] -= fj
            e_bond = e_bond + torch.sum(0.5 * kb * (r - rb) ** 2, dim=-1)
            fi, ec = _excl_pair_terms(-drb, qmol[:, :, o0] * qmol[:, :, o1],
                                      kappa)
            fc_mol[:, :, o0] += fi
            fc_mol[:, :, o1] -= fi
            e_corr = e_corr + ec

        # straddler singles: each endpoint computes its own bond from the
        # position table (both endpoints do, so energies carry 1/2)
        psing = pos[:, nmr:nmr + ns_cap]
        pid = dat.sing_partner.long()
        nB = pid.shape[-1]
        alive = pid < Mtot
        ppart = _rows(pos_tab, torch.clamp_max(pid, Mtot - 1).reshape(
            nrep, ns_cap * nB)).reshape(nrep, ns_cap, nB, 3)
        drs = minimum_image(ppart - psing[:, :, None, :], box)
        rs = torch.sqrt(torch.sum(drs * drs, dim=-1))
        ks = torch.where(alive, dat.sing_k, 0.0)
        safe_rs = torch.where(rs > 0, rs, torch.ones_like(rs))
        fjs = (-ks * (rs - dat.sing_r0) / safe_rs)[..., None] * drs
        f_sing = -torch.sum(fjs, dim=-2)
        e_bond = e_bond + 0.5 * torch.sum(
            0.5 * ks * (rs - dat.sing_r0) ** 2, dim=(-2, -1))
        qqs = torch.where(alive, dat.sing_qq, 0.0)
        fis, ecs = _excl_pair_terms((-drs).reshape(nrep, ns_cap * nB, 3),
                                    qqs.reshape(nrep, -1), kappa)
        fc_sing = torch.sum(fis.reshape(nrep, ns_cap, nB, 3), dim=-2)
        e_corr = e_corr + 0.5 * ecs

        tail_z = pos.new_zeros((nrep, Mrow - nmr - ns_cap, 3))
        forces = forces + torch.cat([f_mol.reshape(nrep, nmr, 3), f_sing,
                                     tail_z], dim=1)
        f_corr = torch.cat([fc_mol.reshape(nrep, nmr, 3), fc_sing, tail_z],
                           dim=1)
        e_self = ewald_self_energy(loc.charge, kappa)

        # ---- PPPM partial grids (K2 on every replica's resident rows,
        # each with its own charges, in one launch) ----
        grid_loc = spread_grid(pos, loc.charge, box, order, mesh)

        # ---- cavity partial sums (the photon is not in the dipole) ----
        unw = unwrap_positions(pos, img, box)
        wq = torch.where(cav_mask, 0.0, loc.charge)
        dip = torch.sum(wq[..., None] * unw, dim=-2)
        qph = torch.sum(torch.where(cav_mask[..., None], unw, 0.0), dim=-2)

        # rho(k) over valid rows, wrapped positions (fillers sit at the
        # origin, where cos = 1, and are masked out)
        parts = [grid_loc, e_lj.to(dtype), e_ew.to(dtype), e_bond, e_corr,
                 e_self, dip, qph, bad.to(dtype)]
        if wv_np is not None:
            kr = pos @ c["wv"].T
            wvalid = dat.valid.to(dtype)[:, None, :]
            parts += [(wvalid @ torch.cos(kr))[:, 0],
                      (wvalid @ torch.sin(kr))[:, 0]]

        # ---- one sum of the force stage ----
        (grid_tot, e_lj, e_ew, e_bond, e_corr, e_self, dip, qph, violf,
         *rho) = comm.sum_many(parts)

        # PPPM finish: the mesh solve on the summed grids, then K3 with
        # their cotangents on the resident rows (a gradient through the
        # sum would count the mesh force S times)
        with torch.enable_grad():
            g = grid_tot.detach().requires_grad_(True)
            e_rec = mesh_energy(g, ff.pppm)
            (ct,) = torch.autograd.grad(e_rec.sum(), g)
        e_rec = e_rec.detach()
        forces = forces - interpolate_grad(ct, pos, loc.charge, box, order,
                                           mesh) - f_corr

        zero = pos.new_zeros(nrep)
        energies = {
            "harmonic": e_bond, "lj": e_lj, "ewald_short": e_ew,
            "ewald_long": e_rec - e_self - e_corr,
            "cavity_harmonic": zero, "cavity_coupling": zero,
            "cavity_dipole_self": zero,
            "cell_overflow": torch.clamp_max(violf, 1.0),
        }
        if has_photon:
            xy = c["xy"]
            q_xy, d_xy = qph * xy, dip * xy
            Kc = ff.cavity.K.to(dtype)
            gc = ff.cavity.couplstr.to(dtype)
            energies["cavity_harmonic"] = 0.5 * Kc * torch.sum(qph * qph,
                                                               dim=-1)
            energies["cavity_coupling"] = gc * torch.sum(d_xy * q_xy, dim=-1)
            energies["cavity_dipole_self"] = (0.5 * (gc * gc / Kc)
                                              * torch.sum(d_xy * d_xy,
                                                          dim=-1))
            Dq = q_xy + (gc / Kc) * d_xy
            f_cav = (-gc * loc.charge)[..., None] * Dq[:, None, :] * xy
            f_ph = -Kc * qph - gc * d_xy
            forces = forces + torch.where(cav_mask[..., None],
                                          f_ph[:, None, :], f_cav)

        v = v + 0.5 * per_row(dt) * forces * inv_m

        # ---- thermostat half 2 (MTTK) + cavity Langevin O-step: the
        # (b, 1, 3) draw of the unsharded indices path ----
        for i, m in enumerate(methods):
            mask = masks[m.group]
            slot = group_slot(m.group)
            if m.kind == "mttk":
                st = MTTKState(xi[:, slot], eta[:, slot])
                alpha = mttk_rescale_factor(st, dt)
                v = torch.where(mask[..., None], per_row(alpha) * v, v)
                K = comm.sum(kinetic_energy(v, loc.mass, mask))
                st = mttk_advance(st, 2.0 * K / m.dof, m.kT, m.dof, dt,
                                  m.tau)
                xi = _set_at(xi, slot, st.xi, add=False)
                eta = _set_at(eta, slot, st.eta, add=False)
            elif m.kind == "langevin":
                draw = noise.langevin(rep, i, m, rep.batch_shape + (1, 3))
                c_ou = torch.exp(-m.gamma * dt)[:, None]
                sigma = torch.sqrt((1.0 - c_ou * c_ou) * m.kT
                                   / loc.mass)[..., None]
                new_v = torch.where(mask[..., None],
                                    c_ou[..., None] * v + sigma * draw, v)
                dres = comm.sum(kinetic_energy(v, loc.mass, mask)
                                - kinetic_energy(new_v, loc.mass, mask))
                v = new_v
                lang_res = _set_at(lang_res, slot, dres, add=True)

        # ---- bookkeeping + observables ----
        ke_mol, ke_cav = comm.sum(torch.stack([
            kinetic_energy(v, loc.mass, mol_mask),
            kinetic_energy(v, loc.mass, cav_mask)]))
        y = dt - rep.time_comp
        t_new = rep.time_au + y
        comp_new = (t_new - rep.time_au) - y
        new_loc = loc._replace(position=pos, image=img, velocity=v,
                               forces=forces)
        new_rep = rep.replace(
            dt=dt, time_au=t_new, time_comp=comp_new,
            timestep=rep.timestep + 1, step=rep.step + 1,
            bussi_reservoir=bussi_res, bussi_instantaneous=bussi_inst,
            langevin_reservoir=lang_res, mttk_xi=xi, mttk_eta=eta,
            error_tolerance=err_tol)
        obs = dict(energies)
        obs["kinetic_molecular"] = ke_mol
        obs["kinetic_cavity"] = ke_cav
        obs["bussi_reservoir_molecular"] = bussi_res[:, 0]
        obs["bussi_reservoir_cavity"] = bussi_res[:, 1]
        obs["langevin_reservoir_molecular"] = lang_res[:, 0]
        obs["langevin_reservoir_cavity"] = lang_res[:, 1]
        obs["dt"] = dt
        obs["time_au"] = t_new
        if adaptive is not None:
            obs["error_tolerance"] = err_tol
        if want_dipole:
            obs["dipole"] = dip
        if rho:
            obs["rho_k_re"], obs["rho_k_im"] = rho
        return new_loc, new_rep, obs

    return step


def _scatter_in(state, data: DomainData, plan: DomainPlan, rank: int):
    """This rank's resident rows and tables of each replica of the batched
    ``state`` (``data`` from ``_rebuild`` of its positions). Filler slots
    read a template row: origin, zero velocity and charge, unit mass,
    typeid -1 (inert everywhere)."""
    Mrow, H, Mtot, B = plan.Mrow, plan.H, plan.Mtot, plan.B
    nrep = state.batch_shape[0]
    rows = slice(rank * Mrow, (rank + 1) * Mrow)
    perm = data.perm[:, rows].long()

    def gather(a, fill):  # a replica's (N, 3) rows, or a shared (N,) row
        if a.dim() == 1:
            return torch.cat([a, a.new_full((1,), fill)])[perm]
        return _rows(torch.cat([a, a.new_full((nrep, 1, 3), fill)], dim=1),
                     perm)

    loc = LocalState(
        position=gather(state.position, 0), image=gather(state.image, 0),
        velocity=gather(state.velocity, 0), forces=gather(state.forces, 0),
        mass=gather(state.mass, 1), charge=gather(state.charge, 0),
        typeid=gather(state.typeid, -1))
    halo = data.halo_src[:, rank].reshape(nrep, 2 * H).long()

    def with_halo(res, a, fill):
        return torch.cat([res, torch.cat([a, a.new_full((1,), fill)])[halo]],
                         dim=1)

    slot = torch.cat([data.slot_of[:, rank], data.slot_of.new_full(
        (nrep, 2 * H), plan.C_ext * plan.cap)], dim=1)
    excl = torch.cat([data.excl[:, rows],
                      data.excl.new_full((nrep, 2 * H + 1, B), Mtot)], dim=1)
    dat = ShardData(
        buckets=data.buckets[:, rank].contiguous(), slot=slot,
        centers=data.centers[:, rows], binned=data.binned[:, rows],
        valid=data.valid[:, rows], bond_k=data.bond_k[:, rank],
        bond_r0=data.bond_r0[:, rank],
        sing_partner=data.sing_partner[:, rank],
        sing_k=data.sing_k[:, rank], sing_r0=data.sing_r0[:, rank],
        sing_qq=data.sing_qq[:, rank], excl=excl,
        send_first=data.send_first[:, rank],
        send_last=data.send_last[:, rank],
        typeid=with_halo(loc.typeid, state.typeid, -1),
        charge=with_halo(loc.charge, state.charge, 0),
        pair_key=data.pair_key[:, rank].contiguous())
    return loc, dat


def _scatter_out(state, data: DomainData, loc: LocalState, rep,
                 plan: DomainPlan, comm: Communicator):
    """Every rank's rows gathered back into the global batched MDState,
    with the replicated scalars of ``rep``. Every atom row and the photon
    hold a slot when no overflow is flagged (an overflowed chunk is
    discarded by the caller), so which rows come back is static."""
    rows = torch.arange(plan.n0, device=state.device)
    present = (rows < plan.n_atoms) | (rows == plan.photon_row)
    idx = torch.clamp_max(data.inv_slot, plan.S * plan.Mrow - 1)

    def back(glob, rows):  # every rank's (b, Mrow, 3) rows, rank by rank
        flat = comm.all_gather(rows.transpose(0, 1)).transpose(0, 1)
        return torch.where(present[:, None], _rows(flat, idx), glob)

    return rep.replace(
        position=back(state.position, loc.position),
        image=back(state.image, loc.image),
        velocity=back(state.velocity, loc.velocity),
        forces=back(state.forces, loc.forces))


def make_domain_runner(ff, methods, plan: DomainPlan,
                       comm: Communicator | None = None, *,
                       rebuild_every: int = 20, adaptive=None,
                       obs_spec=None, noise=None, n_replicas: int = 1,
                       replica_comm: Communicator | None = None):
    """``run(state, n_steps) -> (state, obs)`` over the slabs: the
    counterpart of ``integrator.run_steps(make_step_fn(...), ...)`` with
    the same observables (NumPy columns, one host copy per call) plus
    ``domain_capacity_overflow``.

    Every ``rebuild_every`` steps the layout is rebuilt from the global
    state (every rank alike), each rank takes its rows, runs the chunk's
    steps, and the rows are gathered back. A rebuild that overflowed a
    capacity (in any replica of a batch) sets ``domain_capacity_overflow``
    and ``cell_overflow`` for the chunk's steps; the coverage invariant
    sets ``cell_overflow`` alone. Either way the returned state must be
    discarded (``Simulation.run`` retries the chunk). ``comm`` is the
    world-size-1 communicator when None; its world size must be
    ``plan.S``.

    ``state`` is one replica, or a batch of B replicas
    (``init_replica_states``; a batch over slabs): the rank's replicas
    then run as one batched slab step, each kernel once a step for all of
    them, and the observables come back (steps, B, ...), the
    ``run_replica_steps`` convention. ``n_replicas`` = R is the JAX
    runner's replicas x slabs mesh (``cavmd_tpu/parallel/domain.py:
    1486-1540``) on R x S ranks: B must be a multiple of R, and rank
    (r, s) runs slab s of replicas ``[r B/R, (r+1) B/R)``, its sums over
    ``comm`` (the S slabs of those replicas) only, drawing their rows of
    the batch's noise (``StreamNoise(B, rows)`` unless ``noise`` is
    given). At the end of ``run`` the replicas' leaves and observables
    are gathered over ``replica_comm`` (the R ranks of slab s), and every
    rank returns the whole batch. With R > 1 and neither communicator
    given, both come from the default process group
    (``comm.grid_communicators``). Raises ``ValueError`` when the slab
    communicator and the plan, or the replica communicator and R, or the
    batch and R disagree.
    """
    if n_replicas > 1 and comm is None and replica_comm is None:
        replica_comm, comm = grid_communicators(n_replicas, plan.S)
    comm = comm if comm is not None else Communicator()
    if comm.world_size != plan.S:
        raise ValueError(f"the communicator has {comm.world_size} ranks, "
                         f"the plan {plan.S} slabs")
    replica_comm = (replica_comm if replica_comm is not None
                    else Communicator())
    if replica_comm.world_size != n_replicas:
        raise ValueError(
            f"the replica communicator has {replica_comm.world_size} "
            f"ranks, the runner n_replicas={n_replicas}")
    steps, tables = {}, {}
    wv = (np.asarray(obs_spec[1]) if obs_spec is not None
          and obs_spec[1] is not None else None)

    def step_for(full, lo, hi):
        """The slab step of rows [lo, hi) of a batch of ``full``."""
        if (full, lo, hi) not in steps:
            src = noise
            if src is None and (lo, hi) != (0, full):
                src = StreamNoise(full, slice(lo, hi))
            steps[full, lo, hi] = make_domain_step(
                ff, methods, plan, comm, adaptive=adaptive,
                obs_spec=obs_spec, noise=src)
        return steps[full, lo, hi]

    def run_batch(batch, n_steps: int, step):
        """``n_steps`` of this rank's replicas (a batch)."""
        nrep = batch.batch_shape[0]
        dev = batch.device
        if dev not in tables:
            tables[dev] = plan_tables(plan, dev)
        buf = ObsBuffer(n_steps)
        with torch.no_grad():
            for start in range(0, n_steps, rebuild_every):
                k = min(rebuild_every, n_steps - start)
                data = _rebuild(batch.position, plan, batch.box_L,
                                ff.bond_k_per, ff.bond_r0_per,
                                ff.pair_inert, batch.charge, tables[dev])
                loc, dat = _scatter_in(batch, data, plan, comm.rank)
                ovf = (data.slab_overflow | data.bucket_overflow).to(
                    batch.position.dtype).expand(nrep)
                rep = batch
                for _ in range(k):
                    loc, rep, obs = step(loc, rep, dat)
                    obs["domain_capacity_overflow"] = ovf
                    buf.add(obs)
                batch = _scatter_out(batch, data, loc, rep, plan, comm)
        out = buf.to_numpy()
        out["cell_overflow"] = np.maximum(out["cell_overflow"],
                                          out["domain_capacity_overflow"])
        if wv is not None and ff.ghost_typeid >= 0:
            # rho(k) of the ghost rows, which hold no slot: they are
            # pinned, so one term serves the call's steps
            ghost = (batch.typeid == ff.ghost_typeid)[..., None]
            kr = batch.position @ torch.as_tensor(
                wv, dtype=batch.position.dtype, device=dev).T
            for k, f in (("rho_k_re", torch.cos), ("rho_k_im", torch.sin)):
                out[k] = out[k] + torch.where(ghost, f(kr), 0.0).sum(
                    -2).cpu().numpy()
        ts = np.arange(batch.step - n_steps + 1, batch.step + 1,
                       dtype=np.int64)
        out["timestep"] = np.broadcast_to(ts[:, None],
                                          (n_steps, nrep)).copy()
        return batch, out

    def run(state, n_steps: int):
        if not state.batch_shape:  # one replica: a batch of one, squeezed
            if n_replicas != 1:
                raise ValueError(
                    f"a one-replica state for a runner of n_replicas="
                    f"{n_replicas}: give a batch of a multiple of "
                    f"{n_replicas} replicas (init_replica_states)")
            if n_steps < 1:
                return state, {}
            final, obs = run_batch(_as_batch(state), n_steps,
                                   step_for(1, 0, 1))
            return final.replace(**{k: getattr(final, k)[0]
                                    for k in PER_REPLICA}), {
                k: v[:, 0] for k, v in obs.items()}
        B = state.batch_shape[0]
        R = n_replicas
        if B % R:
            raise ValueError(
                f"a state of batch shape {state.batch_shape} for a runner "
                f"of n_replicas={R}: give a batch of a multiple of {R} "
                "replicas (init_replica_states)")
        if n_steps < 1:
            return state, {}
        b = B // R
        lo = replica_comm.rank * b
        final, obs = run_batch(replica_rows(state, slice(lo, lo + b)),
                               n_steps, step_for(B, lo, lo + b))
        if R == 1:
            return final, obs
        stacked = state.replace(
            step=final.step, cell_list=None, cell_anchor=None, **{
                k: replica_comm.stack(getattr(final, k)).flatten(0, 1)
                for k in PER_REPLICA})
        # (R, steps, b, ...) -> (steps, B, ...)
        return stacked, {k: np.moveaxis(replica_comm.stack(
            torch.from_numpy(np.ascontiguousarray(v))).numpy(), 0, 1).reshape(
                (n_steps, B) + v.shape[2:]) for k, v in obs.items()}

    return run
