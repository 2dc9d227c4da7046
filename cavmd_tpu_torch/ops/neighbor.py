"""Cell lists for large N: host planning, the bucket build on the device,
and the plain tile path of the cell pair pass.

Port of ``cavmd_tpu/ops/neighbor.py``: the bucket layout and the z-sorted
column layout (``plan_zcolumns``, ``build_zcol_list``; its pair pass is
``ops/zcol_kernels.py``). Particles are binned into fixed-capacity cell
buckets; a pair pass visits, for every cell, its own bucket against the
buckets of its 27 neighbour cells:

- host planning (``plan_cells``, ``neighbor_cell_table``,
  ``exclusion_table``) is NumPy and gives the JAX package's numbers;
- the bucket build (``build_cell_list``) is a handful of tensor ops: one
  sort of packed (cell, index) keys, a running maximum for the rank within
  each cell, two scatters. It never reads back from the device; a bucket
  overflow is a 0-d flag, never a silent drop. Positions (B, N, 3) of a
  replica batch build every replica's list in the same operations (the
  replica leads the sort key, so the sort and the running maximum run once
  over B N), with a (B,) flag; each replica's list equals its one-replica
  build bit for bit;
- ``cell_pair_force`` is the plain tile path, the twin of the cell kernel
  (``ops/cell_kernels.py``): (cells, cap, 27 cap) tiles built block by
  block, so peak memory is bounded by ``cell_block``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class CellListConfig(NamedTuple):
    """Static geometry of the cell decomposition."""

    ncells: tuple  # (cx, cy, cz)
    cap: int  # bucket capacity
    r_cut: float
    skin: float

    @property
    def total_cells(self):
        return self.ncells[0] * self.ncells[1] * self.ncells[2]


def plan_cells(box_L, r_cut, *, skin=1.0, n=None, density=None, cap=None):
    """Cell counts and bucket capacity (host side), as the JAX package
    plans them: ``skin`` is the requested minimum Verlet skin, snapped up
    to the free slack ``min(box / ncells) - r_cut``; skin 0 stays 0
    (rebuild every step)."""
    box_L = np.asarray(box_L, float)
    width = r_cut + skin
    ncells = tuple(int(max(np.floor(L / width), 1)) for L in box_L)
    if cap is None:
        vol_cell = np.prod(box_L) / np.prod([max(c, 1) for c in ncells])
        rho = (n / np.prod(box_L)) if n else (density or 0.01)
        cap = int(np.ceil(rho * vol_cell * 1.8)) + 8  # headroom; overflow flagged
    if skin > 0:
        skin = float(min(L / c for L, c in zip(box_L, ncells)) - r_cut)
    return CellListConfig(ncells=ncells, cap=cap, r_cut=float(r_cut),
                          skin=float(skin))


class CellList(NamedTuple):
    """Bucketed particle ids (tensors on the particles' device). A replica
    batch's list has a leading axis B on every field but
    ``neighbor_cells`` (shared), and its ids and slots are each replica's
    own (local) ones."""

    bucket_idx: torch.Tensor  # (C, cap) int32 particle ids, N = empty slot
    overflow: torch.Tensor  # 0-d bool: some cell held more than cap
    neighbor_cells: torch.Tensor  # (C, 27) int32 neighbour cell ids
    # (N,) int32 flat slot c * cap + rank of each particle; C * cap for a
    # particle that an overflow left without a slot
    slot_of: torch.Tensor
    # z-sorted column layout only (build_zcol_list): the positions at build
    # time, raw and in the assigned column's image. The pair pass takes
    # local_anchor + minimage(position - anchor), so a particle that
    # re-wraps between rebuilds stays next to its sorted neighbours.
    anchor: torch.Tensor | None = None  # (N, 3)
    local_anchor: torch.Tensor | None = None  # (N, 3)
    # (XY, 9 cap) int32: each column's 9 xy-neighbour columns' slots merged
    # into one list by ascending quantised z, empty slots (id N) last
    halo_idx: torch.Tensor | None = None


def replica_list(clist: CellList, r: int) -> CellList:
    """Replica r's one-replica list from a replica batch's ``CellList``."""
    return clist._replace(**{
        k: getattr(clist, k)[r] for k in ("bucket_idx", "overflow", "slot_of",
                                          "anchor", "local_anchor",
                                          "halo_idx")
        if getattr(clist, k) is not None})


def neighbor_cell_table(ncells) -> np.ndarray:
    """(C, 27) wrapped neighbour-cell ids (host side). With fewer than 3
    cells along an axis, distinct offsets wrap onto the same cell; every
    repeat after the first becomes the sentinel id C (an always-empty
    cell), so no pair is counted twice."""
    cx, cy, cz = ncells
    total = cx * cy * cz
    ids = np.arange(total)
    x, y, z = ids // (cy * cz), (ids // cz) % cy, ids % cz
    out = np.empty((total, 27), dtype=np.int32)
    k = 0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                out[:, k] = (((x + dx) % cx) * cy + (y + dy) % cy) * cz \
                    + (z + dz) % cz
                k += 1
    for row in out:
        seen = set()
        for k in range(27):
            if row[k] in seen:
                row[k] = total
            else:
                seen.add(row[k])
    return out


def exclusion_table(n, bond_group, max_excl=None) -> np.ndarray:
    """(N+1, max_excl) int32 bonded partner ids per particle, N = none;
    the last row is the empty-slot sentinel. ``max_excl=None`` sizes it
    to the largest bond degree."""
    bond_group = np.asarray(bond_group.cpu() if isinstance(
        bond_group, torch.Tensor) else bond_group).reshape(-1, 2)
    if max_excl is None:
        degree = np.zeros(n, dtype=np.int64)
        if bond_group.size:
            np.add.at(degree, bond_group[:, 0], 1)
            np.add.at(degree, bond_group[:, 1], 1)
        max_excl = max(int(degree.max(initial=0)), 1)
    table = np.full((n + 1, max_excl), n, dtype=np.int32)
    counts = np.zeros(n, dtype=np.int32)
    for a, b in bond_group:
        for i, j in ((int(a), int(b)), (int(b), int(a))):
            if counts[i] >= max_excl:
                raise ValueError("exclusion capacity exceeded")
            table[i, counts[i]] = j
            counts[i] += 1
    return table


def _rank_and_bucket(order, sorted_bin, n, n_bins, cap, n_real_bins=None,
                     batch=None):
    """Buckets from particle ids in bin-sorted order.

    The rank within a bin is the distance to the bin's first element, a
    running maximum over segment starts. Returns ``(bucket_idx (n_bins,
    cap), overflow, slot_of)``. Ranks past ``cap`` are clamped onto slot
    cap - 1, where the bin's last particle wins (the JAX package's
    scatter applies its updates in order); every other particle of an
    over-full bin owns no slot and maps to the dump slot ``n_bins * cap``.
    Bins from ``n_real_bins`` on are dump bins, which may hold more than
    ``cap`` without flagging an overflow (None: every bin is real).

    ``batch`` B: ``order`` holds the ids ``r n + i`` of B replicas of ``n``
    particles and ``sorted_bin`` the bins ``r n_bins + c``, sorted with the
    replica first, so replica r fills places [r n, (r + 1) n). The running
    maximum then runs once over all B n places, and the results gain the
    leading axis: ``bucket_idx`` (B, n_bins, cap) of local ids ``i``,
    ``overflow`` (B,), ``slot_of`` (B, n) of local slots ``c cap + rank``.
    """
    dev = order.device
    m = order.shape[0]
    iota = torch.arange(m, device=dev)
    change = sorted_bin[1:] != sorted_bin[:-1]
    true1 = torch.ones(1, dtype=torch.bool, device=dev)
    is_start = torch.cat([true1, change])
    is_last = torch.cat([change, true1])
    first = torch.cummax(torch.where(is_start, iota, 0), dim=0).values
    rank = iota - first
    over = rank >= cap
    if n_real_bins is not None:
        over = over & (sorted_bin < n_real_bins)
    flat = sorted_bin * cap + torch.clamp_max(rank, cap - 1)
    per = n_bins * cap
    dump = per * (batch or 1)
    # one writer per slot: ranks below cap - 1, and the last of each bin
    target = torch.where((rank < cap - 1) | is_last, flat, dump)
    order32 = (order if batch is None else order % n).to(torch.int32)
    bucket = torch.full((dump + 1,), n, dtype=torch.int32, device=dev)
    bucket.scatter_(0, target, order32)
    bucket_idx = bucket[:dump]
    owns = bucket_idx[flat] == order32
    if batch is None:
        overflow = torch.any(over)
        slot_of = torch.empty(n, dtype=torch.int32, device=dev).scatter_(
            0, order, torch.where(owns, flat, dump).to(torch.int32))
        return bucket_idx.view(n_bins, cap), overflow, slot_of
    # a replica's places and bins are a block of each: its local slot is
    # the global one modulo a replica's slots
    slot_of = torch.empty(m, dtype=torch.int32, device=dev).scatter_(
        0, order, torch.where(owns, flat % per, per).to(torch.int32))
    return (bucket_idx.view(batch, n_bins, cap),
            over.view(batch, n).any(dim=1), slot_of.view(batch, n))


def build_cell_list(position, box_L, cfg: CellListConfig,
                    neighbor_cells) -> CellList:
    """Bin particles into fixed-capacity buckets, on the particles' device
    and with no read-back. A particle's cell is ``floor(frac * ncells)``
    clipped to the grid, in the working dtype, as in the JAX package; the
    packed (cell, index) key sort orders each bucket by particle index.
    ``position`` (B, N, 3) builds a replica batch's list: one sort of
    (r C + cell, r N + index) keys over B N (module note)."""
    n = position.shape[-2]
    frac = position / box_L.to(position.dtype) + 0.5
    cell = None
    for d, nc in enumerate(cfg.ncells):
        c = torch.floor(frac[..., d] * float(nc)).to(torch.int64)
        c = torch.clamp(c, 0, nc - 1)
        cell = c if cell is None else cell * nc + c
    dev = position.device
    batch = position.shape[0] if position.dim() == 3 else None
    if batch is None:
        bits = max(int(np.ceil(np.log2(max(n + 1, 2)))), 1)
        key = cell * (1 << bits) + torch.arange(n, device=dev)
    else:  # the replica leads the bin, and the low bits hold r N + i:
        # (r C + cell) 2^bits + r N + i = cell 2^bits + r stride + i
        bits = max(int(np.ceil(np.log2(max(batch * n + 1, 2)))), 1)
        stride = (cfg.total_cells << bits) + n
        iota = torch.arange(n, device=dev) + torch.arange(
            0, batch * stride, stride, device=dev)[:, None]
        key = torch.add(iota, cell, alpha=1 << bits)
    packed = torch.sort(key.reshape(-1)).values
    order = packed & ((1 << bits) - 1)
    bucket_idx, overflow, slot_of = _rank_and_bucket(
        order, packed >> bits, n, cfg.total_cells, cfg.cap, batch=batch)
    return CellList(bucket_idx=bucket_idx, overflow=overflow,
                    neighbor_cells=neighbor_cells, slot_of=slot_of)


def plan_zcolumns(box_L, r_cut, *, skin=1.0, n=None):
    """The xy columns of the z-sorted layout (host side), as the JAX
    package plans them: columns at least r_cut + skin wide, the skin
    snapped up to the free slack, and a per-column capacity of the mean
    occupancy plus a Poisson tail, rounded up to a multiple of 128 (the
    j-block). Returned as a ``CellListConfig`` with ``ncells = (cx, cy,
    1)``, so the carried-list and overflow-retry plumbing is shared."""
    box_L = np.asarray(box_L, float)
    width = r_cut + skin
    cx = int(max(np.floor(box_L[0] / width), 1))
    cy = int(max(np.floor(box_L[1] / width), 1))
    if skin > 0:
        skin = float(min(box_L[0] / cx, box_L[1] / cy) - r_cut)
    mean = (n or 1) / (cx * cy)
    cap = mean + 4.5 * np.sqrt(mean) + 16  # Poisson tail + drift headroom
    cap = int(np.ceil(cap / 128.0)) * 128
    return CellListConfig(ncells=(cx, cy, 1), cap=cap, r_cut=float(r_cut),
                          skin=float(skin))


def xy_neighbor_table(cx: int, cy: int) -> np.ndarray:
    """(cx cy, 9) wrapped ids of each xy column's neighbour columns, itself
    included, in the JAX package's order (dx outer, dy inner; host
    side)."""
    ids = np.arange(cx * cy)
    x, y = ids // cy, ids % cy
    cols = [((x + dx) % cx) * cy + (y + dy) % cy
            for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
    return np.stack(cols, axis=1).astype(np.int32)


def build_zcol_list(position, box_L, cfg: CellListConfig,
                    neighbor_columns) -> CellList:
    """Bin particles into z-sorted xy-column buckets, on the particles'
    device and with no read-back. ``neighbor_columns`` is the (XY, 9)
    table of ``xy_neighbor_table`` on that device.

    ``bucket_idx`` (XY, cap), ``overflow`` and ``slot_of`` as in
    :func:`build_cell_list`; within a column the slots ascend in wrapped z
    quantised to 2^14 levels (one stable argsort of ``col * 16384 + zq``).
    Also the anchor fields and the merged halo: the 9 neighbour columns'
    slots re-sorted by quantised z with a stable row-wise sort, empty slots
    keyed past every real z so they come last. The key quantisation only
    sets how tightly blocks pack: the pair pass bounds its blocks from the
    live positions. ``position`` (B, N, 3) builds a replica batch's list:
    the replica leads the argsort key, the halo sort runs row-wise over
    every replica's columns, and the fields gain the leading axis."""
    n = position.shape[-2]
    dtype = position.dtype
    dev = position.device
    cx, cy, _ = cfg.ncells
    XY = cx * cy
    box = box_L.to(dtype)
    frac = position / box + 0.5
    col2 = [torch.clamp(torch.floor(frac[..., d] * float(nc)).to(torch.int64),
                        0, nc - 1) for d, nc in enumerate((cx, cy))]
    col = col2[0] * cy + col2[1]
    zf = frac[..., 2]
    zq = torch.clamp(torch.floor((zf - torch.floor(zf)) * 16384.0)
                     .to(torch.int64), 0, 16383)
    batch = position.shape[0] if position.dim() == 3 else None
    if batch is None:
        order = torch.argsort(col * 16384 + zq, stable=True)
        bucket_idx, overflow, slot_of = _rank_and_bucket(order, col[order],
                                                         n, XY, cfg.cap)
    else:  # the replica leads: (r XY + col) 16384 + zq over B N
        gcol = (col + torch.arange(0, batch * XY, XY, device=dev)[:, None]
                ).reshape(-1)
        order = torch.argsort(torch.add(zq.reshape(-1), gcol, alpha=16384),
                              stable=True)
        bucket_idx, overflow, slot_of = _rank_and_bucket(
            order, gcol[order], n, XY, cfg.cap, batch=batch)

    # build-time coordinates: xy in the assigned column's centre image, z
    # in the primary image
    colf = torch.stack(col2, dim=-1).to(dtype)
    ncol = torch.stack([torch.full((), float(cx), dtype=dtype, device=dev),
                        torch.full((), float(cy), dtype=dtype, device=dev)])
    center = ((colf + 0.5) / ncol - 0.5) * box[:2]
    off_xy = position[..., :2] - center
    loc_xy = center + off_xy - box[:2] * torch.round(off_xy / box[:2])
    loc_z = (position[..., 2:3]
             - box[2] * torch.round(position[..., 2:3] / box[2]))
    local_anchor = torch.cat([loc_xy, loc_z], dim=-1)

    xy_nb = neighbor_columns.long()
    sentinel = torch.full((1,), 1 << 20, dtype=torch.int64, device=dev)
    if batch is None:
        zq_slot = torch.cat([zq, sentinel])[bucket_idx.long()]
        cand_idx = bucket_idx[xy_nb].reshape(XY, 9 * cfg.cap)
        cand_zq = zq_slot[xy_nb].reshape(XY, 9 * cfg.cap)
    else:
        zq_pad = torch.cat([zq, sentinel.expand(batch, 1)], dim=1)
        zq_slot = torch.gather(zq_pad, 1, bucket_idx.view(batch, -1).long()
                               ).view(batch, XY, cfg.cap)
        cand_idx = bucket_idx[:, xy_nb].reshape(batch, XY, 9 * cfg.cap)
        cand_zq = zq_slot[:, xy_nb].reshape(batch, XY, 9 * cfg.cap)
    morder = torch.argsort(cand_zq, dim=-1, stable=True)
    halo_idx = torch.take_along_dim(cand_idx, morder, dim=-1)
    return CellList(bucket_idx=bucket_idx, overflow=overflow,
                    neighbor_cells=torch.zeros(0, dtype=torch.int32,
                                               device=dev),
                    slot_of=slot_of, anchor=position,
                    local_anchor=local_anchor, halo_idx=halo_idx)


def cell_block_for(cfg: CellListConfig, itemsize: int):
    """Cells per tile block so one (block, cap, 27 cap) tile of
    ``itemsize``-byte values holds about 256 MB (the JAX package's choice,
    a divisor of the cell count); None when all cells fit in one block."""
    per_cell = cfg.cap * 27 * cfg.cap * itemsize
    max_block = max(1, (256 << 20) // max(per_cell, 1))
    C = cfg.total_cells
    if C <= max_block:
        return None
    blk = max_block
    while C % blk != 0:
        blk -= 1
    return blk


def cell_tiles(position, box_L, clist: CellList, cell_block=None):
    """The candidate tiles of the cell pass, block by block.

    Yields ``(cells, idx_i, id_j, dxs, r2)`` for each block of cells:
    ``cells`` the block's slice of the cell axis, ``idx_i`` (B, cap) its
    bucket ids, ``id_j`` (B, 27 cap) the neighbour buckets' ids (the
    sentinel cell C is an always-empty row), ``dxs`` the three minimum-image
    displacement components and ``r2`` (B, cap, 27 cap). Empty slots sit at
    a far position; their pairs must be masked by id before use.
    """
    n = position.shape[0]
    dtype = position.dtype
    C, cap = clist.bucket_idx.shape
    far = torch.full((1, 3), 1e6, dtype=dtype, device=position.device)
    pos_pad = torch.cat([position, far])
    idx_b = clist.bucket_idx.long()
    idx_x = torch.cat([idx_b, torch.full_like(idx_b[:1], n)])
    pos_x = pos_pad[idx_x]  # (C + 1, cap, 3)
    box = box_L.to(dtype)
    blk = C if cell_block is None else cell_block
    for start in range(0, C, blk):
        cells = slice(start, min(start + blk, C))
        jc = clist.neighbor_cells[cells].long()
        b = jc.shape[0]
        id_j = idx_x[jc].reshape(b, 27 * cap)
        pj = pos_x[jc].reshape(b, 27 * cap, 3)
        pi = pos_x[cells]
        dxs, r2 = [], None
        for d in range(3):
            dd = pi[:, :, None, d] - pj[:, None, :, d]
            dd = dd - box[d] * torch.round(dd / box[d])
            dxs.append(dd)
            r2 = dd * dd if r2 is None else r2 + dd * dd
        yield cells, idx_b[cells], id_j, dxs, r2


def cell_pair_force(position, box_L, clist: CellList, cfg: CellListConfig,
                    pair_kernel, features, exclusions=None, cell_block=None,
                    pair_key=None, rows=None):
    """A pair interaction over the cell tiles (the plain tile path).

    ``pair_kernel(r2_safe, active, feat_i, feat_j) -> (e, f_over_r)`` with
    ``e`` one tile or a tuple of tiles; ``features`` (N+1, F) per-particle
    rows (last row the sentinel), ``exclusions`` an (N+1, max_excl) table.
    A pair is active when both slots are real, it is not a self pair, not
    excluded, and r^2 < r_cut^2. ``pair_key`` (N,), when given, is the id
    the self and exclusion tests compare instead of the row id (the slab
    grid maps a halo copy to its resident row). Forces go to the slot
    owners (an overflow-dropped particle gets zero). ``rows=(row0,
    n_rows)`` keeps the pairs whose i row id is in ``[row0, row0 +
    n_rows)`` (atom sharding by rows): the other rows' forces are zero and
    the energies are the range's share. Returns (forces (N, 3), energy) or
    (forces, tuple of energies), each energy half the tile sum.
    """
    n = position.shape[0]
    C, cap = clist.bucket_idx.shape
    rc2 = cfg.r_cut * cfg.r_cut
    key_x = None
    if pair_key is not None:
        key_x = torch.cat([pair_key.long(),
                           pair_key.new_full((1,), n).long()])
    feat_x = torch.cat([features[clist.bucket_idx.long()],
                        torch.zeros_like(features[:1])[None].expand(
                            1, cap, -1)])
    f_b = position.new_zeros((C, cap, 3))
    sums = None
    for cells, idx_i, id_j, dxs, r2 in cell_tiles(position, box_L, clist,
                                                  cell_block):
        b = idx_i.shape[0]
        key_i, key_j = ((idx_i, id_j) if key_x is None
                        else (key_x[idx_i], key_x[id_j]))
        own_i = idx_i < n
        if rows is not None:
            own_i = own_i & (idx_i >= rows[0]) & (idx_i < rows[0] + rows[1])
        active = (own_i[:, :, None] & (id_j < n)[:, None, :]
                  & (key_i[:, :, None] != key_j[:, None, :]) & (r2 < rc2))
        if exclusions is not None:
            excl_i = exclusions[idx_i].long()  # (B, cap, E)
            hit = (excl_i[:, :, None, :] == key_j[:, None, :, None]).any(-1)
            active = active & ~hit
        feat_j = feat_x[clist.neighbor_cells[cells].long()].reshape(
            b, 27 * cap, -1)
        r2_safe = torch.where(active, r2, torch.ones_like(r2))
        e_pair, f_over_r = pair_kernel(r2_safe, active, feat_x[cells],
                                       feat_j)
        terms = e_pair if isinstance(e_pair, tuple) else (e_pair,)
        blk = [torch.sum(torch.where(active, e, 0.0)) for e in terms]
        sums = blk if sums is None else [s + e for s, e in zip(sums, blk)]
        s = torch.where(active, f_over_r, 0.0)
        f_b[cells] = torch.stack([torch.sum(s * dd, dim=2) for dd in dxs],
                                 dim=-1)
    forces = slot_gather_forces(f_b, clist.slot_of)
    energies = tuple(0.5 * s for s in sums)
    return (forces, energies[0]) if len(energies) == 1 else (forces,
                                                             energies)


def slot_gather_forces(f_b, slot_of):
    """Per-particle forces from (C, cap, 3) slot rows: a gather by
    ``slot_of``; the dump slot C * cap (an overflow-dropped particle)
    reads zero."""
    C, cap, k = f_b.shape
    flat = f_b.reshape(C * cap, k)
    idx = torch.clamp_max(slot_of.long(), C * cap - 1)
    valid = (slot_of < C * cap).to(f_b.dtype)[:, None]
    return flat[idx][:, :3] * valid


def make_particle_features(typeid, charge, n_types: int):
    """(N+1, T+1) feature rows [type one-hot | charge]; the last row (the
    empty-slot sentinel) is zero. The one-hot is a comparison, so a CUDA
    typeid is never read back for a range check."""
    types = torch.arange(n_types, device=typeid.device)
    onehot = (typeid.long()[:, None] == types).to(charge.dtype)
    feats = torch.cat([onehot, charge[:, None]], dim=1)
    return torch.cat([feats, feats.new_zeros((1, n_types + 1))])


def combine_pair_table(hi, hj, table):
    """Per-pair ``table[type_i, type_j]`` tiles (B, cap, 27 cap) from the
    one-hot rows ``hi`` (B, cap, T) and ``hj`` (B, 27 cap, T): two batched
    products in which each output sums one nonzero term, so the values are
    the table's exactly (float32 products run in full float32: TF32 is off
    in the port). The table stays a device tensor; nothing is read back."""
    return torch.matmul(torch.matmul(hi, table), hj.transpose(1, 2))


def make_lj_cell_kernel(eps_table, sig2_table, rcut2_table, vshift_table,
                        n_types: int):
    """Shifted LJ on the tiles from the (T, T) tables of
    ``ops/lj.py:lj_kernel_tables`` (eps, sigma^2, r_cut^2, v_shift)."""

    def kernel(r2_safe, active, feat_i, feat_j):
        hi, hj = feat_i[..., :n_types], feat_j[..., :n_types]
        eps = combine_pair_table(hi, hj, eps_table)
        s2 = combine_pair_table(hi, hj, sig2_table)
        vshift = combine_pair_table(hi, hj, vshift_table)
        rc2 = combine_pair_table(hi, hj, rcut2_table)
        in_range = active & (r2_safe < rc2) & (eps != 0)
        inv = s2 / r2_safe
        s6 = inv * inv * inv
        s12 = s6 * s6
        e = torch.where(in_range, 4.0 * eps * (s12 - s6) - vshift, 0.0)
        f = torch.where(in_range, 24.0 * eps * (2.0 * s12 - s6) / r2_safe,
                        0.0)
        return e, f

    return kernel


def make_ewald_cell_kernel(kappa: float, n_types: int):
    """Short-range Ewald (true erfc) on the tiles; charges ride the last
    feature column. ``kappa`` is a host number."""
    two_over_sqrt_pi = 2.0 / math.sqrt(math.pi)

    def kernel(r2_safe, active, feat_i, feat_j):
        qq = feat_i[..., n_types][:, :, None] * feat_j[..., n_types][:, None, :]
        in_range = active & (qq != 0)
        r = torch.sqrt(r2_safe)
        ec = torch.special.erfc(kappa * r)
        e = torch.where(in_range, qq * ec / r, 0.0)
        f = torch.where(
            in_range,
            qq * (ec / r2_safe + kappa * two_over_sqrt_pi
                  * torch.exp(-(kappa * r) ** 2) / r) / r,
            0.0)
        return e, f

    return kernel


def make_fused_cell_kernel(eps_table, sig2_table, rcut2_table, vshift_table,
                           kappa: float, n_types: int):
    """LJ and Ewald short in one tile pass; energies come back as
    (e_lj, e_ewald)."""
    lj = make_lj_cell_kernel(eps_table, sig2_table, rcut2_table,
                             vshift_table, n_types)
    ew = make_ewald_cell_kernel(kappa, n_types)

    def kernel(r2_safe, active, feat_i, feat_j):
        e_lj, f_lj = lj(r2_safe, active, feat_i, feat_j)
        e_ew, f_ew = ew(r2_safe, active, feat_i, feat_j)
        return (e_lj, e_ew), f_lj + f_ew

    return kernel
