"""The z-sorted column pair pass: CUDA kernels, hull and plain twins.

``zcol_pair_force`` (``csrc/zcol_pair.cu``) replaces the TPU kernel
``_zcol_kernel`` of ``cavmd_tpu/ops/pallas_kernels.py`` (wrapper
``fused_zsort_cols_pallas``), the pair pass of ``pair_mode='zcol'``.
Particles sit z-sorted in xy columns (``ops/neighbor.py:build_zcol_list``);
each column's 9 neighbour columns are merged into one z-sorted halo, cut
into j-blocks of 128 slots, and each i-block of 16 slots of a column
visits only the j-blocks whose live z range can reach it:

- ``zcol_local_positions``: ``local_anchor + minimage(position -
  anchor)``, coordinates that stay continuous while a particle re-wraps
  between rebuilds;
- ``zcol_hull``: per-block z bounds from the live positions, the overlap
  test on the periodic z circle, and the two-run hull ``(s1, c1, s2,
  count)`` of each i-block (two runs when the window wraps the z seam),
  plus the 0-d flag ``count > W``: a hull wider than the visit window W
  would drop blocks, so it rides the ``cell_overflow`` channel;
- the pass evaluates, for every real i slot, the j slots of the first
  ``min(count, W)`` blocks of its i-block's hull, run 1 then run 2: LJ
  from the (T, T) tables and Ewald short with true erfc, ``rint``
  minimum image on every pair, self and exclusion tests by id. This is
  what the TPU kernel computes, with the pair math of the XLA tile path
  (``make_fused_cell_kernel``), as the cell kernel does.

On a CUDA tensor two kernels do all of it, with no read-back: the hull
kernel (``_launch_hull``, launches counted as ``zcol_hull``; it replaces
the XLA hull of ``fused_zsort_cols_pallas``) computes the local z and the
hull bit-equal to the twins, and for the pass each particle's local
coordinates (with the twins' operations) and charge as one (N, 4) row;
the pair kernel (launches counted as ``zcol_pair``) stages its rows from
that table. The wrappers run the plain twins only for tensors on the CPU; for
a CUDA tensor they launch the kernels or raise. Everything here is in the
working dtype; the JAX package computes this pass in float32 whatever its
dtype (``pallas_kernels.py:1405``).

Positions may carry a leading replica axis, (B, N, 3) with a batched
column list (``ops/neighbor.py:build_zcol_list``; replica batching,
``parallel/replicas.py``): each kernel then runs once for every replica,
over B XY columns, with one visit window W; the energies and the window
flag come back (B,). The plain twin runs the one-replica twin on each
replica and stacks the results.

``rows=(row0, n_rows)`` (atom sharding by rows, ``parallel/shard.py``):
the pair kernel and its twin keep the i rows whose particle id is in
``[row0, row0 + n_rows)`` (within each replica); the forces stay (N, 3),
zero on the other rows, and the energies are the range's share, so the S
ranges of a partition add up to the full pass. The hull and the window
flag are the full pass's: the hull kernel runs as without a range. A pair
launch with a row range counts as ``zcol_pair_rows``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cavmd_tpu_torch.ops import _cuda
from cavmd_tpu_torch.ops.neighbor import (
    CellList,
    CellListConfig,
    make_fused_cell_kernel,
    make_particle_features,
    replica_list,
    slot_gather_forces,
)

I_BLOCK = 16  # slots of an i-block: the unit of the hull (the JAX ``bi``)
J_BLOCK = 128  # slots of a j-block of the merged halo

_V = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# (pos, anchor, local_anchor, box, charge, bucket, halo, n, ncols, cap, W,
# r_cut, replicas, hull, flags, loc, stream)
_HULL_ARGS = [_V] * 7 + [_I] * 4 + [_D, _I] + [_V] * 4
# (loc, box, typeid, eps, sig2, rcut2, vshift, ntypes, bucket, halo, hull,
# exclusions, max_excl, n, ncols, cap, W, r_cut, r_cut^2, kappa, row0,
# row_end, replicas, forces, partials, stream)
_PAIR_ARGS = ([_V] * 7 + [_I] + [_V] * 4 + [_I] * 5 + [_D] * 3 + [_I] * 3
              + [_V] * 3)
_SIGNATURES = {"cavmd_zcol_hull_f32": _HULL_ARGS,
               "cavmd_zcol_hull_f64": _HULL_ARGS,
               "cavmd_zcol_pair_f32": _PAIR_ARGS,
               "cavmd_zcol_pair_f64": _PAIR_ARGS}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def plan_zcol_window(n, n_columns, ncells_xy, bi=I_BLOCK):
    """The visit window W (j-blocks per i-block), as the JAX package plans
    it: the mean column occupancy times the 2 r_cut z fraction times 9
    columns, plus the i-block's own span (~9 bi slots), with a 30% density
    margin, in blocks of 128, plus 3 blocks of headroom."""
    est = 9 * bi + 1.3 * 18.0 * (n / n_columns) / min(ncells_xy)
    return int(np.ceil(est / 128.0)) + 3


def zcol_local_positions(position, box_L, clist: CellList):
    """Drift-continuous local coordinates ``local_anchor + minimage(
    position - anchor)`` (N, 3)."""
    box = box_L.to(position.dtype)
    disp = position - clist.anchor
    disp = disp - box * torch.round(disp / box)
    return clist.local_anchor + disp


def _block_bounds(z, real, blk):
    """(min z, max z, any real) over blocks of ``blk`` slots of each row;
    empty slots count as +inf / -inf."""
    XY = z.shape[0]
    zb = z.reshape(XY, -1, blk)
    rb = real.reshape(XY, -1, blk)
    bmin = torch.where(rb, zb, float("inf")).amin(dim=-1)
    bmax = torch.where(rb, zb, float("-inf")).amax(dim=-1)
    return bmin, bmax, rb.any(dim=-1)


def zcol_hull(pos_loc, box_L, clist: CellList, cfg: CellListConfig, W,
              bi=I_BLOCK):
    """The two-run hull of every i-block and the window flag.

    Returns ``(hull, flag, W)``: ``hull`` (XY, NIB, 4) int32 rows ``(s1,
    c1, s2, count)`` (an empty run starts at NB = the block count and has
    length 0), ``flag`` a 0-d bool tensor (some count > W), and the window
    W clamped to [1, NB]. The overlap bits are split at the largest
    internal gap of clear blocks; a running maximum of the last set index
    gives each bit's predecessor, first-occurrence ``argmax`` the first
    bit and the gap. No host sync."""
    n = pos_loc.shape[0]
    idx, halo = clist.bucket_idx, clist.halo_idx
    XY, Kc = idx.shape
    NB = halo.shape[1] // J_BLOCK
    far = pos_loc.new_full((1,), 1e6)
    z = torch.cat([pos_loc[:, 2], far])
    imin, imax, iact = _block_bounds(z[idx.long()], idx < n, bi)
    jmin, jmax, jact = _block_bounds(z[halo.long()], halo < n, J_BLOCK)

    # the arcs [imin - rc, imax + rc] and [jmin, jmax] meet on the z circle
    # iff the wrapped centre distance is within the half-length sum (exact
    # while the sum < Lz / 2; past that always true, merely conservative);
    # NaNs of empty blocks compare false and the activity masks clear them
    Lz = box_L[2].to(pos_loc.dtype)
    ic, ih = 0.5 * (imin + imax), 0.5 * (imax - imin)
    jc, jh = 0.5 * (jmin + jmax), 0.5 * (jmax - jmin)
    d = ic[:, :, None] - jc[:, None, :]
    d = torch.abs(d - Lz * torch.round(d / Lz))
    thresh = ih[:, :, None] + jh[:, None, :] + float(cfg.r_cut)
    overlap = (((d <= thresh) | (thresh >= 0.5 * Lz))
               & iact[:, :, None] & jact[:, None, :])

    t_idx = torch.arange(NB, dtype=torch.int32, device=pos_loc.device)
    bits = overlap.to(torch.int32)
    any_set = overlap.any(dim=-1)
    lo = torch.argmax(bits, dim=-1).to(torch.int32)
    hi = (NB - 1 - torch.argmax(bits.flip(-1), dim=-1)).to(torch.int32)
    minus1 = torch.full((), -1, dtype=torch.int32, device=pos_loc.device)
    incl = torch.cummax(torch.where(overlap, t_idx, minus1), dim=-1).values
    prev = torch.cat([minus1.expand(XY, Kc // bi, 1), incl[:, :, :-1]],
                     dim=-1)  # the last set index strictly before t
    gap = torch.where(overlap & (prev >= 0), t_idx - prev - 1, minus1)
    g = gap.amax(dim=-1)
    p = torch.argmax(gap, dim=-1).to(torch.int32)
    split = g > 0
    e1 = torch.where(split, p - g - 1, hi)
    zero = torch.zeros((), dtype=torch.int32, device=pos_loc.device)
    s1 = torch.where(any_set, lo, NB)
    c1 = torch.where(any_set, e1 - lo + 1, zero)
    s2 = torch.where(split & any_set, p, NB)
    c2 = torch.where(split & any_set, hi - p + 1, zero)
    count = c1 + c2
    hull = torch.stack([s1, c1, s2, count], dim=-1).to(torch.int32)
    W = max(1, min(int(W), NB))
    return hull.contiguous(), torch.amax(count) > W, W


def zcol_tiles(pos_loc, box_L, clist: CellList, hull, W, rows_per_block):
    """The candidate tiles of the zcol pass, in blocks of i-blocks.

    Yields ``(rows, idx_i, id_j, dxs, r2)``: ``rows`` a slice of the
    (XY NIB) i-blocks, ``idx_i`` (B, 16) their slot ids, ``id_j`` (B, W
    128) the ids of the slots of each i-block's visited j-blocks (visits
    past ``min(count, W)`` point at an all-empty block), the three
    minimum-image displacement components and ``r2`` (B, 16, W 128).
    Empty slots sit at a far position; mask their pairs by id."""
    n = pos_loc.shape[0]
    dev = pos_loc.device
    XY, Kc = clist.bucket_idx.shape
    NB = clist.halo_idx.shape[1] // J_BLOCK
    NIB = hull.shape[1]
    t = torch.arange(W, device=dev)
    s1, c1, s2, cnt = (h.long()[..., None] for h in hull.unbind(-1))
    jb = torch.where(t < c1, s1 + t, s2 + (t - c1))
    jb = torch.where(t < cnt, jb, NB)  # NB: the all-empty block
    halo = torch.cat([clist.halo_idx.view(XY, NB, J_BLOCK),
                      clist.halo_idx.new_full((XY, 1, J_BLOCK), n)], dim=1)
    cols = torch.arange(XY, device=dev)[:, None, None]
    id_j = halo[cols, jb].reshape(XY * NIB, W * J_BLOCK).long()
    idx_i = clist.bucket_idx.view(XY * NIB, -1).long()
    pos_pad = torch.cat([pos_loc, pos_loc.new_full((1, 3), 1e6)])
    box = box_L.to(pos_loc.dtype)
    R = XY * NIB
    for start in range(0, R, rows_per_block):
        rows = slice(start, min(start + rows_per_block, R))
        pi, pj = pos_pad[idx_i[rows]], pos_pad[id_j[rows]]
        dxs, r2 = [], None
        for d in range(3):
            dd = pi[:, :, None, d] - pj[:, None, :, d]
            dd = dd - box[d] * torch.round(dd / box[d])
            dxs.append(dd)
            r2 = dd * dd if r2 is None else r2 + dd * dd
        yield rows, idx_i[rows], id_j[rows], dxs, r2


def rows_per_block(W, itemsize):
    """i-blocks per tile block, so one (B, 16, W 128) tile of
    ``itemsize``-byte values holds about 256 MB (the cell twin's bound)."""
    return max(1, (256 << 20) // (I_BLOCK * W * J_BLOCK * itemsize))


def zcol_pair_force_plain(position, box_L, clist: CellList,
                          cfg: CellListConfig, typeid, charge, eps, sig2,
                          rcut2, vshift, exclusions, kappa: float, W,
                          rows=None):
    """Plain twin of the zcol kernel. Returns (forces (N, 3), e_lj,
    e_ewald_short, window flag); for a replica batch the one-replica twin
    of each replica, stacked ((B, N, 3) and three (B,)). ``rows``: the row
    range of the module note; the i rows outside it drop out of every
    tile."""
    if position.dim() == 3:
        outs = [zcol_pair_force_plain(
            position[r], box_L, replica_list(clist, r), cfg, typeid, charge,
            eps, sig2, rcut2, vshift, exclusions, kappa, W, rows)
            for r in range(position.shape[0])]
        return tuple(torch.stack(x) for x in zip(*outs))
    n = position.shape[0]
    row0, row_end = (0, n) if rows is None else (rows[0], rows[0] + rows[1])
    pos_loc = zcol_local_positions(position, box_L, clist)
    hull, flag, W = zcol_hull(pos_loc, box_L, clist, cfg, W)
    n_types = eps.shape[0]
    features = make_particle_features(typeid, charge, n_types)
    kern = make_fused_cell_kernel(eps, sig2, rcut2, vshift, kappa, n_types)
    rc2 = cfg.r_cut * cfg.r_cut
    XY, Kc = clist.bucket_idx.shape
    f_rows = position.new_zeros((XY * Kc // I_BLOCK, I_BLOCK, 3))
    e_lj = e_ew = position.new_zeros(())
    for tile, idx_i, id_j, dxs, r2 in zcol_tiles(
            pos_loc, box_L, clist, hull, W,
            rows_per_block(W, position.element_size())):
        own_i = (idx_i >= row0) & (idx_i < row_end)  # real rows of the range
        active = (own_i[:, :, None] & (id_j < n)[:, None, :]
                  & (idx_i[:, :, None] != id_j[:, None, :]) & (r2 < rc2))
        excl_i = exclusions[idx_i].long()
        active = active & ~(excl_i[:, :, None, :]
                            == id_j[:, None, :, None]).any(-1)
        r2_safe = torch.where(active, r2, torch.ones_like(r2))
        (el, ee), f_over_r = kern(r2_safe, active, features[idx_i],
                                  features[id_j])
        e_lj = e_lj + torch.sum(torch.where(active, el, 0.0))
        e_ew = e_ew + torch.sum(torch.where(active, ee, 0.0))
        s = torch.where(active, f_over_r, 0.0)
        f_rows[tile] = torch.stack([torch.sum(s * dd, dim=2) for dd in dxs],
                                   dim=-1)
    forces = slot_gather_forces(f_rows.view(XY, Kc, 3), clist.slot_of)
    return forces, 0.5 * e_lj, 0.5 * e_ew, flag


def _check_cuda_inputs(what, position, box_L, clist: CellList,
                       cfg: CellListConfig, **extra):
    """Raise unless every tensor the kernels read is a contiguous CUDA
    tensor of the right dtype and shape; returns (dtype suffix, batch
    shape, n, XY, Kc). ``extra`` maps more argument names to (tensor,
    dtype, shape)."""
    if position.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {position.device}")
    dtype = position.dtype
    if dtype not in _SUFFIX:
        raise TypeError(f"{what}: no kernel for {dtype}")
    if position.dim() not in (2, 3):
        raise ValueError(f"{what}: position must be (N, 3) or (B, N, 3), "
                         f"got {tuple(position.shape)}")
    batch = tuple(position.shape[:-2])
    n = position.shape[-2]
    XY, Kc = clist.bucket_idx.shape[-2:]
    if XY != cfg.total_cells or Kc != cfg.cap or Kc % J_BLOCK != 0:
        raise ValueError(
            f"{what}: column list {(XY, Kc)} does not match the config "
            f"{(cfg.total_cells, cfg.cap)} or its capacity is not a "
            f"multiple of {J_BLOCK}")
    checks = dict(position=(position, dtype, batch + (n, 3)),
                  box_L=(box_L, dtype, (3,)),
                  anchor=(clist.anchor, dtype, batch + (n, 3)),
                  local_anchor=(clist.local_anchor, dtype, batch + (n, 3)),
                  bucket_idx=(clist.bucket_idx, torch.int32,
                              batch + (XY, Kc)),
                  halo_idx=(clist.halo_idx, torch.int32,
                            batch + (XY, 9 * Kc)))
    checks.update(extra)
    for arg, (t, want_dtype, shape) in checks.items():
        if not t.is_cuda or t.dtype != want_dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"{what}: {arg} must be a contiguous CUDA {want_dtype} "
                f"tensor of shape {shape}, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}")
    return _SUFFIX[dtype], batch, n, XY, Kc


def _launch_hull(position, box_L, clist: CellList, cfg: CellListConfig,
                 charge, W):
    """The hull kernel, the launch ``zcol_pair_force`` makes, on a CUDA
    device. Returns ``(hull, flags, loc, W)``: the hull and the window W
    clamped to [1, NB] as ``zcol_hull`` returns them, bit for bit, the
    (XY,) bool flags of the columns whose count exceeds W, and ``loc``
    (N, 4), each slotted particle's local coordinates (the bits of
    ``zcol_local_positions``) and charge, the rows the pair kernel stages
    (a particle without a slot is in no column and its row is never
    written). For a replica batch each gains the leading axis B (one
    launch over B XY columns)."""
    suffix, batch, n, XY, Kc = _check_cuda_inputs(
        "zcol_hull", position, box_L, clist, cfg,
        charge=(charge, position.dtype, (position.shape[-2],)))
    W = max(1, min(int(W), 9 * Kc // J_BLOCK))
    dev = position.device
    hull = torch.empty(batch + (XY, Kc // I_BLOCK, 4), dtype=torch.int32,
                       device=dev)
    flags = torch.empty(batch + (XY,), dtype=torch.bool, device=dev)
    loc = torch.empty(batch + (n, 4), dtype=position.dtype, device=dev)
    lib = _cuda.load("zcol_pair", _SIGNATURES)
    p = _cuda.ptr
    rc = getattr(lib, f"cavmd_zcol_hull_{suffix}")(
        p(position), p(clist.anchor), p(clist.local_anchor), p(box_L),
        p(charge), p(clist.bucket_idx), p(clist.halo_idx), n, XY, Kc, W,
        float(cfg.r_cut), batch[0] if batch else 1, p(hull), p(flags),
        p(loc), _cuda.stream_ptr(dev))
    _cuda.check(rc, "zcol_hull")
    _cuda.count_launch("zcol_hull")
    return hull, flags, loc, W


def zcol_pair_force(position, box_L, clist: CellList, cfg: CellListConfig,
                    typeid, charge, eps, sig2, rcut2, vshift, exclusions,
                    kappa: float, W, rows=None):
    """LJ + Ewald short over the z-sorted column list: the hull and pair
    kernels on a CUDA device (five device operations, no read-back), the
    plain twin on the CPU. ``kappa`` is a host float and ``W`` the visit
    window. Returns (forces (N, 3), e_lj, e_ewald_short, window flag (0-d
    bool)); ``position`` (B, N, 3) with a batched list runs every replica
    in the same launches, and the energies and the flag then are (B,).
    The launchers reject what the kernels do not take (more than 8 types
    or 8 exclusions a particle, a window whose staged rows outgrow a
    block's shared memory) with an error that ``_cuda.check`` raises.
    ``rows=(row0, n_rows)``: the row range of the module note."""
    n = position.shape[-2]
    row0, n_rows = (0, n) if rows is None else (int(r) for r in rows)
    if row0 < 0 or n_rows < 1 or row0 + n_rows > n:
        raise ValueError(f"zcol_pair: rows {rows} outside {n} rows")
    if position.device.type == "cpu":
        return zcol_pair_force_plain(position, box_L, clist, cfg, typeid,
                                     charge, eps, sig2, rcut2, vshift,
                                     exclusions, kappa, W, rows)
    dtype = position.dtype
    ntypes = eps.shape[0]
    max_excl = exclusions.shape[1]
    tables = dict(typeid=(typeid, torch.int32, (n,)),
                  charge=(charge, dtype, (n,)),
                  eps=(eps, dtype, (ntypes, ntypes)),
                  sig2=(sig2, dtype, (ntypes, ntypes)),
                  rcut2=(rcut2, dtype, (ntypes, ntypes)),
                  vshift=(vshift, dtype, (ntypes, ntypes)),
                  exclusions=(exclusions, torch.int32, (n + 1, max_excl)))
    suffix, batch, n, XY, Kc = _check_cuda_inputs(
        "zcol_pair", position, box_L, clist, cfg, **tables)
    forces = torch.zeros_like(position)
    hull, flags, loc, W = _launch_hull(position, box_L, clist, cfg, charge, W)
    partial = torch.empty(batch + (XY * (Kc // I_BLOCK), 2), dtype=dtype,
                          device=position.device)
    lib = _cuda.load("zcol_pair", _SIGNATURES)
    p = _cuda.ptr
    rc = getattr(lib, f"cavmd_zcol_pair_{suffix}")(
        p(loc), p(box_L), p(typeid), p(eps), p(sig2), p(rcut2), p(vshift),
        ntypes, p(clist.bucket_idx), p(clist.halo_idx), p(hull), p(exclusions),
        max_excl, n, XY, Kc, W, float(cfg.r_cut), cfg.r_cut * cfg.r_cut,
        float(kappa), row0, row0 + n_rows, batch[0] if batch else 1,
        p(forces), p(partial), _cuda.stream_ptr(position.device))
    name = "zcol_pair" if rows is None else "zcol_pair_rows"
    _cuda.check(rc, name)
    _cuda.count_launch(name)
    energies = torch.sum(partial, dim=-2)  # the kernel halved each partial
    return forces, energies[..., 0], energies[..., 1], flags.any(dim=-1)
