"""Cell-list LJ + short-range Ewald pair pass: CUDA kernel and plain twin.

``cell_pair_force_fused`` (``csrc/cell_pair.cu``) replaces two TPU kernels
of ``cavmd_tpu/ops/pallas_kernels.py``: the column pass
``_cell_cols_kernel`` / ``_cell_cols_kernel_jsplit`` (wrapper
``fused_cell_cols_pallas``, at least 3 cells per axis) and the gathered
tile pass ``_cell_kernel`` (wrapper ``fused_cell_pallas``, the fallback
when an axis has fewer). It holds the semantics of the XLA tile path
``cavmd_tpu/ops/neighbor.py:cell_pair_force`` with
``make_fused_cell_kernel`` (true erfc, round-half-even minimum image). The
source note in ``cell_pair.cu`` says what bounds it on the H100 and how
the design answers it: the cutoff test first, then the pair term on full
warps from a per-warp queue. Each call is one launch of a block per cell;
a launch of fewer cells than two per SM (the small grid) splits each
cell's i rows over ``row_split`` blocks. The energy partials are per
block, summed here in a fixed order, so two calls give the same bits.

Inputs are the carried ``CellList``, the (T, T) type tables of the dense
kernel (eps, sigma^2, r_cut^2, v_shift), typeid and charge, and the
(N+1, max_excl) exclusion table; ``lj_on`` / ``coul_on`` switch the two
terms. The wrapper runs the plain twin only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises. Launches count as
``cell_pair`` or, when an axis has fewer than 3 cells (the grid of the
TPU's ``fused_cell_pallas``), ``cell_pair_small_grid``.

Positions may carry a leading replica axis, (B, N, 3) with a batched
``CellList`` (``ops/neighbor.py``; replica batching,
``parallel/replicas.py``): one launch then takes every replica (the
replica on ``blockIdx.z``, its own instantiation), the neighbour table,
exclusions, types, charges and LJ tables shared, and the energies come
back (B,), each replica's partials summed in a fixed order. The plain twin
runs the one-replica twin on each replica and stacks the results.

``rows=(row0, n_rows)`` (atom sharding by rows, ``parallel/shard.py``):
the kernel and its twin keep the i rows whose particle id is in ``[row0,
row0 + n_rows)``; the forces stay (N, 3), zero on the other rows, and the
energies are the range's share, so the S ranges of a partition add up to
the full launch. A launch with a row range counts under its kernel's name
with ``_rows`` appended (``cell_pair_rows``, ``cell_pair_small_grid_rows``).

``cell_pair_force_slab`` is the counterpart of a third TPU kernel,
``fused_cell_cols_slab_pallas`` (the tile pass of the slab domain
pipeline, ``parallel/domain.py``): the same kernel launched over the own
cells of a slab's extended grid, with pair keys. Its launches count as
``cell_pair_slab``. A batch over slabs gives each replica its own slab
tables: typeid, charge and pair keys (B, N), exclusions (B, N + 1, E);
the kernel then steps them by replica as it steps the positions. Either
form of the tables (shared or a replica's own) goes to either wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from cavmd_tpu_torch.ops import _cuda
from cavmd_tpu_torch.ops.neighbor import (
    CellList,
    CellListConfig,
    cell_block_for,
    cell_pair_force,
    make_ewald_cell_kernel,
    make_fused_cell_kernel,
    make_lj_cell_kernel,
    make_particle_features,
    replica_list,
)

_V = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_ARGS = [_V, _V, _V, _V, _V, _V, _V, _V, _I, _V, _V, _V, _I, _I, _I, _I, _D,
         _D, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _V, _V, _V, _V]
_SIGNATURES = {"cavmd_cell_pair_f32": _ARGS, "cavmd_cell_pair_f64": _ARGS}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
WARPS_PER_BLOCK = 8  # csrc/cell_pair.cu kThreads / 32


def kernel_name(cfg: CellListConfig) -> str:
    """The launch-count name of the kernel on this grid."""
    return "cell_pair" if min(cfg.ncells) >= 3 else "cell_pair_small_grid"


def row_split(n_cells: int, cap: int, sm_count: int) -> int:
    """Blocks per cell of a launch over ``n_cells`` cells: 1 when the
    launch has at least two blocks per SM, else enough to reach that, but
    no more than one i row per warp of a full bucket."""
    if n_cells >= 2 * sm_count:
        return 1
    return max(1, min(-(-2 * sm_count // n_cells), -(-cap // WARPS_PER_BLOCK)))


def launch_blocks(n_cells: int, cap: int, device, replicas: int = 1) -> int:
    """Blocks (energy partials) a replica of one kernel launch over
    ``n_cells`` cells of each of ``replicas`` replicas on ``device``: the
    row split is reckoned from the whole launch's cells."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return n_cells * row_split(replicas * n_cells, cap, sms)



def cell_pair_force_fused_plain(position, box_L, clist: CellList,
                                cfg: CellListConfig, typeid, charge, eps,
                                sig2, rcut2, vshift, exclusions,
                                kappa: float, lj_on: bool = True,
                                coul_on: bool = True, pair_key=None,
                                row_range=None):
    """Plain twin of the cell kernel: the tile path of ``ops/neighbor.py``,
    in blocks of cells sized by ``cell_block_for`` (bounded tile memory).
    Returns (forces (N, 3), e_lj, e_ewald_short); for a replica batch the
    one-replica twin of each replica, stacked ((B, N, 3), (B,), (B,)), on
    its own rows of the tables that carry the replica axis. ``row_range``:
    the row range ``rows`` of the module note."""
    if position.dim() == 3:
        def rows(t, r, dim):  # replica r's table, or the shared one
            return t[r] if t is not None and t.dim() == dim else t

        outs = [cell_pair_force_fused_plain(
            position[r], box_L, replica_list(clist, r), cfg,
            rows(typeid, r, 2), rows(charge, r, 2), eps, sig2, rcut2,
            vshift, rows(exclusions, r, 3), kappa, lj_on, coul_on,
            rows(pair_key, r, 2), row_range)
            for r in range(position.shape[0])]
        return tuple(torch.stack(x) for x in zip(*outs))
    n_types = eps.shape[0]
    zero = position.new_zeros(())
    if not (lj_on or coul_on):
        return torch.zeros_like(position), zero, zero
    features = make_particle_features(typeid, charge, n_types)
    args = (position, box_L, clist, cfg)
    kw = dict(features=features, exclusions=exclusions,
              cell_block=cell_block_for(cfg, position.element_size()),
              pair_key=pair_key, rows=row_range)
    if lj_on and coul_on:
        kern = make_fused_cell_kernel(eps, sig2, rcut2, vshift, kappa,
                                      n_types)
        f, (e_lj, e_ew) = cell_pair_force(*args, kern, **kw)
        return f, e_lj, e_ew
    if lj_on:
        f, e_lj = cell_pair_force(
            *args, make_lj_cell_kernel(eps, sig2, rcut2, vshift, n_types),
            **kw)
        return f, e_lj, zero
    f, e_ew = cell_pair_force(*args, make_ewald_cell_kernel(kappa, n_types),
                              **kw)
    return f, zero, e_ew


def cell_pair_force_fused(position, box_L, clist: CellList,
                          cfg: CellListConfig, typeid, charge, eps, sig2,
                          rcut2, vshift, exclusions, kappa: float,
                          lj_on: bool = True, coul_on: bool = True,
                          rows=None):
    """Forces and the two pair energies over the cell list: the CUDA
    kernel on a CUDA device, the plain twin on the CPU. ``kappa`` is a host
    float. ``position`` (B, N, 3) with a batched list runs every replica in
    one launch; the energies then are (B,). The launcher rejects what the kernel does not take (more than 8
    types or 8 exclusions a particle, a capacity whose staged rows outgrow
    a block's shared memory) with an error that ``_cuda.check`` raises.
    ``rows=(row0, n_rows)``: the row range of the module note."""
    if position.device.type == "cpu":
        return cell_pair_force_fused_plain(
            position, box_L, clist, cfg, typeid, charge, eps, sig2, rcut2,
            vshift, exclusions, kappa, lj_on, coul_on, row_range=rows)
    return _launch(kernel_name(cfg), position, box_L, clist, cfg, typeid,
                   charge, eps, sig2, rcut2, vshift, exclusions, kappa,
                   lj_on, coul_on, (0, cfg.total_cells), None, rows)


def cell_pair_force_slab(position, box_L, clist: CellList,
                         cfg: CellListConfig, typeid, charge, eps, sig2,
                         rcut2, vshift, exclusions, kappa: float, cells,
                         pair_key):
    """The tile pass of the slab domain pipeline (K7's counterpart):
    LJ + Ewald short over a slab's extended grid ``cfg.ncells = (cxl + 2,
    cy, cz)``, whose x-layers 0 and cxl + 1 hold halo copies of the
    neighbour slabs' edge layers. ``position`` is the (Mtot, 3) table of
    residents and halo copies, raw (per-pair minimum image takes the
    periodic images); ``clist`` has the extended neighbour table (halo
    cells have sentinel rows) and ``exclusions`` the (Mtot + 1, B) local
    ids. ``cells = (first, count)`` is the own-cell range the kernel
    launches blocks for (halo cells have no pairs); ``pair_key`` (Mtot,)
    int32 is the id the self and exclusion tests compare. Returns (forces
    (Mtot, 3), e_lj, e_ewald_short); a halo row's force is zero. A batch
    over slabs, positions (B, Mtot, 3) with a batched ``clist`` and each
    replica's own tables ((B, Mtot) typeid, charge and keys, (B, Mtot + 1,
    B) exclusions), runs in one launch and returns ((B, Mtot, 3), (B,),
    (B,)). The plain twin on the CPU, the kernel (counted
    ``cell_pair_slab``) on CUDA."""
    if position.device.type == "cpu":
        return cell_pair_force_fused_plain(
            position, box_L, clist, cfg, typeid, charge, eps, sig2, rcut2,
            vshift, exclusions, kappa, pair_key=pair_key)
    return _launch("cell_pair_slab", position, box_L, clist, cfg, typeid,
                   charge, eps, sig2, rcut2, vshift, exclusions, kappa, True,
                   True, cells, pair_key)


def _launch(name, position, box_L, clist, cfg, typeid, charge, eps, sig2,
            rcut2, vshift, exclusions, kappa, lj_on, coul_on, cells,
            pair_key, rows=None):
    """Check the inputs, launch the kernel over ``cells = (first, count)``
    (and the i rows ``rows = (row0, n_rows)``, None: all) and count the
    launch as ``name``."""
    if position.device.type != "cuda":
        raise ValueError(
            f"{name}: unsupported device {position.device}")
    dtype = position.dtype
    if dtype not in _SUFFIX:
        raise TypeError(f"{name}: no kernel for {dtype}")
    if position.dim() not in (2, 3):
        raise ValueError(f"{name}: position must be (N, 3) or (B, N, 3), "
                         f"got {tuple(position.shape)}")
    batch = tuple(position.shape[:-2])
    nb = batch[0] if batch else 1
    n = position.shape[-2]
    C, cap = clist.bucket_idx.shape[-2:]
    ntypes = eps.shape[0]
    max_excl = exclusions.shape[-1]
    # a batch over slabs: each replica's own types, charges, keys and
    # exclusion rows, which the kernel steps by replica
    own = batch if batch and typeid.dim() == 2 else ()
    if C != cfg.total_cells or cap != cfg.cap:
        raise ValueError(
            f"{name}: cell list {(C, cap)} does not match the config "
            f"{(cfg.total_cells, cfg.cap)}")
    first, count = (int(x) for x in cells)
    if first < 0 or count < 1 or first + count > C:
        raise ValueError(f"{name}: cell range {cells} outside {C} cells")
    row0, n_rows = (0, n) if rows is None else (int(r) for r in rows)
    if row0 < 0 or n_rows < 1 or row0 + n_rows > n:
        raise ValueError(f"{name}: rows {rows} outside {n} rows")
    checks = dict(position=(position, dtype, batch + (n, 3)),
                  box_L=(box_L, dtype, (3,)),
                  typeid=(typeid, torch.int32, own + (n,)),
                  charge=(charge, dtype, own + (n,)),
                  eps=(eps, dtype, (ntypes, ntypes)),
                  sig2=(sig2, dtype, (ntypes, ntypes)),
                  rcut2=(rcut2, dtype, (ntypes, ntypes)),
                  vshift=(vshift, dtype, (ntypes, ntypes)),
                  bucket_idx=(clist.bucket_idx, torch.int32, batch + (C, cap)),
                  neighbor_cells=(clist.neighbor_cells, torch.int32, (C, 27)),
                  exclusions=(exclusions, torch.int32,
                              own + (n + 1, max_excl)))
    if pair_key is not None:
        checks["pair_key"] = (pair_key, torch.int32, own + (n,))
    for arg, (t, want_dtype, shape) in checks.items():
        if not t.is_cuda or t.dtype != want_dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: {arg} must be a contiguous CUDA {want_dtype} "
                f"tensor of shape {shape}, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}")
    lib = _cuda.load("cell_pair", _SIGNATURES)
    forces = torch.zeros_like(position)
    blocks = launch_blocks(count, cap, position.device, nb)
    partial = torch.empty(batch + (blocks, 2), dtype=dtype,
                          device=position.device)
    p = _cuda.ptr
    rc = getattr(lib, f"cavmd_cell_pair_{_SUFFIX[dtype]}")(
        p(position), p(box_L), p(typeid), p(charge), p(eps), p(sig2),
        p(rcut2), p(vshift), ntypes, p(clist.bucket_idx),
        p(clist.neighbor_cells), p(exclusions), max_excl, n, C, cap,
        cfg.r_cut * cfg.r_cut, float(kappa), int(bool(lj_on)),
        int(bool(coul_on)), first, count, blocks // count, nb,
        n if own else 0, (n + 1) * max_excl if own else 0, row0,
        row0 + n_rows, p(pair_key) if pair_key is not None else None,
        p(forces),
        p(partial), _cuda.stream_ptr(position.device))
    _cuda.check(rc, name)
    _cuda.count_launch(name if rows is None else f"{name}_rows")
    energies = 0.5 * torch.sum(partial, dim=-2)
    return forces, energies[..., 0], energies[..., 1]
