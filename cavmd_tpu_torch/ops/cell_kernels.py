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
the design answers it.

Inputs are the carried ``CellList``, the (T, T) type tables of the dense
kernel (eps, sigma^2, r_cut^2, v_shift), typeid and charge, and the
(N+1, max_excl) exclusion table; ``lj_on`` / ``coul_on`` switch the two
terms. The wrapper runs the plain twin only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises. Launches count as
``cell_pair`` or, when an axis has fewer than 3 cells (the grid of the
TPU's ``fused_cell_pallas``), ``cell_pair_small_grid``.
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
)

_V = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_ARGS = [_V, _V, _V, _V, _V, _V, _V, _V, _I, _V, _V, _V, _I, _I, _I, _I, _D,
         _D, _I, _I, _V, _V, _V]
_SIGNATURES = {"cavmd_cell_pair_f32": _ARGS, "cavmd_cell_pair_f64": _ARGS}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def kernel_name(cfg: CellListConfig) -> str:
    """The launch-count name of the kernel on this grid."""
    return "cell_pair" if min(cfg.ncells) >= 3 else "cell_pair_small_grid"


def cell_pair_force_fused_plain(position, box_L, clist: CellList,
                                cfg: CellListConfig, typeid, charge, eps,
                                sig2, rcut2, vshift, exclusions,
                                kappa: float, lj_on: bool = True,
                                coul_on: bool = True):
    """Plain twin of the cell kernel: the tile path of ``ops/neighbor.py``,
    in blocks of cells sized by ``cell_block_for`` (bounded tile memory).
    Returns (forces (N, 3), e_lj, e_ewald_short)."""
    n_types = eps.shape[0]
    zero = position.new_zeros(())
    if not (lj_on or coul_on):
        return torch.zeros_like(position), zero, zero
    features = make_particle_features(typeid, charge, n_types)
    args = (position, box_L, clist, cfg)
    kw = dict(features=features, exclusions=exclusions,
              cell_block=cell_block_for(cfg, position.element_size()))
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
                          lj_on: bool = True, coul_on: bool = True):
    """Forces and the two pair energies over the cell list: the CUDA
    kernel on a CUDA device, the plain twin on the CPU. ``kappa`` is a host
    float. The launcher rejects what the kernel does not take (more than 8
    types or 8 exclusions a particle, a capacity whose staged rows outgrow
    a block's shared memory) with an error that ``_cuda.check`` raises."""
    if position.device.type == "cpu":
        return cell_pair_force_fused_plain(
            position, box_L, clist, cfg, typeid, charge, eps, sig2, rcut2,
            vshift, exclusions, kappa, lj_on, coul_on)
    if position.device.type != "cuda":
        raise ValueError(
            f"cell_pair_force_fused: unsupported device {position.device}")
    dtype = position.dtype
    if dtype not in _SUFFIX:
        raise TypeError(f"cell_pair_force_fused: no kernel for {dtype}")
    n = position.shape[0]
    C, cap = clist.bucket_idx.shape
    ntypes = eps.shape[0]
    max_excl = exclusions.shape[1]
    if C != cfg.total_cells or cap != cfg.cap:
        raise ValueError(
            f"cell_pair_force_fused: cell list {(C, cap)} does not match "
            f"the config {(cfg.total_cells, cfg.cap)}")
    checks = dict(position=(position, dtype, (n, 3)),
                  box_L=(box_L, dtype, (3,)),
                  typeid=(typeid, torch.int32, (n,)),
                  charge=(charge, dtype, (n,)),
                  eps=(eps, dtype, (ntypes, ntypes)),
                  sig2=(sig2, dtype, (ntypes, ntypes)),
                  rcut2=(rcut2, dtype, (ntypes, ntypes)),
                  vshift=(vshift, dtype, (ntypes, ntypes)),
                  bucket_idx=(clist.bucket_idx, torch.int32, (C, cap)),
                  neighbor_cells=(clist.neighbor_cells, torch.int32, (C, 27)),
                  exclusions=(exclusions, torch.int32, (n + 1, max_excl)))
    for name, (t, want_dtype, shape) in checks.items():
        if not t.is_cuda or t.dtype != want_dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"cell_pair_force_fused: {name} must be a contiguous CUDA "
                f"{want_dtype} tensor of shape {shape}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    lib = _cuda.load("cell_pair", _SIGNATURES)
    forces = torch.zeros_like(position)
    partial = torch.empty((C, 2), dtype=dtype, device=position.device)
    p = _cuda.ptr
    rc = getattr(lib, f"cavmd_cell_pair_{_SUFFIX[dtype]}")(
        p(position), p(box_L), p(typeid), p(charge), p(eps), p(sig2),
        p(rcut2), p(vshift), ntypes, p(clist.bucket_idx),
        p(clist.neighbor_cells), p(exclusions), max_excl, n, C, cap,
        cfg.r_cut * cfg.r_cut, float(kappa), int(bool(lj_on)),
        int(bool(coul_on)), p(forces), p(partial),
        _cuda.stream_ptr(position.device))
    _cuda.check(rc, "cell_pair")
    _cuda.count_launch(kernel_name(cfg))
    energies = 0.5 * torch.sum(partial, dim=0)
    return forces, energies[0], energies[1]
