"""PPPM charge spread and force interpolation: CUDA kernels and plain twins.

``spread_grid`` (kernel 2, ``csrc/pppm_spread.cu``) replaces the TPU kernels
``cavmd_tpu/ops/pppm_pallas.py:_spread_fwd_kernel`` /
``_spread_fwd_kernel_stacked``; ``interpolate_grad`` (kernel 3, same file)
replaces ``_spread_bwd_kernel`` / ``_spread_bwd_kernel_stacked``. The source
notes in the ``.cu`` file say what bounds them on the H100 and how the
design answers it.

Both wrappers run their plain PyTorch twin only for tensors on the CPU; for
a CUDA tensor they launch the kernel or raise. :class:`SpreadGrid` joins
them as the forward and backward of one ``torch.autograd.Function``, so
forces are ``-grad`` of the mesh energy exactly as with the JAX package's
``custom_vjp``.

Positions may carry a leading replica axis, (B, N, 3) (replica batching,
``parallel/replicas.py``): the grid is then (B, Kx, Ky, Kz), one launch
for the batch, the box shared and the charges either shared, (N,), or a
row a replica, (B, N) (a batch over slabs, ``parallel/domain.py``, where
each replica's slab holds other atoms). Kernel 2 takes its global path
for a batch; a batched ``path="tile"`` raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cavmd_tpu_torch.ops import _cuda
from cavmd_tpu_torch.ops.pppm import bspline_stencils, mesh_vector

_V = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    **{f"cavmd_pppm_spread_{s}": [_V, _V, _V, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _V, _V, _V]
       for s in ("f32", "f64")},
    **{f"cavmd_pppm_interpolate_{s}": [_V, _V, _V, _V, _I, _I, _I, _I, _I,
                                       _I, _I, _V, _V]
       for s in ("f32", "f64")},
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# kernel 2's paths (csrc/pppm_spread.cu): by shape, the global mesh, the
# per-block shared-memory tile
SPREAD_PATHS = {"auto": 0, "global": 1, "tile": 2}


def _flat_columns(idx, mesh):
    """(..., N, p, p, p) flat row-major grid indices from per-axis columns
    (..., N, 3, p); with a leading replica axis (B, N, 3, p), replica b's
    indices are offset by b Kx Ky Kz, into the flattened (B, Kx, Ky, Kz)
    grid."""
    Kx, Ky, Kz = mesh
    ix, iy, iz = idx[..., 0, :], idx[..., 1, :], idx[..., 2, :]
    flat = ((ix[..., :, None, None] * Ky + iy[..., None, :, None]) * Kz
            + iz[..., None, None, :])
    if idx.dim() == 4:
        nb = idx.shape[0]
        flat = flat + (torch.arange(nb, device=idx.device)
                       * (Kx * Ky * Kz)).reshape(nb, 1, 1, 1, 1)
    return flat


def spread_grid_plain(position, charge, box_L, order: int, mesh):
    """Plain twin of kernel 2: the (..., Kx, Ky, Kz) charge grid
    ``grid[x, y, z] = sum_i q_i Mx_i(x) My_i(y) Mz_i(z)`` by a p^3 scatter."""
    w, _, idx = bspline_stencils(position, box_L, order, mesh)
    wx, wy, wz = w[..., 0, :], w[..., 1, :], w[..., 2, :]
    vals = ((charge[..., None] * wx)[..., :, None, None]
            * (wy[..., None, :, None] * wz[..., None, None, :]))
    batch = tuple(position.shape[:-2])
    grid = position.new_zeros(int(np.prod(batch + tuple(mesh))))
    grid.index_add_(0, _flat_columns(idx, mesh).reshape(-1), vals.reshape(-1))
    return grid.reshape(batch + tuple(mesh))


def interpolate_grad_plain(ct, position, charge, box_L, order: int, mesh):
    """Plain twin of kernel 3: dE/dr (..., N, 3) from the grid cotangent
    ``ct`` (..., Kx, Ky, Kz), ``dE/dr_d = (K_d / L_d) q sum ct M'(d)
    M(others)``."""
    w, dw, idx = bspline_stencils(position, box_L, order, mesh)
    g = ct.reshape(-1)[_flat_columns(idx, mesh)]  # (..., N, p, p, p)
    wx, wy, wz = w[..., 0, :], w[..., 1, :], w[..., 2, :]
    dx, dy, dz = dw[..., 0, :], dw[..., 1, :], dw[..., 2, :]
    a, b, c = (..., slice(None), None, None), (..., None, slice(None), None), \
        (..., None, None, slice(None))
    terms = (dx[a] * wy[b] * wz[c], wx[a] * dy[b] * wz[c],
             wx[a] * wy[b] * dz[c])
    gsum = torch.stack([torch.sum(g * t, dim=(-3, -2, -1)) for t in terms],
                       dim=-1)
    Ks = mesh_vector(mesh, position)
    return charge[..., None] * gsum * (Ks / box_L.to(position.dtype))


def _check_cuda_inputs(what, tensors, dtype):
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is on {t.device}, not CUDA")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


def _kernel_dtype(position, what):
    if position.dtype not in _SUFFIX:
        raise TypeError(f"{what}: no kernel for {position.dtype}")
    return _SUFFIX[position.dtype]


def _lib():
    return _cuda.load("pppm_spread", _SIGNATURES)


def _batch(position, charge, what):
    """(leading shape, N, replicas, charge stride) of (N, 3) or (B, N, 3)
    positions with (N,) charges (stride 0) or, for a batch, (B, N) charges
    (stride N)."""
    batch = tuple(position.shape[:-2])
    n = position.shape[-2] if position.dim() in (2, 3) else -1
    if n < 0 or position.shape[-1] != 3 \
            or tuple(charge.shape) not in ((n,), batch + (n,)):
        raise ValueError(f"{what}: positions must be (N, 3) or (B, N, 3) "
                         f"with (N,) or (B, N) charges, got "
                         f"{tuple(position.shape)} and {tuple(charge.shape)}")
    return batch, n, batch[0] if batch else 1, n if charge.dim() == 2 else 0


def spread_grid(position, charge, box_L, order: int, mesh):
    """(..., Kx, Ky, Kz) charge grid of positions (..., N, 3) with (N,)
    charges, or for a batch (B, N), a row a replica: kernel 2 on CUDA, the
    plain twin on CPU."""
    if position.device.type == "cpu":
        return spread_grid_plain(position, charge, box_L, order, mesh)
    return spread_grid_cuda(position, charge, box_L, order, mesh)


def spread_grid_cuda(position, charge, box_L, order: int, mesh,
                     path: str = "auto", tile_runs=None):
    """Kernel 2 on CUDA tensors. ``path`` picks the kernel's path: "auto"
    (by shape, as ``spread_grid`` runs it), "global" or "tile" (each held
    on its own by the tests and ``chip_smoke.py``; a replica batch takes
    the global path, and "tile" raises for it). ``tile_runs``, a
    CUDA int32 tensor of one element, gets 1 added for each run of
    particles that a block accumulated in its shared-memory tile."""
    if position.device.type != "cuda":
        raise ValueError(f"spread_grid: unsupported device {position.device}")
    sfx = _kernel_dtype(position, "spread_grid")
    _check_cuda_inputs("spread_grid", dict(position=position, charge=charge,
                                           box_L=box_L), position.dtype)
    batch, n, nb, q_stride = _batch(position, charge, "spread_grid")
    if batch and path == "tile":
        raise ValueError("spread_grid: the tile path takes one replica; a "
                         "replica batch runs the global path")
    Kx, Ky, Kz = mesh
    grid = torch.zeros(batch + tuple(mesh), dtype=position.dtype,
                       device=position.device)
    tiled = None if tile_runs is None else _cuda.ptr(tile_runs)
    rc = getattr(_lib(), f"cavmd_pppm_spread_{sfx}")(
        _cuda.ptr(position), _cuda.ptr(charge), _cuda.ptr(box_L), n, nb,
        q_stride, order, Kx, Ky, Kz, SPREAD_PATHS[path], _cuda.ptr(grid),
        tiled, _cuda.stream_ptr(position.device))
    _cuda.check(rc, "pppm_spread")
    _cuda.count_launch("pppm_spread")
    return grid


def interpolate_grad(ct, position, charge, box_L, order: int, mesh):
    """dE/dr (..., N, 3) from the grid cotangent (..., Kx, Ky, Kz), the
    charges (N,) or (B, N) as for ``spread_grid``: kernel 3 on CUDA, the
    plain twin on CPU."""
    if position.device.type == "cpu":
        return interpolate_grad_plain(ct, position, charge, box_L, order, mesh)
    if position.device.type != "cuda":
        raise ValueError(
            f"interpolate_grad: unsupported device {position.device}")
    sfx = _kernel_dtype(position, "interpolate_grad")
    ct = ct.contiguous()
    _check_cuda_inputs("interpolate_grad", dict(
        ct=ct, position=position, charge=charge, box_L=box_L),
        position.dtype)
    batch, n, nb, q_stride = _batch(position, charge, "interpolate_grad")
    if tuple(ct.shape) != batch + tuple(mesh):
        raise ValueError(f"interpolate_grad: ct shape {tuple(ct.shape)} "
                         f"is not {batch + tuple(mesh)}")
    Kx, Ky, Kz = mesh
    dpos = torch.empty_like(position)
    rc = getattr(_lib(), f"cavmd_pppm_interpolate_{sfx}")(
        _cuda.ptr(ct), _cuda.ptr(position), _cuda.ptr(charge),
        _cuda.ptr(box_L), n, nb, q_stride, order, Kx, Ky, Kz,
        _cuda.ptr(dpos),
        _cuda.stream_ptr(position.device))
    _cuda.check(rc, "pppm_interpolate")
    _cuda.count_launch("pppm_interpolate")
    return dpos


class SpreadGrid(torch.autograd.Function):
    """Charge grid as a function of positions: forward = spread (kernel 2),
    backward = interpolation (kernel 3). ``charge`` and ``box_L`` get no
    gradient (never differentiated in this framework)."""

    @staticmethod
    def forward(ctx, position, charge, box_L, order, mesh):
        ctx.save_for_backward(position, charge, box_L)
        ctx.order = order
        ctx.mesh = mesh
        return spread_grid(position, charge, box_L, order, mesh)

    @staticmethod
    def backward(ctx, ct):
        position, charge, box_L = ctx.saved_tensors
        dpos = interpolate_grad(ct, position, charge, box_L, ctx.order,
                                ctx.mesh)
        return dpos, None, None, None, None


def spread_grid_autograd(position, charge, box_L, order: int, mesh):
    return SpreadGrid.apply(position, charge, box_L, order, tuple(mesh))
