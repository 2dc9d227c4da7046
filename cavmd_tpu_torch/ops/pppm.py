"""PPPM / smooth-PME reciprocal-space Coulomb solver on a 3-D FFT mesh.

Port of ``cavmd_tpu/ops/pppm.py``: order-p cardinal B-spline charge
assignment, Euler-spline influence coefficients, and forces as the exact
gradient of the mesh energy, so the long-range force is strictly
conservative.

The charge spread and its adjoint (force interpolation) are the two CUDA
kernels of ``ops/pppm_kernels.py``, joined as one ``torch.autograd.Function``;
the mesh energy goes through ``torch.fft.rfftn`` and autograd supplies the
grid cotangent, exactly as ``jax.value_and_grad`` does in the JAX package.
The DFT-by-matmul of the JAX package was a TPU layout choice; the half
spectrum (x halved, conjugate rows folded into the influence weights) is
kept, so both packages share one influence table.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def bspline_int_values(p: int) -> np.ndarray:
    """M_p(0..p) — the order-p cardinal B-spline at the integer nodes."""
    cur = np.zeros(3)
    cur[1] = 1.0
    for n in range(3, p + 1):
        nxt = np.zeros(n + 1)
        for k in range(n + 1):
            a = k / (n - 1) * (cur[k] if k <= n - 1 else 0.0)
            b = (n - k) / (n - 1) * (cur[k - 1] if 1 <= k <= n else 0.0)
            nxt[k] = a + b
        cur = nxt
    return cur


def influence_grid(box_L, mesh, order, kappa) -> np.ndarray:
    """Reciprocal influence coefficients c(m) on the full mesh (host-side).

    c(m) = exp(-pi^2 |m~|^2 / kappa^2) / |m~|^2 * prod_d 1/|D_d(m_d)|^2,
    m~_d = m'_d / L_d with m' the signed alias of the FFT index, D_d the
    Euler-spline denominator. m = 0 and denominator zeros are zeroed.
    Energy: E = 1/(2 pi V) * sum_m c(m) |FFT(Q)(m)|^2.
    """
    box_L = np.asarray(box_L, dtype=float)
    Kx, Ky, Kz = mesh
    mp_nodes = bspline_int_values(order)

    def dsq(K):
        m = np.arange(K)
        ks = np.arange(order - 1)
        phase = np.exp(2j * np.pi * np.outer(m, ks) / K)
        return np.abs(phase @ mp_nodes[1:order]) ** 2

    dx, dy, dz = dsq(Kx), dsq(Ky), dsq(Kz)

    def alias(K):
        m = np.arange(K)
        return np.where(m <= K // 2, m, m - K)

    mx = alias(Kx)[:, None, None] / box_L[0]
    my = alias(Ky)[None, :, None] / box_L[1]
    mz = alias(Kz)[None, None, :] / box_L[2]
    m2 = mx**2 + my**2 + mz**2

    denom = dx[:, None, None] * dy[None, :, None] * dz[None, None, :]
    tiny = 1e-12
    with np.errstate(divide="ignore", invalid="ignore"):
        c = np.exp(-np.pi**2 * m2 / kappa**2) / m2 / np.maximum(denom, tiny)
    c[0, 0, 0] = 0.0
    c[denom < tiny] = 0.0
    return c


def half_spectrum_influence(box_L, mesh, order, kappa) -> np.ndarray:
    """(Kx//2+1, Ky, Kz) influence on the x-halved spectrum of a real grid,
    conjugate x rows folded in as a weight of 2 (1 on the self-conjugate
    m_x = 0 and Kx/2 planes) — the JAX package's ``PPPMParams.influence``."""
    c = influence_grid(box_L, mesh, order, kappa)
    Kxh = mesh[0] // 2 + 1
    weights = np.full(Kxh, 2.0)
    weights[0] = 1.0
    if mesh[0] % 2 == 0:
        weights[-1] = 1.0
    return c[:Kxh] * weights[:, None, None]


class PPPMParams(NamedTuple):
    """Precomputed mesh data: half-spectrum influence (Kx//2+1, Ky, Kz),
    splitting parameter and box volume (0-d tensors)."""

    influence: torch.Tensor
    kappa: torch.Tensor
    volume: torch.Tensor

    @staticmethod
    def create(box_L, mesh=(32, 32, 32), order=6, kappa=0.2,
               dtype=torch.float64, device=None):
        box_np = np.asarray(box_L, dtype=float)

        def t(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        return PPPMParams(
            influence=t(half_spectrum_influence(box_np, mesh, order,
                                                float(kappa))),
            kappa=t(kappa),
            volume=t(np.prod(box_np)),
        ), order


def bspline_weights(frac, order: int):
    """Order-p cardinal B-spline weights w_j = M_p(frac + j), j = 0..p-1.

    Cox–de Boor recursion ``M_n(x) = [x M_{n-1}(x) + (n - x) M_{n-1}(x-1)]
    / (n - 1)`` vectorised over the stencil axis. Returns (w, w_prev): the
    order-p weights and the order-(p-1) ones, from which
    ``M_p'(x) = M_{p-1}(x) - M_{p-1}(x - 1)``.
    """
    sh = frac.shape
    x = frac[..., None] + torch.arange(order, dtype=frac.dtype,
                                       device=frac.device)
    w = torch.zeros(sh + (order,), dtype=frac.dtype, device=frac.device)
    w[..., 0] = 1.0
    w_prev = None
    zero = torch.zeros(sh + (1,), dtype=frac.dtype, device=frac.device)
    for n in range(2, order + 1):
        shifted = torch.cat([zero, w[..., :-1]], dim=-1)
        if n == order:
            w_prev = w
        w = (x * w + (n - x) * shifted) / (n - 1)
    return w, w_prev


def mesh_vector(mesh, like, dtype=None):
    """The (3,) mesh sizes as a tensor on ``like``'s device, built by fills
    so that no host-to-device copy (and no stream sync) is needed."""
    return torch.stack([like.new_full((), K, dtype=dtype) for K in mesh])


def bspline_stencils(position, box_L, order: int, mesh):
    """Per-particle, per-axis stencils: weights ``w`` (..., N, 3, p), their
    derivatives ``dw`` w.r.t. the grid coordinate u (..., N, 3, p), and the
    wrapped grid columns ``idx`` (..., N, 3, p) int64, for positions
    (..., N, 3) (a leading replica axis carries through).

    u = (r / L + 1/2) K, base = floor(u), column j = (base - j) mod K with
    weight M_p(frac + j) — the JAX package's convention exactly.
    """
    Ks = mesh_vector(mesh, position)
    u = (position / box_L.to(position.dtype) + 0.5) * Ks
    k0 = torch.floor(u)
    frac = u - k0
    w, w_prev = bspline_weights(frac, order)
    dw = w_prev - torch.cat([torch.zeros_like(w_prev[..., :1]),
                             w_prev[..., :-1]], dim=-1)
    j = torch.arange(order, device=position.device)
    K_long = mesh_vector(mesh, position, dtype=torch.long)
    idx = torch.remainder(k0.long()[..., None] - j, K_long[:, None])
    return w, dw, idx


def mesh_energy(grid, params: PPPMParams):
    """Reciprocal energy of a real (..., Kx, Ky, Kz) charge grid: 0-d for
    one grid, (B,) for a replica batch of grids in one box (one ``rfftn``
    call for the batch, the port of ``pppm_reciprocal_energy_batched``).

    ``rfftn`` over dims (y, z, x) halves the last listed dim, x, matching
    the half-spectrum influence.
    """
    spec = torch.fft.rfftn(grid, dim=(-2, -1, -3))
    power = spec.real * spec.real + spec.imag * spec.imag
    pref = 1.0 / (2.0 * math.pi * params.volume)
    return pref * torch.sum(params.influence * power, dim=(-3, -2, -1))


def pppm_force_and_energy(position, charge, box_L, params: PPPMParams,
                          order: int, mesh):
    """Forces (exact -grad of the mesh energy) and the reciprocal energy.

    The spread and its backward are the kernels of ``ops/pppm_kernels.py``
    (plain twins on the CPU); the mesh-energy gradient is autograd. A
    replica batch, positions (B, N, 3) in one shared box, gives forces
    (B, N, 3) and energies (B,) from one spread, one FFT and one
    interpolation (the port of ``pppm_force_and_energy_batched``; replicas
    with their own boxes are refused once, at ``init_replica_states``).
    """
    from cavmd_tpu_torch.ops.pppm_kernels import spread_grid_autograd

    with torch.enable_grad():
        pos = position.detach().requires_grad_(True)
        grid = spread_grid_autograd(pos, charge, box_L, order, tuple(mesh))
        energy = mesh_energy(grid, params)
        (grad,) = torch.autograd.grad(energy.sum(), pos)
    return -grad, energy.detach()


def pppm_force_and_energy_rows(position, charge, box_L, params: PPPMParams,
                               order: int, mesh, rows: slice, grid_sum):
    """The row split of :func:`pppm_force_and_energy` (atom sharding by
    rows, ``parallel/shard.py``): the particles ``rows`` (a slice of the N
    rows) are spread into a partial mesh (kernel 2), ``grid_sum`` adds the
    ranks' partial meshes (a collective: every rank gets the whole
    mesh), the mesh energy and its gradient with respect to that mesh
    (the mesh potential) follow by autograd, and the backward of this
    rank's own spread with the potential as ``grad_outputs`` (kernel 3)
    gives the rows' forces. Returns (forces of the rows (..., M, 3), the
    reciprocal energy, alike on every rank). Kernel 2 takes a row slice as
    it takes any N: its tile path is right for particles in any order."""
    from cavmd_tpu_torch.ops.pppm_kernels import spread_grid_autograd

    q = charge[..., rows]
    with torch.enable_grad():
        pos = position[..., rows, :].detach().contiguous().requires_grad_(True)
        partial = spread_grid_autograd(pos, q, box_L, order, tuple(mesh))
        grid = grid_sum(partial.detach()).requires_grad_(True)
        energy = mesh_energy(grid, params)
        (potential,) = torch.autograd.grad(energy.sum(), grid)
        (grad,) = torch.autograd.grad(partial, pos, grad_outputs=potential)
    return -grad, energy.detach()


def pppm_reciprocal_energy(position, charge, box_L, params: PPPMParams,
                           order: int, mesh):
    """The reciprocal-space mesh energy alone: 0-d, or (B,) for a replica
    batch (B, N, 3). The grid comes from kernel 2 on the card (the plain
    twin on the CPU), so it is differentiable in ``position``: autograd
    runs kernel 3 backwards, as in :func:`pppm_force_and_energy`."""
    from cavmd_tpu_torch.ops.pppm_kernels import spread_grid_autograd

    return mesh_energy(
        spread_grid_autograd(position, charge, box_L, order, tuple(mesh)),
        params)


def make_pppm_force_energy(order: int, mesh):
    """``fe(position, charge, box_L, params) -> (forces, energy)``:
    :func:`pppm_force_and_energy` at one order and mesh. A replica batch
    needs no rule of its own (the JAX package's ``custom_vmap``): ``fe``
    takes (B, N, 3) positions as they are."""
    def fe(position, charge, box_L, params):
        return pppm_force_and_energy(position, charge, box_L, params, order,
                                     mesh)

    return fe
