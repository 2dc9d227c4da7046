"""Dense LJ + short-range Ewald pair pass: CUDA kernel and plain twin.

``dense_pair_force`` (kernel 1, ``csrc/pair.cu``) replaces the TPU kernel
``cavmd_tpu/ops/pallas_kernels.py:_pair_kernel`` and holds the semantics of
the XLA function ``cavmd_tpu/ops/lj.py:fused_pair_force`` (true erfc,
round-half-even minimum image). The source note in ``pair.cu`` says what
bounds it on the H100 and how the design answers it.

Inputs are the (T, T) type tables (eps, sigma^2, r_cut^2, v_shift), the
typeid and charge vectors and the two static (N, N) ``uint8`` masks
``lj_active`` / ``coulomb_active`` — 2 bytes per pair. The wrapper runs the
plain twin only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises.

Positions may carry a leading replica axis, (B, N, 3) (replica batching,
``parallel/replicas.py``): one launch then takes every replica, with the
type tables, charges and masks shared, and the energies come back (B,).

``rows=(row0, n_rows)`` (atom sharding by rows, ``parallel/shard.py``)
takes the i rows ``[row0, row0 + n_rows)`` only, against all N j rows:
the forces come back (..., n_rows, 3) and the energies are the range's
share of the pair sums (the shares of a partition of the rows add to the
full energies). The twin slices the same rows. A launch with a row range
counts as ``dense_pair_rows``, the full launch as ``dense_pair``.
"""

from __future__ import annotations

import ctypes

import torch

from cavmd_tpu_torch.ops import _cuda
from cavmd_tpu_torch.ops.lj import fused_pair_terms

_V = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_PAIR_ARGS = [_V, _V, _V, _V, _V, _V, _V, _I, _V, _V, _V, _I, _I, _I, _I, _D,
              _D, _V, _V, _V]
_SIGNATURES = {
    "cavmd_dense_pair_f32": _PAIR_ARGS,
    "cavmd_dense_pair_f64": _PAIR_ARGS,
    "cavmd_dense_pair_blocks": [_I, _I],
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def dense_pair_force_plain(position, box_L, typeid, eps, sig2, rcut2, vshift,
                           charge, lj_active, coulomb_active, kappa: float,
                           coulomb_rc2: float, rows=None):
    """Plain twin of kernel 1. Returns (forces (..., N, 3), e_lj,
    e_ewald_short), the energies of the leading shape (0-d unbatched);
    with ``rows=(row0, n_rows)`` the forces of those i rows (..., n_rows,
    3) and their share of the energies."""
    row0, n_rows = (0, position.shape[-2]) if rows is None else rows
    own = slice(row0, row0 + n_rows)
    tid = typeid.long()
    ti, tj = tid[own, None], tid[None, :]
    qq = charge[own, None] * charge[None, :]
    return fused_pair_terms(
        position, box_L, eps[ti, tj], sig2[ti, tj], rcut2[ti, tj],
        vshift[ti, tj], lj_active[own].bool(), qq,
        coulomb_active[own].bool(), kappa, coulomb_rc2,
        rows=None if rows is None else own,
    )


def launch_blocks(n: int, replicas: int = 1) -> int:
    """Blocks a replica of one kernel launch over ``replicas`` replicas of
    ``n`` i rows (N, or a row range's length): the length of its energy
    partials (``csrc/pair.cu`` sizes the rows a block by the batch's
    rows)."""
    return _cuda.load("pair", _SIGNATURES).cavmd_dense_pair_blocks(
        n, replicas)


def dense_pair_force(position, box_L, typeid, eps, sig2, rcut2, vshift,
                     charge, lj_active, coulomb_active, kappa: float,
                     coulomb_rc2: float, rows=None):
    """Forces and the two pair energies: kernel 1 on CUDA, the plain twin on
    CPU. ``position`` is (N, 3) or a replica batch (B, N, 3); the energies
    take its leading shape. ``kappa`` and ``coulomb_rc2`` are host floats
    (static per force field), so the launch needs no device-to-host read.
    ``rows=(row0, n_rows)``: the i rows of that range only (the module
    note)."""
    if position.device.type == "cpu":
        return dense_pair_force_plain(position, box_L, typeid, eps, sig2,
                                      rcut2, vshift, charge, lj_active,
                                      coulomb_active, kappa, coulomb_rc2,
                                      rows)
    if position.device.type != "cuda":
        raise ValueError(
            f"dense_pair_force: unsupported device {position.device}")
    dtype = position.dtype
    if dtype not in _SUFFIX:
        raise TypeError(f"dense_pair_force: no kernel for {dtype}")
    if position.dim() not in (2, 3):
        raise ValueError("dense_pair_force: position must be (N, 3) or "
                         f"(B, N, 3), got {tuple(position.shape)}")
    batch = tuple(position.shape[:-2])
    n = position.shape[-2]
    row0, n_rows = (0, n) if rows is None else (int(r) for r in rows)
    if row0 < 0 or n_rows < 1 or row0 + n_rows > n:
        raise ValueError(f"dense_pair_force: rows {rows} outside {n} rows")
    ntypes = eps.shape[0]  # the launcher rejects more types than pair.cu holds
    checks = dict(position=(position, dtype, batch + (n, 3)),
                  box_L=(box_L, dtype, (3,)),
                  typeid=(typeid, torch.int32, (n,)),
                  eps=(eps, dtype, (ntypes, ntypes)),
                  sig2=(sig2, dtype, (ntypes, ntypes)),
                  rcut2=(rcut2, dtype, (ntypes, ntypes)),
                  vshift=(vshift, dtype, (ntypes, ntypes)),
                  charge=(charge, dtype, (n,)),
                  lj_active=(lj_active, torch.uint8, (n, n)),
                  coulomb_active=(coulomb_active, torch.uint8, (n, n)))
    for name, (t, want_dtype, shape) in checks.items():
        if not t.is_cuda or t.dtype != want_dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"dense_pair_force: {name} must be a contiguous CUDA "
                f"{want_dtype} tensor of shape {shape}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    lib = _cuda.load("pair", _SIGNATURES)
    forces = position.new_empty(batch + (n_rows, 3))
    nb = batch[0] if batch else 1
    partial = torch.empty(batch + (2, launch_blocks(n_rows, nb)),
                          dtype=dtype, device=position.device)
    p = _cuda.ptr
    rc = getattr(lib, f"cavmd_dense_pair_{_SUFFIX[dtype]}")(
        p(position), p(box_L), p(typeid), p(eps), p(sig2), p(rcut2),
        p(vshift), ntypes, p(charge), p(lj_active), p(coulomb_active), n,
        row0, n_rows, nb, float(kappa), float(coulomb_rc2), p(forces),
        p(partial), _cuda.stream_ptr(position.device))
    _cuda.check(rc, "dense_pair")
    _cuda.count_launch("dense_pair" if rows is None else "dense_pair_rows")
    energies = torch.sum(partial, dim=-1)  # the kernel halves the partials
    return forces, energies[..., 0], energies[..., 1]
