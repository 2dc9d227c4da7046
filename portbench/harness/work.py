"""The yardstick of the roofline shares: the chip's peaks and the work a
layer needs, counted from the physics of the inputs and never from the
program's implementation (its candidate sets, its padding).

Peaks: NVIDIA H100 SXM data sheet, at the 700 W limit: 3.35 TB/s of HBM3
and 67 TFLOP/s of float32 outside the tensor cores.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the chip needs: the larger of bytes over the HBM
    rate and float32 operations over the float32 peak."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_OPS_PER_S)


def pairs_inside(top, positions) -> int:
    """Non-bonded pairs (i < j) closer than r_cut, summed over the
    replicas of ``positions`` (R, N, 3)."""
    from portbench.reference.physics import PairList, minimum_image

    total = 0
    for p in positions:
        p = p.to(top.dtype)
        pl = PairList(top, p, 0.0)
        d = minimum_image(p[pl.i] - p[pl.j], top.box)
        total += int(((d * d).sum(-1) < top.r_cut * top.r_cut).sum())
    return total


def pair_work(n_pairs: int, n_atoms: int, itemsize: int, ops_per_pair):
    """(bytes, operations) of the pair layer: each atom's position, type
    and charge read once and its force written once; ``ops_per_pair``
    for each pair inside the cutoff."""
    return itemsize * 8 * n_atoms, n_pairs * ops_per_pair


def stencil_ops(p: int) -> int:
    """One particle's three order-p stencils: u, floor and the
    Cox-de Boor recursion on each axis."""
    return 3 * (5 + 5 * (p * (p + 1) // 2 - 1))


def spread_work(replicas: int, n: int, n_charged: int, mesh, p: int,
                itemsize: int):
    """(bytes, operations) of the charge spread of ``replicas`` replicas:
    positions, charges and the box in, each replica's mesh written once;
    per charged particle its three stencils and p^3 (product, add)
    pairs."""
    n_mesh = mesh[0] * mesh[1] * mesh[2]
    n_bytes = itemsize * (replicas * (3 * n + n_mesh) + n + 3)
    n_ops = replicas * n_charged * (stencil_ops(p) + 2 * p ** 3 + p * p)
    return n_bytes, n_ops
