"""The pair layer's share of its roofline: the least time the chip needs
for the short-range pairs of the window's final positions over the pair
kernels' device time a step in the trace.

The bound counts the physics, not the implementation, so cell mode, zcol
mode and the slab read the same work: the non-bonded pairs closer than
r_cut in every replica (counted by the benchmark on the final positions)
times OPS_PER_PAIR float32 operations, and each atom's position, type and
charge read once and its force written once. The kernels it sums are
KERNELS."""

UNIT = "%"
LAYER = "Pair kernels: ops/cell_kernels.py, ops/zcol_kernels.py"
SOURCE = "device_trace"
MOVES = "ns_per_day"
KERNELS = ("cell_pair_kernel", "zcol_pair_kernel", "zcol_hull_kernel")
# per pair: displacement 3, minimum image 12 (divide, round, multiply,
# subtract an axis), r^2 5, LJ energy and force magnitude 13, real-space
# Ewald energy and force magnitude 12 (sqrt, erfc, exp one each), the
# force vector 3, both atoms' accumulation 6, the two energies 2
OPS_PER_PAIR = 56


def read(ctx):
    from portbench.harness import work
    from portbench.reference.physics import Topology

    tr = ctx.trace
    t = tr.device_s(KERNELS)
    if t is None:
        return None
    st = ctx.program.state
    top = Topology(ctx.cfg, ctx.scene, ctx.torch.float64, st.position.device)
    n_pairs = work.pairs_inside(top, st.position)
    n_bytes, n_ops = work.pair_work(n_pairs, ctx.replicas * top.N,
                                    st.position.element_size(), OPS_PER_PAIR)
    return 100.0 * work.bound_s(n_bytes, n_ops) / (t / tr.steps)
