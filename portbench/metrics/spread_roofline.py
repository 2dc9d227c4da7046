"""K2's share of its roofline: the least time the chip needs to spread
every replica's charges (order-p stencils, each replica's mesh written
once) over the spread kernel's device time a step in the trace."""

UNIT = "%"
LAYER = "PPPM: ops/pppm_kernels.py"
SOURCE = "device_trace"
MOVES = "ns_per_day"
KERNELS = ("spread_kernel",)


def read(ctx):
    import numpy as np

    from portbench.harness import work

    tr = ctx.trace
    t = tr.device_s(KERNELS)
    if t is None:
        return None
    phys = ctx.cfg["physics"]
    n = len(ctx.scene["charge"])
    n_q = int(np.count_nonzero(ctx.scene["charge"]))
    n_bytes, n_ops = work.spread_work(
        ctx.replicas, n, n_q, phys["pppm_mesh"], int(phys["pppm_order"]),
        ctx.program.state.position.element_size())
    return 100.0 * work.bound_s(n_bytes, n_ops) / (t / tr.steps)
