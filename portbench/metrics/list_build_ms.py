"""Device time of one build of the batched cell (or z-column) list:
``ForceField.build_cells`` on the window's final batch, five calls under
the profiler, the union of their device intervals over five. The step
builds the list each step and keeps the old one where no atom moved half
the skin, so this is a time a build, not a step."""

UNIT = "ms/build"
LAYER = "Cell list: ops/neighbor.py"
SOURCE = "device_trace"
MOVES = "ns_per_day"
WORKLOADS = ["cell100k.b32", "zcol100k.b32"]


def read(ctx):
    from portbench.harness.trace import busy_ms

    prog = ctx.program
    if prog.mode not in ("cell", "zcol"):
        return None
    st = prog.state
    return busy_ms(ctx.torch, lambda: prog.ff.build_cells(st.position,
                                                           st.box_L))
