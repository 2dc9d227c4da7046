"""Share of the untraced window in which no operation ran on the device:
100 (1 - busy time a step x the window's steps / the window's wall time),
the busy time a step being the union of the device intervals of the
chunks traced after the window over their steps. The profiler slows the
host, not the kernels, so the busy time a step holds untraced, while the
traced stretch's own idle share (the result's busy_s over window_s)
mostly measures the tracer. Slightly below 0 where the device ran a
shade faster in the window than in the trace."""

UNIT = "%"
LAYER = "Device: the H100"
SOURCE = "device_trace"
MOVES = "ns_per_day"


def read(ctx):
    tr = ctx.trace
    busy_s = tr.busy_s / tr.steps * ctx.window_steps
    return 100.0 * (1.0 - busy_s / ctx.window_s)
