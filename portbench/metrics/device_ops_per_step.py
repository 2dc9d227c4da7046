"""Device operations (kernels, copies, fills) a step over the traced
chunks: every device record of the trace over the steps traced, the
chunk's one copy of its observables and the slab path's rebuilds spread
over the steps they serve."""

UNIT = "ops/step"
LAYER = "Runner: integrate/integrator.py run_steps, parallel/domain.py runner"
SOURCE = "device_trace"
MOVES = "ns_per_day"


def read(ctx):
    tr = ctx.trace
    return len(tr.dev) / tr.steps
