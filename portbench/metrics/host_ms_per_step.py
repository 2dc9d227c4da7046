"""The host's own time to issue one step of the batch, untraced: the step
function that ``run_replica_steps`` calls each step, issued on the
window's final state behind a spin kernel so that the device never holds
the host back, median of 7 (``harness.trace.host_ms``). Beside the
device's busy time a step it says how near the host is to setting the
pace. The slab runner steps inside its chunk call (``make_domain_runner``)
and has no step entry that could be issued alone, so the slab cell reads
nothing here."""

UNIT = "ms/step"
LAYER = "Runner: integrate/integrator.py run_steps, parallel/domain.py runner"
SOURCE = "host_clock"
MOVES = "ns_per_day"
WORKLOADS = ["cell100k.b32", "zcol100k.b32"]


def read(ctx):
    from portbench.harness.trace import host_ms

    prog = ctx.program
    if prog.step is None:
        return None
    st = prog.state
    return host_ms(ctx.torch, lambda: prog.step(st))
