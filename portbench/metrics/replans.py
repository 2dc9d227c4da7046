"""Re-plans inside the window: each chunk whose list overflowed (or, on
the slab path, whose coverage check fired) grows the capacity or halves
the rebuild cadence and runs again (the facade's and the CLI's rule, run
by the harness)."""

UNIT = "count"
LAYER = "Overflow retry: simulation.py rule, run by the harness"
SOURCE = "program_counter"
MOVES = "ns_per_day"


def read(ctx):
    return float(ctx.replans)
