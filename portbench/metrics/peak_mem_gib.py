"""Peak device memory the window allocated: torch.cuda's
max_memory_allocated after a reset at the start of the window."""

UNIT = "GiB"
LAYER = "Device memory"
SOURCE = "program_counter"
MOVES = "ns_per_day"


def read(ctx):
    return ctx.window_peak / 2.0 ** 30
