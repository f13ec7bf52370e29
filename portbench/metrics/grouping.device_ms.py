"""grouping of slots by id (csrc/slot_runs.cu), taken by the coarse stage,
the fine backward and the attribute merge's backward."""
from portbench.layers import device_ms

PATTERNS = ("compact_kernel", "count_kernel", "scan_kernel", "scatter_kernel",
            "starts_kernel", "upsweep_kernel")


def read(ctx):
    return device_ms(ctx, PATTERNS)
