"""select (ops/fine.py, ops/cuda_fine.py, csrc/fine_select.cu): K2 and the
global entry's cone-cull glue."""
from portbench.layers import device_ms

PATTERNS = ("fine_select_kernel", "cull_rows_kernel", "block_cones_kernel")


def read(ctx):
    return device_ms(ctx, PATTERNS)
