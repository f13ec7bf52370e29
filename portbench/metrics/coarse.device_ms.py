"""coarse stage (ops/coarse.py, ops/cuda_coarse.py, csrc/emit.cu)."""
from portbench.layers import device_ms

PATTERNS = ("emit_rows_kernel", "globals_kernel", "rows_kernel")


def read(ctx):
    return device_ms(ctx, PATTERNS)
