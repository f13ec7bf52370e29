"""fine backward (ops/cuda_fine_bwd.py, csrc/fine_bwd.cu, csrc/fold_weights.cu)."""
from portbench.layers import device_ms

PATTERNS = ("fine_bwd_runs_kernel", "fine_bwd_slots_kernel", "fold_kernel")


def read(ctx):
    return device_ms(ctx, PATTERNS)
