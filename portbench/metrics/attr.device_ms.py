"""attribute merge (ops/cuda_attr.py, csrc/attr_merge.cu, csrc/attr_merge_bwd.cu):
K3f and K4b's halves."""
from portbench.layers import device_ms

PATTERNS = ("attr_merge_kernel", "attr_dw_kernel", "attr_scatter_kernel",
            "attr_scatter_long_kernel")


def read(ctx):
    return device_ms(ctx, PATTERNS)
