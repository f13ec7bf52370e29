"""renderer glue, device side: device ms a step of every kernel, memset and
copy that no other metric's patterns match (the candidate table's gather,
elementwise ops, the loss, the optimizer).  The harness prints their names."""
from portbench.layers import device_ms


def read(ctx):
    return device_ms(ctx, None, exclude=list(ctx.patterns.values()))
