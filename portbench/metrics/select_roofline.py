"""select: the least time of its work (``roofline.select_ms``) over its
device ms."""
from portbench import roofline
from portbench.harness import metric_module
from portbench.layers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, metric_module("select.device_ms").PATTERNS, roofline.select_ms)
