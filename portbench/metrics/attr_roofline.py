"""attribute merge: the least time of its work (``roofline.attr_ms``) over
its device ms."""
from portbench import roofline
from portbench.harness import metric_module
from portbench.layers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, metric_module("attr.device_ms").PATTERNS, roofline.attr_ms)
