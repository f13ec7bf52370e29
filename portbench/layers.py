"""What the per-layer metrics share: a layer's kernels are those whose
names hold one of its patterns as a whole identifier (``rows_kernel``
matches ``rows_kernel<...>`` but not ``emit_rows_kernel``)."""
from __future__ import annotations

import re


def matches(kernel: str, patterns) -> bool:
    return any(re.search(rf"(?<![A-Za-z0-9_]){re.escape(p)}(?![A-Za-z0-9_])", kernel)
               for p in patterns)


def device_ms(ctx, patterns=None, exclude=None) -> float | None:
    """Device milliseconds a step of the kernels, memsets and copies that
    match ``patterns`` (None: all), less those matching any pattern list of
    ``exclude``; None where the trace holds none."""
    us, n = 0.0, 0
    for name, (t, c) in ctx.trace.kernels.items():
        if patterns is not None and not matches(name, patterns):
            continue
        if exclude and any(matches(name, p) for p in exclude):
            continue
        us += t
        n += c
    return us / 1e3 / ctx.trace.steps if n else None


def roofline_pct(ctx, patterns, bound) -> float | None:
    """100 x the layer's least time (``bound(renders)``, ms a step) over its
    device ms a step; None where either is missing."""
    ms = device_ms(ctx, patterns)
    least = bound(ctx.work)
    if ms is None or least is None:
        return None
    return 100.0 * least / ms
