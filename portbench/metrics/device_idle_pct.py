"""device (H100): the share of the untraced window's wall in which the card
had nothing to run: 1 - (device ms a call) / (wall ms a call), the device's
busy time a call (the union of kernels, memsets and copies) from the stretch
that traces the device alone, the wall from the untraced window before it.
Tracing slows the host (the traced stretch itself idles more), not the
kernels, so the untraced wall is the one a user sees."""


def read(ctx):
    busy_ms = ctx.trace.busy_s * 1e3 / ctx.trace.steps
    return 100.0 * (1.0 - busy_ms / ctx.window_ms)
