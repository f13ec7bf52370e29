"""the whole call: the 95th percentile of a fitting step's milliseconds
(CUDA events between calls) in the traced run's untraced window.  The fit
cell's tail swings with the host's speed from run to run, too far for
``step_p95_ms``'s bound; here it is recorded without one."""
import numpy as np


def read(ctx):
    return float(np.percentile(ctx.step_times, 95)) if ctx.step_times else None
