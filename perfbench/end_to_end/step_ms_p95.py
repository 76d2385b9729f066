"""step_ms_p95: the 95th percentile (nearest rank) over every step of the
window of the gap between CUDA events recorded at the end of consecutive
steps, read after the window (ms)."""

import math


def read(ctx):
    gaps = sorted(ctx["step_gaps_ms"])
    if not gaps:
        return None
    return gaps[max(0, math.ceil(0.95 * len(gaps)) - 1)]
