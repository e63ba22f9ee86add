"""itl_p95_ms: the 95th percentile of every gap between two consecutive
output tokens of one request, both seen inside the window."""
import numpy as np


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    t0, t1 = ctx["window"]
    gaps = [b - a for r in ctx["requests"]
            for a, b in zip(r["emits"], r["emits"][1:])
            if a >= t0 and b <= t1]
    if not gaps:
        return None
    return float(np.percentile(gaps, 95)) * 1e3
