"""queue_wait_p50_s.rate: the median, over requests due in the window,
of the time from the scheduled arrival to the end of the first engine
iteration after which the request had left the engine's queue.  A traced
run leaves out the requests due while the profiler holds the host
(``host_skip``)."""
import numpy as np


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    t0, t1 = ctx["window"]
    skip = ctx.get("host_skip") or (t1 + 1.0, t1 + 1.0)
    waits = [r["admitted"] - r["due"] for r in ctx["requests"]
             if t0 <= r["due"] <= t1 and r["admitted"] is not None
             and not skip[0] <= r["due"] <= skip[1]]
    if not waits:
        return None
    return float(np.median(waits))
