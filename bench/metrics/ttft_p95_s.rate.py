"""ttft_p95_s.rate: ttft_p95_s as a traced run reads it, the per-layer
record of the open loop's time-to-first-token tail: the 95th percentile
over every request due inside the window, from its scheduled arrival,
leaving out those due while the profiler holds the host (``host_skip``).
A request that failed, or saw no token by the end of the driver's wait,
counts to the end of that wait."""
import numpy as np


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    t0, t1 = ctx["window"]
    skip = ctx.get("host_skip") or (t1 + 1.0, t1 + 1.0)
    due = [r for r in ctx["requests"] if t0 <= r["due"] <= t1
           and not skip[0] <= r["due"] <= skip[1]]
    if not due:
        return None
    end = ctx["wait_end"]
    ttft = [(r["emits"][0] if r["emits"] and (r["ok"] or r["done"] is None)
             else end) - r["due"] for r in due]
    return float(np.percentile(ttft, 95))
