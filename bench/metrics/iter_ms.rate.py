"""iter_ms.rate: the mean time of the engine iterations the driver ran in
the window (an idle wait for the next arrival counts as an iteration);
with no trace, the window over the iterations.  A traced run leaves out
the iterations that overlap the profiler's hold on the host
(``host_skip``)."""


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["iters"]:
        return None
    skip = ctx.get("host_skip")
    kept = [d for d, e in zip(ctx["iters"], ctx["iter_ends"])
            if skip is None or e <= skip[0] or e - d >= skip[1]]
    if not kept:
        return None
    return sum(kept) / len(kept) * 1e3
