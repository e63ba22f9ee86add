"""kv_resident_share.sat: the cache's resident tokens over its capacity
(kv_stats), sampled after every iteration of the window, as a mean."""


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["kv_resident"]:
        return None
    return 100.0 * sum(ctx["kv_resident"]) / len(ctx["kv_resident"])
