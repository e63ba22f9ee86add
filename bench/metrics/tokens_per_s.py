"""tokens_per_s: output tokens the host saw inside the window, over the
window's seconds."""


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    t0, t1 = ctx["window"]
    n = sum(1 for r in ctx["requests"] for t in r["emits"] if t0 <= t <= t1)
    return n / ctx["window_s"]
