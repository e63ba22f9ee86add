"""mfu.sat: model FLOPs served in the window over the window times the
chip's bf16 peak.  A prompt counts when the driver saw it leave the
queue inside the window, every token when the host saw it inside the
window; the arithmetic is the benchmark's own (bench/harness/flops.py):
2 per weight a token, attention over the real context, no padding."""
from bench.harness import flops


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    t0, t1 = ctx["window"]
    m = ctx["model"]
    total = 0.0
    for r in ctx["requests"]:
        n = len(r["prompt"])
        if r["admitted"] is not None and t0 <= r["admitted"] <= t1:
            total += flops.serve_prompt_flops(m, n)
        for k, t in enumerate(r["emits"]):
            if t0 <= t <= t1:
                total += flops.serve_token_flops(m, n, k)
    return 100.0 * total / (ctx["window_s"] * flops.PEAK_BF16_FLOPS)
