"""decode_rows.sat: rows a decode step served, on average over the
window: the engine's decode_tokens over its decode_steps, both
differenced across the window."""


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    s0, s1 = ctx["stats0"], ctx["stats1"]
    steps = s1["decode_steps"] - s0["decode_steps"]
    if steps <= 0:
        return None
    return (s1["decode_tokens"] - s0["decode_tokens"]) / steps
