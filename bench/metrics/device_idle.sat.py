"""device_idle.sat: the share of the traced sub-window of a serving
cell in which no operation ran on the device."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "serve" or tr is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
