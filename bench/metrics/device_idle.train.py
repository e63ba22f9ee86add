"""device_idle.train: the share of the traced steps (a synchronise
before and after) in which no operation ran on the device."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "train" or tr is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
