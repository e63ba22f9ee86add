"""setup_plan_s: the seconds of set-up spent building and restoring
plans: the self seconds of the ``plan.build`` and ``plan.restore`` spans
before the window (``repro_torch.spans``; a build inside a graph's
warm-up counts here, not under setup_capture_s).  None where the
program has no such spans."""

NAMES = ("plan.build", "plan.restore")


def read(ctx):
    sp = (ctx.get("stats0") or {}).get("spans")
    if not sp or not any(n in sp for n in NAMES):
        return None
    return sum(sp[n][1] for n in NAMES if n in sp)
