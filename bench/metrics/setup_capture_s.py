"""setup_capture_s: the seconds of set-up spent capturing CUDA Graphs:
the self seconds of the ``graph.warm`` (the warm-up run on copies of
the state), ``graph.settle`` (synchronize, collect, empty the
allocator's cache) and ``graph.record`` (the capture proper) spans
before the window (``repro_torch.spans``; plans built inside them count
under setup_plan_s).  None where the program has no such spans."""

NAMES = ("graph.warm", "graph.settle", "graph.record")


def read(ctx):
    sp = (ctx.get("stats0") or {}).get("spans")
    if not sp or not any(n in sp for n in NAMES):
        return None
    return sum(sp[n][1] for n in NAMES if n in sp)
