"""graph_gap_share.sat: the share of the device's time in the window
with no engine graph on it: 100 × the device seconds between graph
replays over those seconds plus the replays' own, both differenced
across the window (``repro_torch.spans``: CUDA events around each
replay; a replay's gap runs from the previous replay's end to its
start, on the device's clock alone).  A replay's span runs from the
stream reaching its start event, recorded before the graph's launch, to
its last kernel's end, so the launch's latency and the idle between
kernels inside a replay count as in a graph: ``device_idle.sat`` less
this share is that idle.  The spans are those resolved inside the
window, so replays still in flight when ``stats0`` is taken (the driver
takes it before its synchronize) count in it.  None where the program
has no device spans or none ended in the window."""


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    s0, s1 = ctx["stats0"].get("device_spans"), \
        ctx["stats1"].get("device_spans")
    if s0 is None or s1 is None:
        return None
    busy = gap = 0.0
    for k, v in s1.items():
        before = s0.get(k, (0, 0.0, 0.0))
        busy += v[1] - before[1]
        gap += v[2] - before[2]
    if busy <= 0:
        return None
    return 100.0 * gap / (busy + gap)
