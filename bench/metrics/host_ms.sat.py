"""host_ms.sat: the serve engine's host time an iteration, in ms: the
self seconds of every ``serve.*`` span but ``serve.sync`` (the harvest's
wait for the device), over the count of ``serve.step``, both differenced
across the window (``repro_torch.spans``).  The other wait for the
device, ``stage.wait`` (a pinned staging buffer still read by a queued
copy), is no ``serve.*`` span, and self time keeps it out of the spans
that stage.  Spans accrue only while no profiler records, so a traced
run reads the window's untraced part.  None where the program has no
spans or no iteration ran."""


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    s0, s1 = ctx["stats0"].get("spans"), ctx["stats1"].get("spans")
    if s0 is None or s1 is None:
        return None

    def d(name, i):
        return s1.get(name, (0, 0.0))[i] - s0.get(name, (0, 0.0))[i]
    steps = d("serve.step", 0)
    if steps <= 0:
        return None
    host = sum(d(name, 1) for name in s1
               if name.startswith("serve.") and name != "serve.sync")
    return 1e3 * host / steps
