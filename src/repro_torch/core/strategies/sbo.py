"""Single-batch overlap (paper Table 2 'SBO'; LongCat-style).

No batch split: reorder the plan so every network op is issued as early
as its dependencies allow and independent compute/memory ops are placed
between the collective and its first consumer — the program order an
asynchronous collective needs to overlap with compute.  Captures the paper's Fig. 1a pattern (shared expert ∥ dispatch)
and the ZeRO weight-gather prefetch without touching model code.
"""
from ..graph import FULL
from ..scheduler import OpSchedulerBase


class SingleBatchOverlap(OpSchedulerBase):
    name = "sbo"

    def schedule(self, ctx):
        g = ctx.graph
        while True:
            ready = ctx.get_ready_ops(FULL)
            if not ready:
                break
            nets = [h for h in ready if ctx.resource_of(h) == "network"]
            rest = [h for h in ready if ctx.resource_of(h) != "network"]
            if nets:
                # issue EVERY ready collective back-to-back (weight
                # gathers, dispatch a2a, ...) so later ones see the whole
                # downstream compute chain as their overlap window, then
                # fill with the ready non-dependent compute
                blocked = set()
                for h in nets:
                    ctx.execute(h)
                    blocked |= set(g.nodes[h.oid].outputs)
                for h in rest:
                    if not (set(g.nodes[h.oid].inputs) & blocked):
                        ctx.execute(h)
            elif rest:
                ctx.execute(rest[0])
