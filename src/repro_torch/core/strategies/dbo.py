"""Dual-batch overlap (paper Fig. 7a-c, §5.3.2; DeepSeek-V3).

Attention runs as a single merged batch (compute-dense, no benefit from
splitting); the MoE section runs as two micro-batches whose all-to-alls
interleave with the other micro-batch's expert GEMM.  The batch-size
condition is checked at schedule time — the dynamic choice vLLM's static
threshold lacks (paper §5.3.2).
"""
from ..partition import Mark
from ..plan import OpHandle
from ..scheduler import OpSchedulerBase


class DualBatchOverlap(OpSchedulerBase):
    name = "dbo"

    def __init__(self, min_tokens: int = 2048):
        self.min_tokens = min_tokens

    def partition_rules(self):
        from ..partition import SplitFunc
        # keep weight gathers as standalone units so the prefetch hoist
        # can issue them ahead of the whole layer (coalescing them into
        # their consumer destroys the overlap window)
        return [Mark("moe_dispatch"), Mark("moe_combine"),
                Mark("moe_shared"), SplitFunc(r"gather")]

    def schedule(self, ctx):
        from . import tokens_of
        from ._greedy import greedy_overlap
        g = ctx.graph
        moe = ctx.find(
            r"moe_dispatch|moe_combine|expert_ffn|moe_a2a|moe_shared")
        b = ctx.info.local_batch
        if not moe or tokens_of(ctx.info) < self.min_tokens or b < 2:
            ctx.run_rest_sequential()
            return
        ctx.split([b // 2, b - b // 2])
        region = {h.oid for h in moe}
        lo = min(region)
        # prefetch: issue every dependency-free weight gather (ZeRO/FSDP)
        # up front so the whole layer is its overlap window (§2.1)
        prefetched = set()
        for h in ctx.get_ready_ops(0):
            if (ctx.resource_of(h) == "network"
                    and not g.splittable(h.oid) and h.oid not in region):
                ctx.execute(h)
                prefetched.add(h.oid)
        region_done = False
        for oid in g.topo_order():
            n = g.nodes[oid]
            if oid >= lo and not region_done:
                greedy_overlap(ctx, (0, 1), within=region)
                region_done = True
            if oid in region or oid in prefetched:
                continue
            if g.splittable(oid):
                ctx.execute(tuple(OpHandle(oid, i, n.name) for i in (0, 1)))
            else:
                ctx.execute(OpHandle(oid, 0, n.name))
