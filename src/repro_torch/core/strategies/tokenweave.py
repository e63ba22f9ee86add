"""TokenWeave integration (paper §5.3.4, Fig. 7 bottom).

Finds every [all-reduce -> residual-add -> RMSNorm] chain and replaces it
with the fused RS + add/norm-on-shard + AG kernel.  The paper's runtime
CTA-count knob maps to the fused CUDA kernel's rows per block
(``block_rows``; ceil(tokens / block_rows) blocks), selected here per
batch bucket (the §5.3.4 'up to 12%' adaptive win).
"""
import functools

from ..scheduler import OpSchedulerBase
from .fused import tokenweave_fused


class TokenWeave(OpSchedulerBase):
    name = "tokenweave"

    def __init__(self, axis: str = "model"):
        self.axis = axis

    def triples(self, g):
        """[ar, add, norm] chains: ar out only feeds add; add feeds norm."""
        out = []
        for oid in g.topo_order():
            n = g.nodes[oid]
            if n.resource != "network" or "ar_" not in n.name:
                continue
            cons = g.consumers.get(n.outputs[0], [])
            if len(cons) != 1:
                continue
            add = g.nodes[cons[0]]
            if "add" not in add.name or len(add.inputs) != 2:
                continue
            norms = [g.nodes[c] for c in g.consumers.get(add.outputs[0], [])
                     if "ln_" in g.nodes[c].name or "rmsnorm" in g.nodes[c].name]
            if not norms:
                continue
            out.append((n.oid, add.oid, norms[0].oid))
        return out

    def schedule(self, ctx):
        from . import tokens_of
        # CTA-count analogue: smaller row blocks for small batches
        br = 128 if tokens_of(ctx.info) < 4096 else 256
        fn = functools.partial(tokenweave_fused, axis=self.axis,
                               block_rows=br)
        fused = {}
        for tri in self.triples(ctx.graph):
            for oid in tri:
                fused[oid] = tri
        done = set()
        while True:
            ready = ctx.get_ready_ops()
            ready = [h for h in ready if h.oid not in done]
            if not ready:
                break
            h = ready[0]
            tri = fused.get(h.oid)
            if tri and h.oid == tri[0]:
                handles = [x for x in ctx.handles() if x.oid in tri]
                ctx.execute(tuple(handles), replace_func=fn,
                            replace_name="tokenweave")
                done.update(tri)
            else:
                ctx.execute(h)
                done.add(h.oid)
