"""Comet integration (paper §5.3.6): fused expert-parallel
dispatch/GEMM/combine with chunked communication-computation overlap,
dropped in via ``replace_func`` without forking the framework."""
import functools

from ..scheduler import OpSchedulerBase
from .fused import comet_fused


class Comet(OpSchedulerBase):
    name = "comet"

    def __init__(self, axis: str = "model", n_chunks: int = 4):
        self.axis = axis
        self.n_chunks = n_chunks

    def chains(self, g):
        """[a2a_dispatch, expert_ffn, a2a_combine] chains."""
        out = []
        for oid in g.topo_order():
            n = g.nodes[oid]
            if "moe_a2a_dispatch" not in n.name:
                continue
            ffn = [g.nodes[c] for c in g.consumers.get(n.outputs[0], [])
                   if "expert_ffn" in g.nodes[c].name]
            if not ffn or not ffn[0].param_paths:
                continue   # FSDP-gathered weights: fusion not composed
            comb = [g.nodes[c] for c in g.consumers.get(ffn[0].outputs[0], [])
                    if "moe_a2a_combine" in g.nodes[c].name]
            if not comb:
                continue
            out.append((n.oid, ffn[0].oid, comb[0].oid))
        return out

    def schedule(self, ctx):
        fn = functools.partial(comet_fused, axis=self.axis,
                               n_chunks=self.n_chunks)
        fused = {}
        for tri in self.chains(ctx.graph):
            for oid in tri:
                fused[oid] = tri
        done = set()
        while True:
            ready = [h for h in ctx.get_ready_ops() if h.oid not in done]
            if not ready:
                break
            h = ready[0]
            tri = fused.get(h.oid)
            if tri and h.oid == tri[0]:
                handles = [x for x in ctx.handles() if x.oid in tri]
                ctx.execute(tuple(handles), replace_func=fn,
                            replace_name="comet")
                done.update(tri)
            else:
                ctx.execute(h)
                done.add(h.oid)
