"""Flux integration (paper §5.3.5): fused GEMM+AllReduce via
``replace_func``.  Reproduces the paper's negative result — the chunked
collective multiplies per-message latency, so the roofline model shows a
regression at small batch; kept as the rapid-prototyping demonstration."""
import functools

from ..scheduler import OpSchedulerBase
from .fused import flux_fused


class Flux(OpSchedulerBase):
    name = "flux"

    def __init__(self, axis: str = "model", n_chunks: int = 4):
        self.axis = axis
        self.n_chunks = n_chunks

    def pairs(self, g):
        """[linear, psum] pairs: GEMM output feeds only the all-reduce."""
        out = []
        for oid in g.topo_order():
            n = g.nodes[oid]
            if not ("o_proj" in n.name or "mlp_out" in n.name):
                continue
            cons = g.consumers.get(n.outputs[0], [])
            if len(cons) != 1:
                continue
            ar = g.nodes[cons[0]]
            if ar.resource == "network" and "ar_" in ar.name:
                out.append((n.oid, ar.oid))
        return out

    def schedule(self, ctx):
        fn = functools.partial(flux_fused, axis=self.axis,
                               n_chunks=self.n_chunks)
        fused = {}
        for pair in self.pairs(ctx.graph):
            for oid in pair:
                fused[oid] = pair
        done = set()
        while True:
            ready = [h for h in ctx.get_ready_ops() if h.oid not in done]
            if not ready:
                break
            h = ready[0]
            pair = fused.get(h.oid)
            if pair and h.oid == pair[0]:
                handles = [x for x in ctx.handles() if x.oid in pair]
                ctx.execute(tuple(handles), replace_func=fn,
                            replace_name="flux")
                done.update(pair)
            else:
                ctx.execute(h)
                done.add(h.oid)
