"""Plan-aware overlap model: how much collective time a schedule hides.

The dry-run gives per-(arch × shape) totals; this model explains how the
*plan order* changes exposed time, which is the quantity DynaFlow's
strategies optimize.  An async collective issued at plan position i
overlaps every independent compute/memory step between i and its first
dependent consumer (a collective on its own stream, as NCCL runs one);
whatever the window cannot cover is exposed.

Per-op costs come from the traced graph's flops/bytes estimates and the
hardware model (``hw.py``: one tensor-core pipe, one HBM pipe, one
NVLink pipe), plus a
per-collective launch latency α (ring setup + per-hop latency) that makes
chunked collectives (Flux) pay for their message count — reproducing the
paper's §5.3.5 negative result.

Fused steps are modeled by kind:
  tokenweave — AR becomes RS+AG (same wire bytes) and the add+norm memory
               work shrinks by tp (runs on the scattered shard);
  comet      — the a2a pipeline exposes ~1/n_chunks of the wire time plus
               whatever the expert GEMM cannot cover;
  flux       — chunked GEMM+AR: same wire bytes, n_chunks x the latency.
"""
from __future__ import annotations

import dataclasses

from .. import hw
from ..core.graph import FULL, OpGraph
from ..core.plan import ExecutionPlan, PlanStep

# The canonical constant lives in hw.py, so the whole hardware model is
# calibrated in one place; the ``coll_latency_s`` parameter of
# ``plan_overlap`` calibrates it per fabric.
COLL_LATENCY_S = hw.COLL_LATENCY_S


def _wire_seconds(node, scale: float, bw_scale: float = 1.0,
                  coll_latency_s: float = hw.COLL_LATENCY_S) -> float:
    """NVLink time of a network node; for composite (coalesced) units only
    the network members' bytes travel the wire — the fused memory ops
    (dispatch build etc.) are charged to the HBM pipe separately.
    ``bw_scale`` < 1 models a slower fabric (across nodes — the paper's
    Appendix B low-bandwidth study)."""
    members = node.members or (node,)
    nets = [m for m in members if m.resource == "network"]
    wire = 0.0
    for m in nets:
        payload = m.bytes_moved * scale / 2.0     # in+out counted once
        kind = m.name
        factor = 2.0 if ("ar_" in kind or "allreduce" in kind
                         or "psum" in kind or "embed_ar" in kind) else \
            (0.25 if "a2a" in kind or "all_to_all" in kind else 1.0)
        wire += (payload * factor
                 / (hw.NVLINK_LINKS * hw.NVLINK_BW_PER_LINK * bw_scale)
                 + coll_latency_s)
    return wire


def _local_seconds(node, scale: float) -> float:
    """Compute/memory time of a node's non-network work."""
    members = node.members or (node,)
    t = 0.0
    for m in members:
        if m.resource == "network":
            continue
        t += max(m.flops * scale / hw.PEAK_FLOPS_BF16,
                 m.bytes_moved * scale / hw.HBM_BW)
    return t


def _op_seconds(graph, node, scale: float = 1.0, bw_scale: float = 1.0,
                coll_latency_s: float = hw.COLL_LATENCY_S):
    """(engine, t_total, t_wire) — wire is the collective part only."""
    has_net = node.resource == "network" or (
        node.members and any(m.resource == "network" for m in node.members))
    if has_net:
        w = _wire_seconds(node, scale, bw_scale, coll_latency_s)
        return "nvlink", w + _local_seconds(node, scale), w
    t_c = node.flops * scale / hw.PEAK_FLOPS_BF16
    t_m = node.bytes_moved * scale / hw.HBM_BW
    return ("tensor", t_c, 0.0) if t_c >= t_m else ("hbm", t_m, 0.0)


def _fused_seconds(graph, step: PlanStep, scales, tp: int,
                   bw_scale: float = 1.0,
                   coll_latency_s: float = hw.COLL_LATENCY_S):
    """(engine, t_total, t_wire) for a fused step, by replacement kind."""
    nets = [(h, graph.nodes[h.oid]) for h in step.handles
            if graph.nodes[h.oid].resource == "network"]
    rest = [(h, graph.nodes[h.oid]) for h in step.handles
            if graph.nodes[h.oid].resource != "network"]
    t_wire = sum(_wire_seconds(n, scales[h], bw_scale, coll_latency_s)
                 - coll_latency_s
                 for h, n in nets)
    t_rest = sum(_op_seconds(graph, n, scales[h],
                             coll_latency_s=coll_latency_s)[1]
                 for h, n in rest)
    name = step.replace_name
    if name == "tokenweave":
        # RS + AG (same bytes as AR); elementwise work on 1/tp tokens
        w = t_wire + 2 * coll_latency_s
        return "nvlink", w + t_rest / max(tp, 1), w
    if name == "comet":
        # self-overlapped pipeline: GEMM-dominated, charge compute engine;
        # only the un-hidden wire remains collective
        G = 4
        exposed_wire = (t_wire / G + max(0.0, t_wire * (G - 1) / G - t_rest)
                        + G * 2 * coll_latency_s)
        return "tensor", exposed_wire + t_rest, exposed_wire
    if name == "flux":
        G = 4
        w = t_wire + G * coll_latency_s
        return "nvlink", w + t_rest, w
    w = t_wire + len(nets) * coll_latency_s
    return "nvlink", w + t_rest, w


@dataclasses.dataclass
class OverlapReport:
    t_sequential: float        # every step serialized
    t_overlapped: float        # collectives hidden behind their windows
    coll_total: float
    coll_exposed: float

    @property
    def speedup(self) -> float:
        return self.t_sequential / max(self.t_overlapped, 1e-12)


def plan_overlap(graph: OpGraph, plan: ExecutionPlan, tp: int = 16,
                 extra_weight_read_bytes: float = 0.0,
                 bw_scale: float = 1.0,
                 coll_latency_s: float = hw.COLL_LATENCY_S) -> OverlapReport:
    """Model the plan.  ``extra_weight_read_bytes``: additional HBM reads
    from micro-batch splitting (each extra micro-batch re-reads weights —
    the paper's Fig. 2a penalty), charged to the memory pipe.
    ``coll_latency_s`` calibrates the per-collective launch latency for
    the target fabric (default: the hw.py NVLink figure)."""
    nparts = plan.num_mb
    sizes = plan.split_sizes or (1,)
    total = float(sum(sizes))

    def scale_of(handle, merged):
        if (merged or handle.mb == FULL
                or not graph.splittable(handle.oid)):
            return 1.0
        return sizes[handle.mb] / total

    costs, reads, writes = [], [], []
    for step in plan.steps:
        merged = step.kind == "merged"
        if step.kind == "fused":
            scales = {h: scale_of(h, False) for h in step.handles}
            eng, t, w = _fused_seconds(graph, step, scales, tp, bw_scale,
                                       coll_latency_s)
        else:
            h = step.handles[0]
            eng, t, w = _op_seconds(graph, graph.nodes[h.oid],
                                    scale_of(h, merged), bw_scale,
                                    coll_latency_s)
        costs.append((eng, t, w))
        r, w = set(), set()
        for h in step.handles:
            n = graph.nodes[h.oid]
            mb = FULL if merged else h.mb
            r |= {(t_, mb) for t_ in n.inputs}
            w |= {(t_, mb) for t_ in n.outputs}
        reads.append(r)
        writes.append(w)

    t_seq = sum(t for _, t, _ in costs) \
        + extra_weight_read_bytes / hw.HBM_BW
    coll_total = sum(w for _, _, w in costs)

    # overlap pass: collective i's WIRE time covers steps j in
    # (i, first_dependent); its own local (fused compute) part serializes
    exposed = 0.0
    for i, (_eng, _t, w) in enumerate(costs):
        if w <= 0.0:
            continue
        window = 0.0
        produced = writes[i]
        for j in range(i + 1, len(costs)):
            dep = any((tid, mb) in reads[j] or (tid, FULL) in reads[j]
                      or any((tid, p) in reads[j] for p in range(nparts))
                      for (tid, mb) in produced)
            if dep:
                break
            window += costs[j][1] - costs[j][2]
        exposed += max(0.0, w - window)
    t_over = (sum(t - w for _, t, w in costs)
              + extra_weight_read_bytes / hw.HBM_BW + exposed)
    return OverlapReport(t_seq, t_over, coll_total, exposed)


def split_weight_penalty(graph: OpGraph, nparts: int) -> float:
    """Extra HBM bytes from re-reading weights once per extra micro-batch
    (paper §2.1 Splitting / Fig. 2a)."""
    if nparts <= 1:
        return 0.0
    wbytes = sum(n.param_bytes for n in graph.nodes.values())
    return (nparts - 1) * wbytes
