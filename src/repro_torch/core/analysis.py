"""Static data-flow & memory analysis — paper Algorithm 1.

``StaticAnalysis(G, M)`` precomputes, per tensor × micro-batch:
  * reference counts / death sites (lifetime management — dropping the
    env reference at the death site returns the tensor's memory to
    PyTorch's caching allocator), and
  * ``prealloc`` flags: tensors produced per-micro-batch but consumed merged
    get a preallocated contiguous buffer; producers write their slice into
    it in place at production time (zero-copy resharding — no ``cat`` on
    the merge path).

The analysis simulates the plan with the *same* resolution rules the
runtime uses (`resolve_read`), so the two can never disagree.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

from .graph import FULL, OpGraph, TensorRef
from .plan import ExecutionPlan, PlanStep

BUF = "buf"  # env-key tag for a prealloc merge buffer


def resolve_read(avail: set, ref: TensorRef, part: int, nparts: int):
    """How to obtain tensor ``ref`` for micro-batch ``part`` given the set
    of currently available parts.  Returns (mode, key_part):
      ('direct', p)   — env[(tid, p)] as-is
      ('slice', FULL) — slice micro-batch out of the FULL value
      ('assemble', _) — read the completed prealloc buffer (as FULL)
    """
    from .graph import VBATCH
    if part != FULL:
        if part in avail:
            return ("direct", part)
        if FULL in avail:
            if ref.batch_dim is None:
                return ("direct", FULL)
            if ref.batch_dim == VBATCH:
                raise KeyError(
                    f"virtual-batch tensor {ref.tid}({ref.name}) cannot be "
                    f"sliced per-micro-batch; its producer must run per-mb")
            return ("slice", FULL)
        raise KeyError(
            f"tensor {ref.tid}({ref.name}) part {part} unavailable; have {avail}")
    if FULL in avail:
        return ("direct", FULL)
    if nparts and avail >= set(range(nparts)):
        if ref.batch_dim is None or ref.batch_dim == VBATCH:
            raise KeyError(
                f"tensor {ref.tid}({ref.name}) has no sliceable batch dim; "
                f"cannot assemble a merged value from micro-batch parts")
        return ("assemble", None)
    raise KeyError(
        f"tensor {ref.tid}({ref.name}) FULL unavailable; have {avail}")


def step_reads(graph: OpGraph, step: PlanStep, nparts: int):
    """External (tid, part) reads of a plan step, in deterministic order."""
    reads = []
    if step.kind == "fused":
        internal = {t for h in step.handles
                    for t in graph.nodes[h.oid].outputs}
        for h in step.handles:
            for t in graph.nodes[h.oid].inputs:
                if t in internal:
                    continue
                part = h.mb if graph.tensors[t].batch_dim is not None else FULL
                if (t, part) not in reads:
                    reads.append((t, part))
        return reads
    h = step.handles[0]
    node = graph.nodes[h.oid]
    part = FULL if step.kind == "merged" else h.mb
    for t in node.inputs:
        p = part if graph.tensors[t].batch_dim is not None else FULL
        reads.append((t, p))
    return reads


def step_writes(graph: OpGraph, step: PlanStep, nparts: int):
    """(tid, part) outputs a plan step produces."""
    writes = []
    if step.kind == "fused":
        internal_consumers: dict[int, set] = {}
        group = {h.oid for h in step.handles}
        for t, cons in graph.consumers.items():
            internal_consumers[t] = set(cons) - group
        out_tids = set(graph.outputs.values())
        for h in step.handles:
            for t in graph.nodes[h.oid].outputs:
                if internal_consumers.get(t) or t in out_tids:
                    p = h.mb if graph.tensors[t].batch_dim is not None else FULL
                    writes.append((t, p))
        return writes
    h = step.handles[0]
    node = graph.nodes[h.oid]
    part = FULL if step.kind == "merged" else h.mb
    for t in node.outputs:
        p = part if graph.tensors[t].batch_dim is not None else FULL
        writes.append((t, p))
    return writes


@dataclasses.dataclass
class AnalysisResult:
    prealloc: set                      # tids needing a merge buffer
    death: dict                        # env key -> last step index using it
    reads: list                        # per step: [(tid, part, mode, key)]
    writes: list                       # per step: [(tid, part)]
    buffer_bytes: int                  # total prealloc buffer footprint
    n_steps: int
    plan_fingerprint: str = ""         # fingerprint of the analyzed plan
    # (tid, part) -> read count, built once; excluded from eq/repr so
    # rehydrated/replaced results stay comparable without it.
    _ref_counts: Optional[collections.Counter] = dataclasses.field(
        default=None, repr=False, compare=False)

    def ref_count(self, key) -> int:
        """Paper Alg.1 line 4 equivalent (for tests/introspection)."""
        if self._ref_counts is None:
            # lazy fallback for results built without the precomputed
            # table (dataclasses.replace, decoded artifacts)
            object.__setattr__(self, "_ref_counts", collections.Counter(
                (t, p) for step_reads_ in self.reads
                for (t, p, _m, _k) in step_reads_))
        return self._ref_counts[key]


def static_analysis(graph: OpGraph, plan: ExecutionPlan) -> AnalysisResult:
    nparts = plan.num_mb if plan.split_sizes else 0

    # pass 1: find prealloc set (tensors consumed at FULL but produced
    # per-part) by walking the plan once.
    prealloc = set()
    avail1 = {t: {FULL} for t in graph.inputs.values()}
    all_reads, all_writes = [], []
    for step in plan.steps:
        rs = []
        for (t, p) in step_reads(graph, step, nparts):
            mode, key = resolve_read(avail1.get(t, set()), graph.tensors[t],
                                     p, nparts)
            if mode == "assemble":
                prealloc.add(t)
            rs.append((t, p, mode, key))
        all_reads.append(rs)
        ws = step_writes(graph, step, nparts)
        all_writes.append(ws)
        for (t, p) in ws:
            avail1.setdefault(t, set()).add(p)
    # outputs are consumed at FULL by the virtual final step
    final_reads = []
    for _name, t in graph.outputs.items():
        mode, key = resolve_read(avail1.get(t, set()), graph.tensors[t],
                                 FULL, nparts)
        if mode == "assemble":
            prealloc.add(t)
        final_reads.append((t, FULL, mode, key))
    all_reads.append(final_reads)

    # pass 2: death sites.  Key space: (tid, part) values and (tid, BUF).
    death: dict = {}
    for i, rs in enumerate(all_reads):
        for (t, _p, mode, key) in rs:
            if mode == "direct":
                death[(t, key)] = i
            elif mode == "slice":
                death[(t, FULL)] = i
            elif mode == "assemble":
                death[(t, BUF)] = i
    # producers whose value is never read die at production; buffer writes
    # keep the per-part value alive only through the dus.
    for i, ws in enumerate(all_writes):
        for (t, p) in ws:
            death.setdefault((t, p), i)
            if t in prealloc and p != FULL:
                death.setdefault((t, BUF), i)

    buffer_bytes = sum(graph.tensors[t].nbytes for t in prealloc)
    ref_counts = collections.Counter(
        (t, p) for rs in all_reads for (t, p, _m, _k) in rs)
    return AnalysisResult(prealloc, death, all_reads, all_writes,
                          buffer_bytes, len(plan.steps),
                          plan_fingerprint=plan.fingerprint(),
                          _ref_counts=ref_counts)
