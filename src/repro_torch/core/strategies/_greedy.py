"""Shared dependency-aware greedy interleaver.

Emits a plan order where every network op is issued as early as possible
and the gap until its first consumer is filled with *independent* compute
from other micro-batches (or independent sections) — the order an
asynchronous collective needs to overlap with compute.

Selection rule per step, given the set of in-flight collective outputs:
  1. never pick an op consuming an in-flight tensor if an alternative
     exists (it would close the overlap window),
  2. with a collective in flight prefer compute/memory ops (fill the
     window); otherwise prefer issuing the next network op,
  3. tie-break by (oid, micro-batch) for determinism.
"""
from __future__ import annotations


def greedy_overlap(ctx, parts, within=None):
    """Schedule all remaining ops of ``parts`` (micro-batch ids), restricted
    to oids in ``within`` when given."""
    g = ctx.graph
    inflight: set = set()          # {(tid, mb)} produced by issued collectives

    def ins_of(h):
        return {(t, h.mb) for t in g.nodes[h.oid].inputs}

    def net_outs(h):
        """Outputs that are true collective payloads: for composite units,
        only tensors produced by *network* member ops count (riders from
        fused memory ops don't close an overlap window)."""
        n = g.nodes[h.oid]
        ts = set(n.outputs)
        if n.members:
            ts &= {t for m in n.members if m.resource == "network"
                   for t in m.outputs}
        return {(t, h.mb) for t in ts}

    while True:
        ready = [h for i in parts for h in ctx.get_ready_ops(i)
                 if within is None or h.oid in within]
        if not ready:
            break

        def key(h):
            dep = bool(ins_of(h) & inflight)
            is_net = ctx.resource_of(h) == "network"
            pref = 0 if is_net == (not inflight) else 1
            return (dep, pref, h.oid, h.mb)

        ready.sort(key=key)
        pick = ready[0]
        ctx.execute(pick)
        inflight -= ins_of(pick)
        if ctx.resource_of(pick) == "network":
            inflight |= net_outs(pick)
