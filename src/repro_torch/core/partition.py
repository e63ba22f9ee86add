"""Graph partitioning — paper Fig. 5 (`SplitFunc`, `SplitModule`, `mark`).

The fine-grained traced graph is carved into *schedulable subgraphs*.
Annotations pin boundaries at logical-operator granularity; everything not
claimed by a rule coalesces into its containing unit (the paper's default:
contiguous code between boundaries becomes one subgraph).

Coalescing groups only *contiguous topological runs* sharing a unit key,
which guarantees the coarse graph stays acyclic.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence

from .graph import OpGraph, OpNode


@dataclasses.dataclass(frozen=True)
class SplitFunc:
    """Split on ops whose scoped name matches ``pattern`` (regex search)."""

    pattern: str

    def unit_key(self, node: OpNode) -> Optional[str]:
        if re.search(self.pattern, node.name):
            return f"func:{node.name}"
        return None


@dataclasses.dataclass(frozen=True)
class SplitModule:
    """Split on every instance of a module class: the instance's whole
    subtree becomes one schedulable unit."""

    target_cls: type

    def unit_key(self, node: OpNode) -> Optional[str]:
        # scope entries are instance names; class info rides in node.tags
        # as "cls:<depth>:<ClassName>" entries recorded at trace time.
        classes = {self.target_cls, *self.target_cls.__subclasses__()}
        want = {f"cls:{i}:{c.__name__}"
                for i in range(len(node.scope)) for c in classes}
        for tag in node.tags:
            if tag in want:
                depth = int(tag.split(":")[1])
                return "mod:" + "/".join(node.scope[: depth + 1])
        return None


@dataclasses.dataclass(frozen=True)
class Mark:
    """Split on a ``with dynaflow.mark(tag):`` block."""

    tag: str

    def unit_key(self, node: OpNode) -> Optional[str]:
        want = "#" + self.tag
        for i, s in enumerate(node.scope):
            if s == want:
                return "mark:" + "/".join(node.scope[: i + 1])
        return None


@dataclasses.dataclass(frozen=True)
class SplitEveryOp:
    """Finest granularity: every traced leaf op is its own unit."""

    def unit_key(self, node: OpNode) -> Optional[str]:
        return f"op:{node.oid}"


def partition(graph: OpGraph, rules: Sequence, default_depth: int = 1) -> OpGraph:
    """Coarsen ``graph`` into schedulable units.

    Each node gets a unit key from the first matching rule, else a default
    key from its scope prefix (depth ``default_depth``).  Contiguous
    same-key topo runs merge into composite nodes.
    """
    order = graph.topo_order()
    keys = []
    for oid in order:
        node = graph.nodes[oid]
        key = None
        for rule in rules:
            key = rule.unit_key(node)
            if key is not None:
                break
        if key is None:
            key = "dflt:" + "/".join(node.scope[:default_depth])
        keys.append(key)

    # contiguous runs
    groups: list[list[int]] = []
    for oid, key in zip(order, keys):
        if groups and keys[order.index(groups[-1][-1])] == key:
            groups[-1].append(oid)
        else:
            groups.append([oid])

    coarse = OpGraph()
    # copy tensors wholesale (tids preserved) so refs stay valid
    coarse.tensors = dict(graph.tensors)
    coarse._next_tid = graph._next_tid
    coarse.inputs = dict(graph.inputs)
    coarse.outputs = dict(graph.outputs)
    for tid in coarse.tensors:
        coarse.consumers[tid] = []

    produced_by_group: dict[int, int] = {}
    out_tids = set(graph.outputs.values())
    for gi, group in enumerate(groups):
        members = [graph.nodes[o] for o in group]
        internal = {t for m in members for t in m.outputs}
        ext_in, seen_in = [], set()
        for m in members:
            for t in m.inputs:
                if t not in internal and t not in seen_in:
                    seen_in.add(t)
                    ext_in.append(t)
        ext_out = []
        consumed_outside = set()
        for m2 in graph.nodes.values():
            if m2.oid not in group:
                consumed_outside.update(m2.inputs)
        for m in members:
            for t in m.outputs:
                if t in consumed_outside or t in out_tids:
                    ext_out.append(t)
        if len(members) == 1:
            m = members[0]
            coarse.nodes[m.oid] = m
            coarse._next_oid = max(coarse._next_oid, m.oid + 1)
            for t in m.inputs:
                coarse.consumers[t].append(m.oid)
            for t in m.outputs:
                coarse.producer[t] = m.oid
            continue
        fn = _composite_fn(members, ext_in, ext_out)
        name = _common_prefix([m.name for m in members]) or members[0].name
        res = _dominant_resource(members)
        node = coarse.add_node(
            name + f"[{len(members)}ops]", fn,
            [coarse.tensors[t] for t in ext_in],
            [coarse.tensors[t] for t in ext_out],
            param_paths=tuple(p for m in members for p in m.param_paths),
            resource=res, scope=members[0].scope,
            flops=sum(m.flops for m in members),
            bytes_moved=sum(m.bytes_moved for m in members),
            param_bytes=sum(m.param_bytes for m in members),
            members=tuple(members))
        # add_node created with fresh oid; ensure ordering: oids must stay
        # topologically increasing — use max member oid as sort basis.
        produced_by_group[gi] = node.oid

    # Re-key composite nodes so topo order (sorted oids) matches group order.
    coarse_nodes = sorted(coarse.nodes.values(),
                          key=lambda n: min(n.outputs) if n.outputs else 0)
    renumbered = OpGraph()
    renumbered.tensors = dict(coarse.tensors)
    renumbered._next_tid = coarse._next_tid
    renumbered.inputs = dict(coarse.inputs)
    renumbered.outputs = dict(coarse.outputs)
    for tid in renumbered.tensors:
        renumbered.consumers[tid] = []
    for n in coarse_nodes:
        renumbered.add_node(
            n.name, n.fn, [renumbered.tensors[t] for t in n.inputs],
            [renumbered.tensors[t] for t in n.outputs],
            param_paths=n.param_paths, resource=n.resource, scope=n.scope,
            tags=n.tags, flops=n.flops, bytes_moved=n.bytes_moved,
            param_bytes=n.param_bytes, members=n.members)
    renumbered.validate()
    return renumbered


def _composite_fn(members: list[OpNode], ext_in: list[int], ext_out: list[int]):
    """Executable for a coalesced unit: run members in topo order."""

    def fn(params_by_path: dict, *inputs):
        env = dict(zip(ext_in, inputs))
        for m in sorted(members, key=lambda n: n.oid):
            p = params_by_path.get(m.param_paths[0]) if m.param_paths else {}
            outs = m.fn(p, *[env[t] for t in m.inputs])
            for t, v in zip(m.outputs, outs):
                env[t] = v
        return tuple(env[t] for t in ext_out)

    fn._composite = True
    return fn


def _dominant_resource(members) -> str:
    flops = sum(m.flops for m in members)
    if any(m.resource == "network" for m in members):
        # a unit containing a collective is network-dominated only if no
        # large compute accompanies it
        if flops < 1e6:
            return "network"
    by = {}
    for m in members:
        by[m.resource] = by.get(m.resource, 0.0) + max(m.flops, m.bytes_moved)
    return max(by, key=by.get) if by else "compute"


def _common_prefix(names: list[str]) -> str:
    if not names:
        return ""
    parts = [n.split("/") for n in names]
    out = []
    for chunk in zip(*parts):
        if all(c == chunk[0] for c in chunk):
            out.append(chunk[0])
        else:
            break
    return "/".join(out)
