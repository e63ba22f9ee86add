"""OpGraph IR — the DynaFlow operator graph.

The graph is the unit DynaFlow schedules over.  Nodes are *logical,
coarse-grained operators* (an RMSNorm, an attention, a TP all-reduce), per
the paper's §3.2.1 granularity argument: scheduling individual tensor
arithmetic ops costs more in dispatch/planning than it buys in overlap.

Tensors are symbolic (`TensorRef`): shape/torch dtype plus an optional batch
dimension.  The batch dimension is what `split()` micro-batches along.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

FULL = -1    # sentinel "part" index: the whole (unsplit) batch
VBATCH = -2  # sentinel batch_dim: value *scales with* the micro-batch but has
             # no sliceable batch axis (e.g. MoE dispatch buffers whose
             # capacity is proportional to token count).  Such tensors can be
             # produced/consumed per-micro-batch but never sliced or merged.


@dataclasses.dataclass(frozen=True)
class TensorRef:
    """Symbolic tensor flowing between OpNodes."""

    tid: int
    shape: tuple[int, ...]
    dtype: Any
    batch_dim: Optional[int] = 0  # None => not micro-batch-splittable (weights etc.)
    name: str = ""

    @property
    def nbytes(self) -> int:
        size = 1
        for d in self.shape:
            size *= d
        return size * self.dtype.itemsize

    def part_shape(self, sizes: Sequence[int], mb: int) -> tuple[int, ...]:
        """Shape of micro-batch `mb` under split `sizes`."""
        if self.batch_dim is None or mb == FULL:
            return self.shape
        s = list(self.shape)
        s[self.batch_dim] = sizes[mb]
        return tuple(s)


@dataclasses.dataclass
class OpNode:
    """One schedulable operator.

    ``fn(params, *inputs) -> output | tuple[outputs]`` where ``params`` is
    this op's own parameter subtree (possibly ``None``).
    """

    oid: int
    name: str                      # fully scoped, e.g. "layer/attn/qkv"
    fn: Callable
    inputs: tuple[int, ...]        # tensor ids
    outputs: tuple[int, ...]
    param_paths: tuple[tuple[str, ...], ...] = ()
    resource: str = "compute"      # compute | memory | network
    scope: tuple[str, ...] = ()
    tags: frozenset = frozenset()
    flops: float = 0.0             # rough estimate, for scheduler heuristics
    bytes_moved: float = 0.0
    param_bytes: float = 0.0       # weight bytes this op reads (split penalty)
    members: tuple = ()            # for composite (coalesced) nodes: member OpNodes

    def __repr__(self):  # compact for debugging/plan dumps
        return f"OpNode({self.oid}:{self.name}:{self.resource})"


class OpGraph:
    """A DAG of OpNodes over TensorRefs."""

    def __init__(self):
        self.nodes: dict[int, OpNode] = {}
        self.tensors: dict[int, TensorRef] = {}
        self.producer: dict[int, int] = {}       # tid -> oid
        self.consumers: dict[int, list[int]] = {}  # tid -> [oid]
        self.inputs: dict[str, int] = {}         # graph input name -> tid
        self.outputs: dict[str, int] = {}        # graph output name -> tid
        self._next_tid = 0
        self._next_oid = 0

    # -- construction -----------------------------------------------------
    def new_tensor(self, shape, dtype, batch_dim=0, name="") -> TensorRef:
        t = TensorRef(self._next_tid, tuple(int(d) for d in shape), dtype,
                      batch_dim, name)
        self.tensors[t.tid] = t
        self.consumers.setdefault(t.tid, [])
        self._next_tid += 1
        return t

    def add_input(self, name, shape, dtype, batch_dim=0) -> TensorRef:
        t = self.new_tensor(shape, dtype, batch_dim, name=name)
        self.inputs[name] = t.tid
        return t

    def mark_output(self, name: str, ref: TensorRef):
        self.outputs[name] = ref.tid

    def add_node(self, name, fn, inputs: Sequence[TensorRef],
                 out_refs: Sequence[TensorRef], *, param_paths=(),
                 resource="compute", scope=(), tags=(), flops=0.0,
                 bytes_moved=0.0, param_bytes=0.0, members=()) -> OpNode:
        node = OpNode(
            oid=self._next_oid, name=name, fn=fn,
            inputs=tuple(r.tid for r in inputs),
            outputs=tuple(r.tid for r in out_refs),
            param_paths=tuple(param_paths), resource=resource,
            scope=tuple(scope), tags=frozenset(tags), flops=flops,
            bytes_moved=bytes_moved, param_bytes=param_bytes,
            members=tuple(members))
        self.nodes[node.oid] = node
        self._next_oid += 1
        for r in inputs:
            self.consumers[r.tid].append(node.oid)
        for r in out_refs:
            self.producer[r.tid] = node.oid
        return node

    # -- queries ----------------------------------------------------------
    def topo_order(self) -> list[int]:
        """Topological order of node oids (stable: by insertion order)."""
        return sorted(self.nodes.keys())

    def node_deps(self, oid: int) -> set[int]:
        """Producer nodes this node depends on."""
        return {self.producer[t] for t in self.nodes[oid].inputs
                if t in self.producer}

    def splittable(self, oid: int) -> bool:
        """An op is micro-batch-splittable if any input carries a batch dim."""
        n = self.nodes[oid]
        return any(self.tensors[t].batch_dim is not None for t in n.inputs)

    def validate(self):
        """DAG sanity: every non-input tensor has a producer; no forward refs."""
        input_tids = set(self.inputs.values())
        for oid in self.topo_order():
            n = self.nodes[oid]
            for t in n.inputs:
                if t not in input_tids and t not in self.producer:
                    raise ValueError(f"tensor {t} consumed by {n} has no producer")
                if t in self.producer and self.producer[t] >= oid:
                    raise ValueError(f"graph not topologically ordered at {n}")
        for name, t in self.outputs.items():
            if t not in self.producer and t not in input_tids:
                raise ValueError(f"output {name} never produced")

    def total_flops(self) -> float:
        return sum(n.flops for n in self.nodes.values())

    def pretty(self) -> str:
        lines = []
        for oid in self.topo_order():
            n = self.nodes[oid]
            ins = ",".join(str(t) for t in n.inputs)
            outs = ",".join(str(t) for t in n.outputs)
            lines.append(f"[{oid:3d}] {n.resource:8s} {n.name}  ({ins})->({outs})")
        return "\n".join(lines)
