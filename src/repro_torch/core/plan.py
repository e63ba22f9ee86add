"""Execution plans — the physical schedule produced by a scheduler.

A plan is the JAX analogue of the stream of ``execute()`` dispatches the
paper's backend consumes: an ordered list of steps, each executing one op
for one micro-batch, a merged execution of one op across all micro-batches,
or a fused group replaced by a custom kernel (``replace_func``).

Plans are recorded once per (graph, context), lowered to a slot IR
(``core/lowering.py``) and realized by ``core/backend.py``; the serve
engine captures each decode tier's whole step as one CUDA Graph.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import weakref
from typing import Callable, Optional

from .graph import FULL, OpGraph

# Version of the structural-key / outer-key schema ("fingerprint v2").
# Bump whenever ``structural_key`` / ``fused_fn_identity`` /
# ``plan_store.outer_key`` / ``strategy_salt`` change shape: persisted
# PlanStore files embed it and refuse to restore across versions
# (core/plan_serde.py).  3, as in the JAX package: the strategy salt is a
# digest of the whole scheduler/policy identity, not a class name.
FINGERPRINT_VERSION = 3

@dataclasses.dataclass(frozen=True)
class OpHandle:
    """An (operator, micro-batch) instance; ``mb == FULL`` when unsplit."""

    oid: int
    mb: int
    name: str = ""

    def __repr__(self):
        tag = "*" if self.mb == FULL else str(self.mb)
        return f"<{self.name}@{tag}>"


@dataclasses.dataclass(frozen=True)
class PlanStep:
    kind: str                       # 'exec' | 'merged' | 'fused'
    handles: tuple[OpHandle, ...]
    replace_name: str = ""          # fingerprint key for fused kernels
    replace_fn: Optional[Callable] = dataclasses.field(
        default=None, compare=False, hash=False)

    def __repr__(self):
        hs = ",".join(repr(h) for h in self.handles)
        extra = f" via {self.replace_name}" if self.replace_name else ""
        return f"{self.kind}({hs}){extra}"


@dataclasses.dataclass
class ExecutionPlan:
    steps: list[PlanStep]
    split_sizes: tuple[int, ...]    # () => no split; local micro-batch sizes
    graph_fingerprint: str = ""

    @property
    def num_mb(self) -> int:
        return len(self.split_sizes) if self.split_sizes else 1

    def fingerprint(self) -> str:
        # memoized, and hashed off one C-repr'd tuple rather than a
        # Python-level __repr__ walk per step: plans are immutable once
        # finalized, and this sits on the PlanStore's per-bucket warm-up
        # path (lower() alone needs it twice — directly and via Alg. 1)
        fp = self.__dict__.get("_fp")
        if fp is not None:
            return fp
        payload = (self.graph_fingerprint, self.split_sizes,
                   tuple((s.kind,
                          tuple((h.oid, h.mb, h.name) for h in s.handles),
                          s.replace_name)
                         for s in self.steps))
        fp = self._fp = hashlib.sha256(
            repr(payload).encode()).hexdigest()[:16]
        return fp

    def pretty(self) -> str:
        lines = [f"split={list(self.split_sizes) or 'off'}"]
        lines += [f"  {i:3d}: {s!r}" for i, s in enumerate(self.steps)]
        return "\n".join(lines)


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: the dtype's bare name, so a
    fingerprint does not depend on how a framework spells its dtypes."""
    return str(dtype).rsplit(".", 1)[-1]


def graph_fingerprint(graph: OpGraph) -> str:
    h = hashlib.sha256()
    for oid in graph.topo_order():
        n = graph.nodes[oid]
        h.update(f"{n.name}|{n.inputs}|{n.outputs}|{n.resource}".encode())
    for name, t in sorted(graph.inputs.items()):
        ref = graph.tensors[t]
        h.update(f"in:{name}:{ref.shape}:{dtype_name(ref.dtype)}".encode())
    return h.hexdigest()[:16]


_PRIM = (str, int, float, bool, bytes, type(None))


def _is_prim(v) -> bool:
    return isinstance(v, _PRIM) or (
        isinstance(v, tuple) and all(isinstance(x, _PRIM) for x in v))


def fused_fn_identity(fn) -> tuple:
    """Stable identity of a function (a fused kernel, a policy predicate):

      * ``functools.partial`` over primitive args/kwargs -> the inner
        fn's identity + those values,
      * plain function (no closure)                      -> module +
        qualname,
      * closure over primitive cells                     -> module +
        qualname + cell values,
      * anything opaque                                  -> ``id(fn)``.
    """
    if isinstance(fn, functools.partial):
        kw = tuple(sorted(fn.keywords.items())) if fn.keywords else ()
        if all(_is_prim(v) for v in fn.args) and \
                all(_is_prim(v) for _, v in kw):
            return ("partial", fused_fn_identity(fn.func), fn.args, kw)
        return ("id", id(fn))
    qual = (getattr(fn, "__module__", ""), getattr(fn, "__qualname__", ""))
    closure = getattr(fn, "__closure__", None)
    if not closure:
        if qual[1] and "<locals>" not in qual[1] and \
                qual[1] != "<lambda>":
            return ("fn",) + qual
        return ("id", id(fn))
    cells = []
    for c in closure:
        v = c.cell_contents
        if not _is_prim(v):
            return ("id", id(fn))
        cells.append(v)
    return ("closure",) + qual + (tuple(cells),)


def scheduler_identity(obj) -> tuple:
    """Stable, hashable identity of a scheduler *or* strategy policy.

    It must separate two strategies that record structurally different
    plans only under some contexts — a class name alone cannot
    (``dynamic_policy(split_tokens=1024)`` vs ``=4096`` agree on small
    buckets and diverge on large ones).  Resolution:

      * anything with an ``identity()`` method (``StrategyPolicy``
        combinators, the dynamic adapter) -> that tuple verbatim, so a
        policy's whole combinator tree enters the identity;
      * a plain scheduler instance -> class module + qualname + every
        primitive public attribute (the constructor knobs: thresholds,
        split counts, fusion axes).

    Non-primitive attributes (sub-scheduler instances, caches) are
    skipped — composites that matter must implement ``identity()``.
    """
    ident = getattr(obj, "identity", None)
    if callable(ident):
        return ident()
    cls = type(obj)
    attrs = tuple(sorted(
        (k, v) for k, v in vars(obj).items()
        if not k.startswith("_") and _is_prim(v)))
    return ("sched", cls.__module__, cls.__qualname__, attrs)


def strategy_salt(obj) -> str:
    """Strategy identity as a short printable salt for the PlanStore
    outer key (``build_forward`` composes it with arch/phase/segment).

    Two different policies never alias cached plans, even where they
    resolve to the same scheduler class for some context; the same policy
    rebuilt in a new process gives the same salt, so persisted artifacts
    stay redeemable (provided its predicates are named functions or
    frozen dataclasses: a lambda falls back to ``id()`` and never
    shares)."""
    ident = scheduler_identity(obj)
    digest = hashlib.sha256(repr(ident).encode()).hexdigest()[:12]
    label = getattr(obj, "name", None) or type(obj).__name__
    return f"{label}:{digest}"


def structural_key(graph: OpGraph, plan: ExecutionPlan) -> tuple:
    """Shape-free structural identity of a (graph, plan) pair, as a
    hashable tuple.

    Covers everything ``specialize`` (core/lowering.py) relies on being
    identical between two lowerings — node wiring, param paths, batch-dim
    placement, step kinds/handles, fused-kernel closure identity
    (``fused_fn_identity``), micro-batch *count* — while excluding
    everything it re-derives per shape bucket: tensor shapes, dtypes and
    the concrete split sizes.  Two plans with equal structural keys lower
    to the same slots, liveness and instruction stream; only slice
    offsets and merge-buffer extents differ.

    A raw tuple rather than a digest: tuple construction + C-level
    hashing is ~3x cheaper than hashing a serialized form.
    ``structural_fingerprint`` wraps it into a printable digest.

    Memoized per (plan, graph) — a plan is recorded against exactly one
    graph; the weakref guard re-walks if a different graph object is
    ever passed with the same plan.
    """
    cached = plan.__dict__.get("_skey")
    if cached is not None and cached[0]() is graph:
        return cached[1]
    nodes = tuple(
        (n.name, n.inputs, n.outputs, n.resource, n.param_paths,
         len(n.members))
        for n in (graph.nodes[oid] for oid in graph.topo_order()))
    bds = tuple(sorted((t, r.batch_dim) for t, r in graph.tensors.items()))
    ins = tuple(sorted(graph.inputs.items()))
    outs = tuple(sorted(graph.outputs.items()))
    steps = tuple(
        (s.kind, tuple((h.oid, h.mb) for h in s.handles), s.replace_name,
         fused_fn_identity(s.replace_fn) if s.replace_fn is not None
         else None)
        for s in plan.steps)
    key = (nodes, bds, ins, outs, len(plan.split_sizes), steps)
    plan._skey = (weakref.ref(graph), key)
    return key


def structural_fingerprint(graph: OpGraph, plan: ExecutionPlan) -> str:
    """Printable digest of ``structural_key`` (logs, error messages)."""
    h = hashlib.sha256(repr(structural_key(graph, plan)).encode())
    return h.hexdigest()[:16]
