"""Execution plans — the physical schedule produced by a scheduler.

A plan is the JAX analogue of the stream of ``execute()`` dispatches the
paper's backend consumes: an ordered list of steps, each executing one op
for one micro-batch, a merged execution of one op across all micro-batches,
or a fused group replaced by a custom kernel (``replace_func``).

Plans are recorded once per (graph, context) and realized by the
interpreter in ``core/backend.py``; capture/replay of a recorded plan as
CUDA Graphs is a later step of the port.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Callable, Optional

from .graph import FULL, OpGraph

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
