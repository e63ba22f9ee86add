"""Programmable operator scheduling — paper Fig. 6.

``OpSchedulerBase.schedule(ctx)`` is user Python that builds the execution
plan through three primitives:

  * ``ctx.split([bs_1..bs_n])``   — create n micro-batches (local sizes)
  * ``ctx.get_ready_ops(i)``      — control-flow-ready ops of micro-batch i
  * ``ctx.execute(ops, replace_func=...)`` — dispatch; a tuple of the same
    op across all micro-batches merges them; ``replace_func`` substitutes a
    fused kernel; different ops without a kernel fall back to sequential.

The scheduler runs in *record mode* per (graph, context-bucket): decisions
may depend on static context (batch size, seq len, phase, mesh) — exactly
the information the paper's CUDA-graph-compatible mode can condition on.
The recorded plan is validated (every op executed exactly once per
micro-batch, dependencies honoured) and handed to the backend.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Optional, Sequence, Union

from .graph import FULL, OpGraph
from .plan import ExecutionPlan, OpHandle, PlanStep, graph_fingerprint
from .verify import enforce, format_missing
from .verify import verify as run_verify


class ScheduleError(RuntimeError):
    """A schedule violated the recording contract."""


@dataclasses.dataclass
class ScheduleContext:
    """Static context a schedule may condition on (the paper's 'execution
    context': workload, model architecture, hardware)."""

    local_batch: int = 0
    global_batch: int = 0
    seq_len: int = 0
    phase: str = "train"          # train | prefill | decode
    arch: str = ""
    mesh_shape: dict = dataclasses.field(default_factory=dict)
    extra: dict = dataclasses.field(default_factory=dict)


class SchedCtx:
    """The object handed to ``schedule()`` — records the plan."""

    def __init__(self, graph: OpGraph, info: ScheduleContext):
        self.graph = graph
        self.info = info
        self.split_sizes: tuple[int, ...] = ()
        self.steps: list[PlanStep] = []
        # availability: tid -> set of parts available (FULL or mb index)
        self._avail: dict[int, set] = {}
        self._done: dict[int, set] = {}   # oid -> parts executed
        input_tids = set(graph.inputs.values())
        for t in input_tids:
            self._avail[t] = {FULL}
        self._input_tids = input_tids

    # -- paper primitives ---------------------------------------------------
    def split(self, sizes: Sequence[int]):
        if self.steps:
            raise RuntimeError("split() must be called before any execute()")
        if self.split_sizes:
            raise RuntimeError("split() may be called once")
        sizes = tuple(int(s) for s in sizes)
        if self.info.local_batch and sum(sizes) != self.info.local_batch:
            raise ValueError(
                f"split sizes {sizes} must sum to local batch "
                f"{self.info.local_batch}")
        if any(s <= 0 for s in sizes):
            raise ValueError(f"split sizes must be positive: {sizes}")
        self.split_sizes = sizes

    def get_ready_ops(self, i: int = None) -> list[OpHandle]:
        """Ready ops for micro-batch ``i`` (or FULL when unsplit)."""
        part = FULL if not self.split_sizes else i
        if part is None:
            part = FULL
        out = []
        for oid in self.graph.topo_order():
            n = self.graph.nodes[oid]
            if part in self._done.get(oid, set()):
                continue
            if not self.graph.splittable(oid) and part != self._first_part():
                continue  # unsplittable ops belong to the first micro-batch
            if all(self._input_ok(t, part) for t in n.inputs):
                out.append(OpHandle(oid, part, n.name))
        return out

    def execute(self, ops: Union[OpHandle, Sequence[OpHandle]],
                replace_func: Optional[Callable] = None,
                replace_name: str = ""):
        if isinstance(ops, OpHandle):
            ops = (ops,)
        ops = tuple(ops)
        if not ops:
            return
        if replace_func is not None:
            self._record(PlanStep("fused", ops,
                                  replace_name or getattr(replace_func, "__name__", "k"),
                                  replace_func))
            return
        same_op = len({h.oid for h in ops}) == 1
        if len(ops) > 1 and same_op:
            mbs = sorted(h.mb for h in ops)
            if mbs != list(range(len(self.split_sizes))):
                raise ValueError(
                    f"merged execution must cover all micro-batches; got {mbs}")
            self._record(PlanStep("merged", ops))
            return
        # different ops, no kernel: sequential fallback (paper §3.2.2)
        for h in ops:
            self._record(PlanStep("exec", (h,)))

    # -- conveniences ---------------------------------------------------------
    def handles(self, i: int = None) -> list[OpHandle]:
        """All handles of micro-batch i in topo order (ignores readiness)."""
        part = FULL if not self.split_sizes else (0 if i is None else i)
        return [OpHandle(oid, part if self.graph.splittable(oid)
                         else self._first_part(),
                         self.graph.nodes[oid].name)
                for oid in self.graph.topo_order()]

    def find(self, pattern: str, i: int = None) -> list[OpHandle]:
        return [h for h in self.handles(i)
                if re.search(pattern, self.graph.nodes[h.oid].name)]

    def resource_of(self, h: OpHandle) -> str:
        return self.graph.nodes[h.oid].resource

    def run_rest_sequential(self):
        """Finish everything not yet executed, in topo order."""
        progress = True
        while progress:
            progress = False
            for part in self._parts():
                for h in self.get_ready_ops(part):
                    self.execute(h)
                    progress = True

    # -- internals -------------------------------------------------------------
    def _parts(self):
        return list(range(len(self.split_sizes))) if self.split_sizes else [FULL]

    def _first_part(self):
        return 0 if self.split_sizes else FULL

    def _input_ok(self, tid: int, part) -> bool:
        from .graph import VBATCH
        avail = self._avail.get(tid, set())
        if FULL in avail:
            return True
        ref = self.graph.tensors[tid]
        if part == FULL:
            # consuming merged: need every part present (prealloc merge)
            return (bool(self.split_sizes)
                    and ref.batch_dim not in (None, VBATCH)
                    and avail >= set(range(len(self.split_sizes))))
        if part in avail:
            return True
        return False

    def _record(self, step: PlanStep):
        # tensors produced inside a fused group are satisfied by the kernel
        group_internal = {t for h in step.handles
                          for t in self.graph.nodes[h.oid].outputs} \
            if step.kind == "fused" else set()
        handles = step.handles if step.kind != "merged" else step.handles[:1]
        for h in handles:
            n = self.graph.nodes.get(h.oid)
            if n is None:
                raise ValueError(f"unknown op {h}")
            done = self._done.setdefault(h.oid, set())
            parts = set(self._parts()) if step.kind == "merged" else {h.mb}
            if done & parts:
                raise ScheduleError(f"{h} already executed")
            check_part = FULL if step.kind == "merged" else h.mb
            for t in n.inputs:
                if t in group_internal:
                    continue
                if not self._input_ok(t, check_part):
                    raise ScheduleError(
                        f"dependency violation: {h} needs tensor {t} "
                        f"part {check_part} before it is produced")
            done |= parts
            for t in n.outputs:
                ref = self.graph.tensors[t]
                if step.kind == "merged" or ref.batch_dim is None:
                    p = FULL
                else:
                    p = h.mb
                self._avail.setdefault(t, set()).add(p)
        self.steps.append(step)

    # -- finalize ---------------------------------------------------------------
    def finalize(self) -> ExecutionPlan:
        missing = []
        for oid in self.graph.topo_order():
            need = set(self._parts()) if self.graph.splittable(oid) \
                else {self._first_part()}
            done = self._done.get(oid, set())
            if not (need <= done or FULL in done):
                missing.append((self.graph.nodes[oid].name, need - done))
        if missing:
            raise ScheduleError(
                f"schedule incomplete; {format_missing(missing)}")
        return ExecutionPlan(list(self.steps), self.split_sizes,
                             graph_fingerprint(self.graph))


class OpSchedulerBase:
    """Base class for user schedulers (paper Fig. 6)."""

    name = "base"

    def partition_rules(self) -> list:
        """Graph-partition annotations this strategy wants (paper Fig. 5)."""
        return []

    def schedule(self, ctx: SchedCtx):
        """Default: sequential execution (the paper's fallback mode)."""
        ctx.run_rest_sequential()


def record_plan(graph: OpGraph, scheduler: OpSchedulerBase,
                info: ScheduleContext,
                verify: str = "off") -> ExecutionPlan:
    """Record a plan; ``verify`` runs the static verifier on the result:
    ``"off"`` (default) skips it, ``"warn"`` emits a Python warning on
    error-severity diagnostics, ``"strict"`` raises
    :class:`~repro_torch.core.verify.PlanVerificationError`."""
    ctx = SchedCtx(graph, info)
    scheduler.schedule(ctx)
    plan = ctx.finalize()
    if verify != "off":
        report = run_verify(graph, plan, lint=False)
        enforce(report, verify, what=f"plan from {scheduler.name!r}")
    return plan
