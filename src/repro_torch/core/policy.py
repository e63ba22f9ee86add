"""First-class strategy policies — programmable per-context selection.

The paper's headline capability is that the *choice* of intra-device
parallelism strategy is itself programmable and context-dependent (§3,
Fig. 6-8): the same logical model runs DBO on a large MoE prefill bucket,
reorder-only SBO on a small one, and plain sequential decode.  This
module makes that choice an API.

A **policy** maps a :class:`ScheduleContext` to a scheduler::

    policy(ctx: ScheduleContext) -> OpSchedulerBase

and carries a stable ``identity()`` that enters the PlanStore outer key
(via ``core.plan.strategy_salt``), so two policies never alias cached or
persisted plans.
Combinators compose policies from schedulers:

    by_phase(prefill=NanoFlow(), decode=Sequential())
    by_token_threshold([(64, Sequential()), (2048, SingleBatchOverlap())],
                       above=NanoFlow())
    first_viable(when(has_ops(r"moe_a2a"), DualBatchOverlap()),
                 default=NanoFlow())

Graph-conditional predicates (``has_ops``) read the segment's traced
graph from ``ctx.extra['graph']`` — ``build_forward`` injects it before
resolving, and ``DynamicScheduler`` injects the partitioned graph when
it defers at schedule time.  Everywhere else the key is simply absent
and graph predicates answer False.

Identity caveat: predicates should be module-level functions or frozen
dataclasses (like ``has_ops``).  A lambda still *works* but its identity
degrades to ``id()`` — such a policy never aliases another, at the cost
of never sharing persisted plans across processes.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

from .plan import fused_fn_identity, scheduler_identity
from .scheduler import OpSchedulerBase, ScheduleContext


def tokens_of(info: ScheduleContext) -> int:
    """Token count of the step — the paper's batch-size split condition."""
    if info.phase == "decode":
        return info.local_batch
    return info.local_batch * max(info.seq_len, 1)


def with_graph(info: ScheduleContext, graph) -> ScheduleContext:
    """Copy of ``info`` whose ``extra['graph']`` carries the segment
    graph, so graph-conditional predicates can see op names."""
    extra = dict(info.extra or {})
    extra["graph"] = graph
    return dataclasses.replace(info, extra=extra)


def _graph_of(ctx: ScheduleContext):
    return (ctx.extra or {}).get("graph")


class StrategyPolicy:
    """Protocol base: resolve a :class:`ScheduleContext` to a scheduler.

    Subclasses implement ``__call__`` (returning an ``OpSchedulerBase``,
    or ``None`` to *decline* — meaningful only inside ``first_viable``)
    and ``identity()`` (a stable hashable tuple; it becomes part of the
    PlanStore outer key, so it must be reproducible across processes).
    ``partition_rules`` is the union over every reachable scheduler —
    partitioning must not depend on which branch a context selects,
    or two contexts of one program would see different graphs.
    """

    name = "policy"

    def __call__(self, ctx: ScheduleContext) -> Optional[OpSchedulerBase]:
        raise NotImplementedError

    def identity(self) -> tuple:
        raise NotImplementedError

    def partition_rules(self) -> list:
        return _union_rules(self.children())

    def children(self) -> list:
        """Sub-policies this combinator can delegate to."""
        return []


def as_policy(obj) -> StrategyPolicy:
    """Normalize a scheduler, policy, or registry name into a policy.

    Names resolve through the strategy registry
    (``core.strategies.registry``): scheduler entries become a
    ``FixedPolicy``; policy entries (``"dynamic"``, ``"auto"``) resolve
    to the policy itself, so ``policy="auto"`` reaches ``api.compile``
    as a live :class:`~repro_torch.core.autotune.AutoPolicy`.  Unknown
    names raise ``UnknownStrategyError`` listing the registered
    choices."""
    if isinstance(obj, StrategyPolicy):
        return obj
    if isinstance(obj, OpSchedulerBase):
        return FixedPolicy(obj)
    if isinstance(obj, str):
        from .strategies.registry import get_entry
        entry = get_entry(obj)
        if entry.policy_factory is not None:
            return as_policy(entry.policy_factory())
        return FixedPolicy(entry.factory())
    raise TypeError(
        f"expected an OpSchedulerBase, StrategyPolicy or strategy name, "
        f"got {type(obj).__name__}")


def resolve_strategy(policy_or_scheduler, info: ScheduleContext,
                     graph=None) -> OpSchedulerBase:
    """Resolve to a concrete scheduler for one context (and optionally
    one segment graph).  A top-level policy may not decline."""
    policy = as_policy(policy_or_scheduler)
    ctx = with_graph(info, graph) if graph is not None else info
    sched = policy(ctx)
    if sched is None:
        raise ValueError(
            f"policy {policy.name!r} declined to schedule context "
            f"{info.phase}/{tokens_of(info)} tokens; give first_viable a "
            "default= scheduler")
    return sched


def _union_rules(policies) -> list:
    rules, seen = [], set()
    for p in policies:
        for r in p.partition_rules():
            key = repr(r)
            if key not in seen:
                seen.add(key)
                rules.append(r)
    return rules


def _identity_of(policy: StrategyPolicy) -> tuple:
    return policy.identity()


class FixedPolicy(StrategyPolicy):
    """Always the one scheduler — how bare schedulers enter policy-land."""

    def __init__(self, scheduler: OpSchedulerBase):
        self.scheduler = scheduler
        self.name = getattr(scheduler, "name", type(scheduler).__name__)

    def __call__(self, ctx):
        return self.scheduler

    def identity(self):
        return ("fixed", scheduler_identity(self.scheduler))

    def partition_rules(self):
        return list(self.scheduler.partition_rules())


class PolicyScheduler(OpSchedulerBase):
    """Scheduler adapter over a policy — how policies enter scheduler-land
    (the inverse of :class:`FixedPolicy`).

    Branch selection is deferred to plan-record time, when the
    partitioned segment graph is in hand (``pick`` re-injects it under
    ``extra['graph']`` so graph-conditional predicates see op names).
    Every pre-facade entry point that passes schedulers around composes
    with policies through this adapter.
    """

    name = "policy"

    def __init__(self, policy: StrategyPolicy, name: Optional[str] = None):
        self.policy = policy
        self.name = name or getattr(policy, "name", "policy")

    def identity(self):
        return (self.name, self.policy.identity())

    def partition_rules(self):
        return self.policy.partition_rules()

    def pick(self, ctx) -> OpSchedulerBase:
        """Resolve the sub-strategy for a ``SchedCtx`` (record time)."""
        return self.policy(with_graph(ctx.info, ctx.graph))

    def schedule(self, ctx):
        self.pick(ctx).schedule(ctx)


class _PhasePolicy(StrategyPolicy):
    name = "by_phase"

    def __init__(self, phases: dict, default):
        self.phases = {ph: as_policy(p) for ph, p in phases.items()}
        self.default = as_policy(default) if default is not None else None

    def __call__(self, ctx):
        child = self.phases.get(ctx.phase, self.default)
        if child is None:
            raise KeyError(
                f"by_phase has no branch for phase {ctx.phase!r} and no "
                f"default (have {sorted(self.phases)})")
        return child(ctx)

    def identity(self):
        return ("by_phase",
                tuple(sorted((ph, _identity_of(p))
                             for ph, p in self.phases.items())),
                _identity_of(self.default) if self.default else None)

    def children(self):
        return list(self.phases.values()) + (
            [self.default] if self.default else [])


def by_phase(default=None, **phases) -> StrategyPolicy:
    """Route by ``ctx.phase`` (train / prefill / decode)::

        by_phase(prefill=NanoFlow(), decode=Sequential(),
                 default=Sequential())
    """
    return _PhasePolicy(phases, default)


class _TokenThresholdPolicy(StrategyPolicy):
    name = "by_tokens"

    def __init__(self, thresholds, above):
        ts = [(int(t), as_policy(p)) for t, p in thresholds]
        if ts != sorted(ts, key=lambda x: x[0]):
            raise ValueError(f"thresholds must ascend: {[t for t, _ in ts]}")
        self.thresholds = ts
        self.above = as_policy(above)

    def __call__(self, ctx):
        t = tokens_of(ctx)
        for limit, child in self.thresholds:
            if t < limit:
                return child(ctx)
        return self.above(ctx)

    def identity(self):
        return ("by_tokens",
                tuple((limit, _identity_of(p))
                      for limit, p in self.thresholds),
                _identity_of(self.above))

    def children(self):
        return [p for _, p in self.thresholds] + [self.above]


def by_token_threshold(thresholds, above) -> StrategyPolicy:
    """Route by the step's token count (``tokens_of``): the first
    ``(limit, policy)`` pair with ``tokens < limit`` wins, else
    ``above``.  The paper's Fig. 2a condition — splitting small batches
    inflates memory traffic — as a combinator."""
    return _TokenThresholdPolicy(thresholds, above)


class _WhenPolicy(StrategyPolicy):
    name = "when"

    def __init__(self, predicate, policy):
        self.predicate = predicate
        self.policy = as_policy(policy)

    def __call__(self, ctx):
        if not self.predicate(ctx):
            return None
        return self.policy(ctx)

    def identity(self):
        return ("when", _predicate_identity(self.predicate),
                _identity_of(self.policy))

    def children(self):
        return [self.policy]


def when(predicate, policy) -> StrategyPolicy:
    """Guard a policy behind ``predicate(ctx) -> bool``; declines (returns
    ``None``) when the predicate is false — compose under
    ``first_viable``."""
    return _WhenPolicy(predicate, policy)


class _FirstViablePolicy(StrategyPolicy):
    name = "first_viable"

    def __init__(self, children, default):
        self._children = [as_policy(c) for c in children if c is not None]
        self.default = as_policy(default) if default is not None else None

    def __call__(self, ctx):
        for child in self._children:
            sched = child(ctx)
            if sched is not None:
                return sched
        return self.default(ctx) if self.default is not None else None

    def identity(self):
        return ("first_viable",
                tuple(_identity_of(c) for c in self._children),
                _identity_of(self.default) if self.default else None)

    def children(self):
        return self._children + ([self.default] if self.default else [])


def first_viable(*children, default=None) -> StrategyPolicy:
    """Try each child in order; the first that does not decline wins.
    With no ``default`` the combinator itself declines when every child
    does (usable as a guarded branch of an outer ``first_viable``)."""
    return _FirstViablePolicy(children, default)


# -- predicates --------------------------------------------------------------


def _predicate_identity(fn) -> tuple:
    if dataclasses.is_dataclass(fn) and not isinstance(fn, type):
        return ("pred", type(fn).__module__, type(fn).__qualname__,
                dataclasses.astuple(fn))
    return fused_fn_identity(fn)


@dataclasses.dataclass(frozen=True)
class has_ops:
    """Predicate: the context's segment graph contains an op whose name
    matches ``pattern`` (regex search).  False when no graph rode along."""

    pattern: str

    def __call__(self, ctx: ScheduleContext) -> bool:
        g = _graph_of(ctx)
        if g is None:
            return False
        return any(re.search(self.pattern, n.name)
                   for n in g.nodes.values())


@dataclasses.dataclass(frozen=True)
class local_batch_below:
    """Predicate: ``ctx.local_batch < n`` (too small to split)."""

    n: int

    def __call__(self, ctx: ScheduleContext) -> bool:
        return ctx.local_batch < self.n


@dataclasses.dataclass(frozen=True)
class phase_is:
    """Predicate: ``ctx.phase`` equals the given phase."""

    phase: str

    def __call__(self, ctx: ScheduleContext) -> bool:
        return ctx.phase == self.phase
