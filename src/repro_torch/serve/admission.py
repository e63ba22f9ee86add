"""Admission control for the serve runtime — robustness policy as a
first-class, pluggable object.

DynaFlow's frontend thesis is that *execution* policy lives outside the
model definition; this module applies the same decoupling to
*robustness* policy.  An :class:`AdmissionPolicy` mirrors the shape of
``core.policy.StrategyPolicy``: frozen-dataclass policies with a stable
``identity()``, composable through :func:`admission_chain`, resolved per
request against an :class:`AdmissionContext` snapshot of engine load.
The engine consults the policy at ``submit()`` and again on every
admission pass (a request that was admissible when queued may have
blown its deadline by the time a KV row frees up).

A policy returns an :class:`Admit` or :class:`Shed` decision — or
``None`` to *decline*, meaningful inside :func:`admission_chain`, where
the first non-``None`` decision wins and the chain defaults to admit.
Shedding is a **typed result, not a stranded queue entry**: the request
terminates as ``Shed(reason)`` (reason is a :class:`RejectedRequest`
instance) and is returned from ``run()``/``drain()`` like any finished
request, with ``stats["shed"]`` counting it.

This module also owns the request-terminal taxonomy (every submitted
request ends in exactly one of :class:`Finished` / :class:`Shed` /
:class:`Failed`) and the typed :class:`RejectedRequest` exception
hierarchy that ``submit()`` raises for malformed requests — shared with
admission results so ``Overloaded`` can either be raised (hard reject)
or carried inside a ``Shed`` (soft shed), with identical ``str()``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


# -- typed rejects -----------------------------------------------------------
# ``RejectedRequest`` subclasses ValueError so every pre-existing caller
# (and test) catching the engine's old bare ValueErrors keeps working;
# the old messages are preserved verbatim as the subclass __str__s.


class RejectedRequest(ValueError):
    """A request the engine refuses to take responsibility for."""

    kind = "rejected"


class EmptyPrompt(RejectedRequest):
    kind = "empty_prompt"

    def __init__(self, msg: str = "empty prompt"):
        super().__init__(msg)


class PromptOverflow(RejectedRequest):
    """Prompt cannot fit ``s_max`` (needs at least one decode slot)."""

    kind = "prompt_overflow"


class ChunkingDisabled(RejectedRequest):
    """Prompt exceeds the largest prefill bucket and chunked prefill is
    off."""

    kind = "chunking_disabled"


class UnchunkablePrompt(RejectedRequest):
    """No chunk schedule fits the prompt within ``s_max``."""

    kind = "unchunkable"


class Overloaded(RejectedRequest):
    """Load shed: the engine cannot serve this request in time.  Raised
    by ``submit()`` for hard rejects (e.g. draining) and carried as the
    ``Shed.reason`` for soft sheds."""

    kind = "overloaded"


class EngineDraining(Overloaded):
    kind = "draining"

    def __init__(self, msg: str = "engine is draining"):
        super().__init__(msg)


class DeadlineExceeded(Overloaded):
    """The request's deadline or TTFT budget expired before service."""

    kind = "deadline"


# -- terminal results --------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Finished:
    """The request ran to completion (eos / max_new_tokens / length)."""

    reason: str = "completed"
    ok = True


@dataclasses.dataclass(frozen=True)
class Shed:
    """The request was load-shed before completing; ``reason`` is a
    :class:`RejectedRequest` instance (or a string for engine-internal
    sheds)."""

    reason: object
    ok = False

    def __str__(self):
        return f"shed: {self.reason}"


@dataclasses.dataclass(frozen=True)
class Failed:
    """The request terminated abnormally (fault, poisoned dispatch,
    deadline blown mid-generation, stranded at drain/shutdown)."""

    reason: str
    ok = False

    def __str__(self):
        return f"failed: {self.reason}"


# -- context + policy protocol ----------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdmissionContext:
    """Engine-load snapshot a policy decides against.  ``queue_depth``
    counts *other* waiting requests (at submit time: the queue the new
    request would join)."""

    queue_depth: int
    active: int                 # decoding rows
    chunking: int               # in-progress chunked prefills
    free_rows: int              # usable KV rows (after pressure embargo)
    max_batch: int
    prompt_len: int
    priority: int
    waited_s: float             # time spent in the queue so far
    deadline_left_s: Optional[float]   # None: no deadline
    ttft_left_s: Optional[float]       # None: no TTFT budget
    # KV-capacity signals from the cache backend (serve/kv_cache.py):
    # token-granular under PagedCache, row-granular under DenseCache.
    # Defaulted so pre-paging call sites keep constructing by keyword.
    free_tokens: int = -1              # -1: backend reported nothing
    capacity_tokens: int = -1

    @property
    def occupancy(self) -> int:
        return self.active + self.chunking

    @property
    def kv_util(self) -> float:
        """Fraction of KV token capacity in use (0.0 when unreported)."""
        if self.capacity_tokens <= 0 or self.free_tokens < 0:
            return 0.0
        return 1.0 - self.free_tokens / self.capacity_tokens


@dataclasses.dataclass(frozen=True)
class Admit:
    ok = True


class AdmissionPolicy:
    """Protocol base, mirroring ``core.policy.StrategyPolicy``:
    subclasses implement ``__call__`` (returning :class:`Admit`,
    :class:`Shed`, or ``None`` to decline — meaningful only inside
    :func:`admission_chain`) and ``identity()`` (a stable hashable
    tuple, reproducible across processes).  Prefer frozen dataclasses —
    like strategy predicates, an ad-hoc closure still works but its
    identity degrades to ``id()``."""

    name = "admission"

    def __call__(self, ctx: AdmissionContext):
        raise NotImplementedError

    def identity(self) -> tuple:
        raise NotImplementedError


def _identity_of(policy) -> tuple:
    if dataclasses.is_dataclass(policy) and not isinstance(policy, type):
        return (type(policy).__module__, type(policy).__qualname__,
                dataclasses.astuple(policy))
    ident = getattr(policy, "identity", None)
    if callable(ident):
        return ident()
    return ("opaque", id(policy))


@dataclasses.dataclass(frozen=True)
class AdmitAll(AdmissionPolicy):
    """The default: every well-formed request is admitted (the
    pre-hardening engine's behavior — requests queue without bound)."""

    name = "admit_all"

    def __call__(self, ctx):
        return Admit()

    def identity(self):
        return ("admit_all",)


@dataclasses.dataclass(frozen=True)
class BoundedQueue(AdmissionPolicy):
    """Shed when the waiting queue is already ``depth`` deep — bounded
    queueing instead of unbounded latency.  Declines (defers to the
    rest of the chain) while the queue has room."""

    depth: int
    name = "bounded_queue"

    def __call__(self, ctx):
        if ctx.queue_depth >= self.depth:
            return Shed(Overloaded(
                f"queue depth {ctx.queue_depth} >= bound {self.depth}"))
        return None

    def identity(self):
        return ("bounded_queue", self.depth)


@dataclasses.dataclass(frozen=True)
class DeadlineGate(AdmissionPolicy):
    """Shed requests whose deadline or TTFT budget has already expired
    while waiting — serving them would waste decode steps on an answer
    nobody is waiting for."""

    name = "deadline_gate"

    def __call__(self, ctx):
        for left, what in ((ctx.deadline_left_s, "deadline"),
                           (ctx.ttft_left_s, "TTFT budget")):
            if left is not None and left <= 0:
                return Shed(DeadlineExceeded(
                    f"{what} expired after waiting {ctx.waited_s:.3f}s"))
        return None

    def identity(self):
        return ("deadline_gate",)


@dataclasses.dataclass(frozen=True)
class PriorityFloor(AdmissionPolicy):
    """Under load (queue at least ``when_queue_over`` deep), shed
    requests below ``min_priority`` — graceful degradation that keeps
    the high-priority tier inside its latency budget."""

    min_priority: int
    when_queue_over: int = 0
    name = "priority_floor"

    def __call__(self, ctx):
        if (ctx.queue_depth > self.when_queue_over
                and ctx.priority < self.min_priority):
            return Shed(Overloaded(
                f"priority {ctx.priority} below floor {self.min_priority} "
                f"with queue depth {ctx.queue_depth}"))
        return None

    def identity(self):
        return ("priority_floor", self.min_priority, self.when_queue_over)


@dataclasses.dataclass(frozen=True)
class PagePressure(AdmissionPolicy):
    """Shed when admitting the request would push KV token residency
    past ``max_util`` of pool capacity — the page-granular analogue of
    :class:`BoundedQueue`, fed by the cache backend's ``free_tokens`` /
    ``capacity_tokens`` signals.  Declines when the backend reports no
    capacity (dense engines constructed before the paged era, or unit
    tests with a partial context)."""

    max_util: float = 0.95
    name = "page_pressure"

    def __call__(self, ctx):
        if ctx.capacity_tokens <= 0 or ctx.free_tokens < 0:
            return None
        used = ctx.capacity_tokens - ctx.free_tokens
        if (used + ctx.prompt_len) / ctx.capacity_tokens > self.max_util:
            return Shed(Overloaded(
                f"KV pool at {ctx.kv_util:.0%} utilization; admitting a "
                f"{ctx.prompt_len}-token prompt would exceed the "
                f"{self.max_util:.0%} page-pressure ceiling"))
        return None

    def identity(self):
        return ("page_pressure", self.max_util)


class _AdmissionChain(AdmissionPolicy):
    name = "chain"

    def __init__(self, policies):
        self.policies = [p for p in policies if p is not None]

    def __call__(self, ctx):
        for p in self.policies:
            decision = p(ctx)
            if decision is not None:
                return decision
        return Admit()

    def identity(self):
        return ("chain", tuple(_identity_of(p) for p in self.policies))


def admission_chain(*policies) -> AdmissionPolicy:
    """Compose policies: the first non-``None`` decision wins; a chain
    that runs off the end admits.  Mirrors ``first_viable`` from
    ``core.policy``."""
    return _AdmissionChain(policies)


def resolve_admission(policy) -> AdmissionPolicy:
    """Normalize ``ServeConfig.admission``: ``None`` -> :class:`AdmitAll`,
    a single policy is wrapped so a declining predicate still admits."""
    if policy is None:
        return AdmitAll()
    if isinstance(policy, _AdmissionChain) or isinstance(policy, AdmitAll):
        return policy
    return _AdmissionChain([policy])
