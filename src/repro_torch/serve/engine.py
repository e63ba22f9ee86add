"""Tiered greedy serving engine: batched bucketed prefill, chunked
prefill through the decode graph, power-of-two decode tiers with row
compaction, a double-buffered host loop with one host sync per decode
iteration, and a request lifecycle (admission control, deadlines,
preempt-and-requeue, fault isolation, drain).

  * **Decode batch tiers.**  Decode steps are built at power-of-two batch
    tiers (1, 2, 4, …, ``max_batch``); each iteration runs the smallest
    tier covering the allocated rows.  Allocated rows (decoding and
    chunking) are compacted into the low slots on tier shrink (in-place
    row copies on the device) so the tier prefix is always dense, and
    the step reads the tier's rows of the stacked caches as views.
  * **Batched prefill.**  ``_admit`` packs up to ``prefill_batch`` waiting
    requests into one bucketed prefill call (a real batch dimension,
    padded to a power-of-two group tier).  Padded slots alias the first
    real row and are written first, so the real write wins.  Each row's
    KV is copied into its preallocated cache row in place.  A prompt
    shorter than its bucket leaves its last token to the first decode
    step (the ``-100`` sentinel), exactly as the JAX engine does.
  * **Chunked prefill.**  A prompt longer than the largest bucket runs as
    chunk steps through the *decode* graph at chunk-sized query width:
    position ``j`` of a chunk sees ``offset + j + 1`` keys.  Chunk
    lengths are prefill buckets (``_chunk_plan``; no chunk overhangs
    ``s_max``) and cover the prompt up to position ``n - 1``; the last
    position goes to the first decode step through the sentinel.
    Dispatch is fair: each iteration admits the waiting whole-prompt
    groups first and then issues one chunk of the oldest in-progress
    chunked prefill, packed with every other one whose next chunk has
    the same length (round-robin), so a long prompt never holds
    dispatch for ``len/chunk`` iterations: short requests behind it are
    prefilled before its later chunks (their first decode step still
    runs after any chunk step already on the stream).  Between two
    chunks a decode step writes one
    garbage K/V at the chunking row's frontier (the host length mirror
    stays at ``offset + chunk``); the next chunk overwrites it.
  * **Async host loop.**  Greedy argmax and the eos/length masks run on
    the device; sampled tokens chain into the next step through a device
    ``last_ids`` vector.  Each step's small token/done vector is copied to
    pinned host memory as soon as it is enqueued, behind an event; the
    loop dispatches step k+1 before it waits on step k's event — one host
    sync per decode iteration.
  * **One CUDA Graph per decode tier, prefill group and chunk group**
    (``ServeConfig.lowered``, the default).  A tier's whole step — the
    forward over the lowered slot IR, the cache updates, argmax, the
    masks and the write of the next ids — is captured once
    (``core/capture.py``) over buffers the engine owns and never
    reassigns: ``_last_ids``, the tier views of the caches, and
    ``_step_in``, whose rows are the (active, will_end, eos) flags and
    the cache lengths.  A step's host work is then one copy of flags and
    lengths from pinned staging, ``replay()``, and the fetch of tok/done.
    A prefill group of one ``(bp, bucket)`` is captured the same way: its
    ids, rows, full flags and last tokens are staged into one fixed
    device buffer, and the graph writes the cache rows and ``_last_ids``
    with ``index_copy_`` one slot at a time, in reversed slot order, so
    that slot 0's write lands last, as the JAX engine's does.  A chunk
    group of one ``(bc, chunk)`` reads its ids, offsets, rows and
    sentinel tokens from a fixed buffer likewise: it gathers its rows of
    every cache, runs the decode forward at ``(bc, chunk)``, and writes
    the rows (and, on a final chunk, the row's ``_last_ids``) back in
    reversed slot order.  A graph is built on its first use, or ahead of
    traffic by ``warmup()``.  On the CPU the slot IR runs eagerly and
    nothing is captured; ``lowered=False`` runs the interpreter eagerly
    on either device.
  * **PlanStore.**  Every lowered step is built through the engine's
    ``PlanStore`` (``core/plan_store.py``): a tier, bucket or chunk width
    whose structure the store holds is specialized from it, one it holds
    persisted is restored, and ``run()`` checkpoints a path-bound store
    when the queue drains.  The graphs live in the store's executable
    level under keys that name this engine, since a graph binds its
    engine's buffers, all in one graph memory pool of the engine; they
    are dropped when the engine is collected.
    ``stats["plan_store"]`` is the store's ``snapshot()``.
  * **Request lifecycle.**  A pluggable admission policy
    (``serve/admission.py``) decides each request at ``submit`` against
    a load snapshot; a shed request terminates as ``Shed(reason)``, and
    expired deadlines or TTFT budgets always shed (a built-in
    ``DeadlineGate``).  When a higher-priority request waits on a full
    pool, or a pressure window shrinks the pool, the lowest-priority
    decoding row is preempted: its row is released and it re-enters the
    queue as a re-prefill over ``prompt + output`` (chunked when that
    outgrows the largest bucket); with greedy decode the resumed tokens
    equal an uninterrupted run's wherever the re-prefill computes the
    generated positions' K/V bitwise as the decode steps did (the plain
    CPU path; the card's prefill kernels round differently).  ``drain()``
    stops admitting, finishes in-flight rows and checkpoints;
    ``run(max_iters)`` and ``shutdown()`` strand what is left as
    ``Failed`` and release its rows.  ``ServeConfig.faults`` threads a
    deterministic ``FaultInjector`` (``serve/faults.py``) through
    allocation, dispatch, harvest, pacing and capacity; an injected
    fault fails the requests of its dispatch (a poisoned request alone,
    the others retried), never the engine.  Only the injector's faults
    are caught: a real device, capture or replay error propagates.
    Every submitted request terminates in exactly one of ``Finished`` /
    ``Shed`` / ``Failed`` (``Request.result``), mirrored by the
    lifecycle counters in ``stats``.

The paged cache, speculative and sampled decode arrive with later
slices.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
import weakref
from typing import Optional

import numpy as np
import torch

from ..core.capture import GraphStep
from ..core.plan_store import PlanStore, resolve_plan_store
from ..core.scheduler import ScheduleContext
from ..device import resolve_device
from ..models.base import build_forward
from .admission import (
    AdmissionContext,
    ChunkingDisabled,
    DeadlineExceeded,
    DeadlineGate,
    EmptyPrompt,
    EngineDraining,
    Failed,
    Finished,
    Overloaded,
    PromptOverflow,
    Shed,
    UnchunkablePrompt,
    admission_chain,
)
from .faults import INJECTED, InjectedFault, PoisonedRequest
from .kv_cache import DenseCache


def pow2_tiers(n: int) -> tuple:
    """Power-of-two capture tiers up to and including ``n``."""
    ts, t = [], 1
    while t < n:
        ts.append(t)
        t *= 2
    ts.append(n)
    return tuple(sorted(set(ts)))


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int = 16
    eos_id: int = -1                   # -1: never stop early
    priority: int = 0                  # higher preempts lower under load
    deadline_s: Optional[float] = None     # wall-clock budget from submit
    ttft_budget_s: Optional[float] = None  # budget to the first token
    # filled by the engine:
    output: list = dataclasses.field(default_factory=list)
    row: int = -1
    submitted_s: float = 0.0
    first_token_s: float = 0.0
    done_s: float = 0.0
    result: object = None              # Finished | Shed | Failed
    preemptions: int = 0
    _seq: int = dataclasses.field(default=-1, repr=False)
    _resume: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False)

    @property
    def effective_prompt(self) -> np.ndarray:
        """The token stream a (re-)prefill must cover: the original
        prompt, or prompt + generated tokens after a preemption."""
        return self._resume if self._resume is not None else self.prompt

    @property
    def ok(self) -> bool:
        return isinstance(self.result, Finished)


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    s_max: int = 256
    prefill_buckets: tuple = (32, 64, 128, 256)
    # Batched prefill: pack up to this many waiting requests into one
    # prefill call (batch dim bucketed to power-of-two group tiers).
    prefill_batch: int = 4
    # Tiered decode: steps at these batch sizes (ascending, last ==
    # max_batch).  None = power-of-two tiers.
    decode_tiers: Optional[tuple] = None
    # Chunked prefill: prompts longer than the largest bucket run as
    # chunk steps through the decode graph; off, submit() refuses them
    # with a typed ChunkingDisabled.
    chunked_prefill: bool = True
    # Admission policy (serve/admission.py); None admits every
    # well-formed request.  Expired deadlines / TTFT budgets shed
    # regardless (a built-in DeadlineGate).
    admission: object = None
    # Preempt-and-requeue the lowest-priority decoding row when a
    # higher-priority request waits on a full pool or a pressure window
    # shrinks capacity.
    preemption: bool = True
    # Chaos harness: a serve.faults.FaultInjector threaded through
    # allocation, dispatch, harvest, pacing and capacity.
    faults: object = None
    # Realize steps through the lowered slot IR and, on CUDA, replay each
    # decode tier's, prefill group's and chunk group's step as one CUDA
    # Graph; False runs the interpreter eagerly (the yardstick).
    lowered: bool = True
    # PlanStore budgets: bucketed serving churns through (shape, plan)
    # pairs, so both levels are bounded — plans by count and an LRU byte
    # budget, graphs by count and an optional byte budget.
    plan_capacity: int = 256
    plan_budget_bytes: Optional[int] = 32 << 20
    exec_capacity: int = 64
    exec_budget_bytes: Optional[int] = None
    # Persistent PlanStore: the engine warm-starts from this file and
    # checkpoints the store back to it when the request queue drains.
    plan_store_path: Optional[str] = None


class _Fetch:
    """A small device tensor on its way to pinned host memory."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = t.clone(), None

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class _Staged:
    """A fixed int32 device buffer fed from two pinned host buffers in
    turns: the loop keeps two steps in flight, and a host buffer is
    rewritten only once the copy that last read it has run (its
    event)."""

    def __init__(self, n: int, device: torch.device):
        cuda = device.type == "cuda"
        self.dev = torch.zeros((n,), dtype=torch.int32, device=device)
        self._host = [torch.zeros((n,), dtype=torch.int32, pin_memory=cuda)
                      for _ in range(2)]
        self._ev = [torch.cuda.Event() if cuda else None for _ in range(2)]
        self._i = 0

    def put(self, fill, n: int):
        """``fill(a)`` writes the first ``n`` values into a host buffer
        (numpy), which is then copied into ``dev[:n]``."""
        host, ev = self._host[self._i], self._ev[self._i]
        self._i ^= 1
        if ev is not None:
            ev.synchronize()
        fill(host.numpy()[:n])
        self.dev[:n].copy_(host[:n], non_blocking=ev is not None)
        if ev is not None:
            ev.record()


_SERIAL = itertools.count()


def _graphs_of(serial: int):
    """Predicate over executable keys: the graphs of engine ``serial``."""
    mine = ("engine", serial)
    return lambda key: len(key) > 1 and key[1] == mine


class ServeEngine:
    """``scheduler`` accepts an ``OpSchedulerBase``, a ``StrategyPolicy``
    or a strategy name (resolved per step context by ``build_forward``).
    Params and caches live on ``device`` (default: the GPU; raises
    without one unless the caller passes ``device="cpu"``).
    ``plan_store`` injects an externally owned store (``api.Program``
    passes its own, so every step the program builds shares one
    artifact); without it the engine opens or creates one from
    ``cfg``."""

    def __init__(self, model, params, scheduler, cfg: ServeConfig,
                 device=None, step_cache: Optional[dict] = None,
                 plan_store: Optional[PlanStore] = None):
        self.model = model
        self.params = params
        self.scheduler = scheduler
        self.cfg = cfg
        self.device = resolve_device(device)
        if tuple(sorted(cfg.prefill_buckets)) != tuple(cfg.prefill_buckets):
            raise ValueError("prefill_buckets must be ascending")
        if max(cfg.prefill_buckets) > cfg.s_max:
            raise ValueError("largest prefill bucket exceeds s_max")
        self.tiers = tuple(cfg.decode_tiers or pow2_tiers(cfg.max_batch))
        if self.tiers != tuple(sorted(self.tiers)) \
                or self.tiers[-1] != cfg.max_batch:
            raise ValueError(
                f"decode_tiers must ascend to max_batch: {self.tiers}")
        self.prefill_tiers = pow2_tiers(
            max(1, min(cfg.prefill_batch, cfg.max_batch)))
        leaf = _first_leaf(params)
        if leaf is not None and leaf.device.type != self.device.type:
            raise ValueError(f"params live on {leaf.device}, the engine on "
                             f"{self.device}")
        backend = DenseCache()
        self.cache = backend.build(model, cfg, self.device)
        budgets = dict(plan_capacity=cfg.plan_capacity,
                       plan_budget_bytes=cfg.plan_budget_bytes,
                       exec_capacity=cfg.exec_capacity,
                       exec_budget_bytes=cfg.exec_budget_bytes)
        if plan_store is not None:
            if (cfg.plan_store_path and plan_store.path
                    and cfg.plan_store_path != plan_store.path):
                raise ValueError(
                    f"conflicting persistence targets: the injected "
                    f"PlanStore is bound to {plan_store.path!r} but "
                    f"ServeConfig.plan_store_path={cfg.plan_store_path!r}"
                    "; drop one of them")
            self.store = resolve_plan_store(plan_store,
                                            cfg.plan_store_path)
            # a shared store keeps its own budgets unless this config
            # overrides them (a value other than the default wins)
            defaults = ServeConfig()
            for field, val in budgets.items():
                if val != getattr(defaults, field):
                    setattr(self.store, field, val)
        elif cfg.plan_store_path:
            self.store = PlanStore.open(cfg.plan_store_path, **budgets)
        else:
            self.store = PlanStore(**budgets)
        # the cache backend changes what the steps close over, so its
        # identity salts the store's outer keys
        self._op_config = model.op_closure_config() + (
            ("cache_backend", backend.identity()),)
        # the engine's name in its graphs' executable keys; its graphs
        # bind its buffers, so they go from the store when it does
        self._serial = next(_SERIAL)
        weakref.finalize(self, self.store.evict_execs,
                         _graphs_of(self._serial))
        # the built-in deadline gate runs first: a request whose deadline
        # or TTFT budget expired in the queue sheds under any policy
        self.admission = admission_chain(DeadlineGate(), cfg.admission)
        self._deadline_gate = admission_chain(DeadlineGate())
        self.faults = cfg.faults
        self.waiting: list[Request] = []
        self.active: dict[int, Request] = {}     # row -> request
        # in-progress chunked prefills: rows allocated (KV filling chunk
        # by chunk) but not yet decoding; a round-robin queue
        self._chunking: list[dict] = []
        self.finished: list[Request] = []
        # ("prefill", rids) / ("chunk", rids) in dispatch order
        self.dispatch_log: list[tuple] = []
        # fixed buffers the graphs read and write: never rebound
        B = cfg.max_batch
        big = cfg.prefill_buckets[-1]
        self._last_ids = torch.zeros((B, 1), dtype=torch.int32,
                                     device=self.device)
        # decode: (active, will_end, eos) flags and cache lengths, (4, B)
        self._step_stage = _Staged(4 * B, self.device)
        self._step_in = self._step_stage.dev.view(4, B)
        # prefill: ids, rows, full flags, last tokens of one group; chunk:
        # ids, offsets, rows, sentinel tokens of one chunk group; laid out
        # per (bp, bucket) / (bc, chunk) by _group_views
        self._prefill_stage = _Staged(self.prefill_tiers[-1] * (big + 3),
                                      self.device)
        self._chunk_stage = _Staged(self.prefill_tiers[-1] * (big + 3),
                                    self.device)
        cuda = self.device.type == "cuda"
        self._graphed = cfg.lowered and cuda
        self._capture_stream = torch.cuda.Stream(self.device) \
            if self._graphed else None
        # one graph pool for all of this engine's graphs (core/capture.py:
        # its replays run in series and each output is read at once)
        self._pool = torch.cuda.graph_pool_handle() if self._graphed \
            else None
        self._gen = np.zeros((cfg.max_batch,), np.int32)   # tokens sampled
        self._pending = None               # in-flight decode step handle
        self._pending_prefill: list = []   # [(_Fetch, [(slot, req), ...])]
        self._seq = 0                      # submission order tiebreaker
        self._iter = 0                     # engine iteration counter
        self._cur_iter = 0                 # iteration the loop is inside
        self._draining = False
        # step key -> Forward; a shared dict lets engines of one program
        # reuse each other's traced and scheduled steps
        self._steps: dict = {} if step_cache is None else step_cache
        self._stats = {"prefill_steps": 0, "prefill_reqs": 0,
                       "chunk_steps": 0, "decode_steps": 0,
                       "decode_tokens": 0, "host_syncs": 0, "row_moves": 0,
                       "submitted": 0, "admitted": 0, "finished": 0,
                       "shed": 0, "failed": 0, "preempted": 0,
                       "resumed": 0, "deadline_missed": 0,
                       "alloc_denied": 0, "peak_active": 0,
                       "stranded": 0, "drains": 0,
                       "graph_captures": 0, "graph_replays": 0,
                       "capture_s": 0.0, "prefill_graph_captures": 0,
                       "prefill_graph_replays": 0, "prefill_capture_s": 0.0,
                       "chunk_graph_captures": 0, "chunk_graph_replays": 0,
                       "chunk_capture_s": 0.0,
                       "tier_steps": {t: 0 for t in self.tiers},
                       "tier_builds": {}}
        self._ck = self._cache_keys()

    # -- public -----------------------------------------------------------
    def submit(self, req: Request):
        """Validate and enqueue one request.

        A malformed request raises a typed :class:`RejectedRequest`
        subclass (each a ``ValueError``).  A request the admission policy
        sheds at the door terminates at once as ``Shed(Overloaded)`` —
        it appears in ``finished`` / ``run()`` like any terminal request
        — and the ``Shed`` decision is returned; ``None`` means
        admitted."""
        if self._draining:
            raise EngineDraining()
        self._stats["submitted"] += 1
        n = len(req.prompt)
        if n < 1:
            raise EmptyPrompt("empty prompt")
        if n > self.cfg.s_max - 1:
            raise PromptOverflow(
                f"prompt length {n} cannot fit s_max={self.cfg.s_max} "
                "(need at least one decode slot)")
        if n > self.cfg.prefill_buckets[-1]:
            if not self.cfg.chunked_prefill:
                raise ChunkingDisabled(
                    f"prompt length {n} exceeds the largest prefill bucket "
                    f"{self.cfg.prefill_buckets[-1]} and chunked prefill "
                    "is disabled")
            self._chunk_plan(n)            # raises if it cannot be chunked
        req.submitted_s = time.perf_counter()
        req._seq = self._seq
        self._seq += 1
        decision = self._decide(req, req.submitted_s)
        if isinstance(decision, Shed):
            self._shed_request(req, decision.reason)
            return decision
        self._stats["admitted"] += 1
        self.waiting.append(req)
        return None

    def step(self) -> bool:
        """One engine iteration: admit, dispatch, harvest.  Returns True
        while work remains."""
        it = self._iter
        self._iter += 1
        self._cur_iter = it
        if self.faults is not None:
            self.faults.on_iter(it)        # injected straggler
        self._admit()
        # double-buffered: step k+1 is in flight before step k's harvest
        prev, self._pending = self._pending, self._dispatch_decode()
        self._harvest(prev)
        return self._busy()

    def warmup(self, tiers: Optional[tuple] = None, prefill=(), chunks=()):
        """Build decode tiers' steps (every tier when ``tiers`` is None or
        empty), the prefill steps of the given ``(group tier, bucket)``
        pairs and the chunk steps of the given ``(group tier, chunk)``
        pairs ahead of traffic — and, when graphed, capture them — so
        that neither a tier switch nor a new bucket under load hits a
        cold build or a capture.  Changes no cache, id or length: a
        graph is warmed on copies of the buffers its step writes, and
        its capture runs nothing.  (A CUDA Graph binds one engine's
        buffers, so this is the port's counterpart of executables shared
        across engines.)"""
        for t in tiers or self.tiers:
            if self._graphed:
                self._graph(t)
            else:
                self._forward("decode", t, self.cfg.s_max)
        for kind, pairs in (("prefill", prefill), ("chunk", chunks)):
            for bp, bucket in pairs:
                if bp not in self.prefill_tiers \
                        or bucket not in self.cfg.prefill_buckets:
                    raise ValueError(
                        f"no {kind} group ({bp}, {bucket}): group tiers "
                        f"{self.prefill_tiers}, buckets "
                        f"{self.cfg.prefill_buckets}")
                if self._graphed:
                    self._group_graph(kind, bp, bucket)
                else:
                    self._forward(kind, bp, bucket)

    def run(self, max_iters: int = 10_000) -> list:
        """Drive the loop until every request terminates (or
        ``max_iters``), then checkpoint the PlanStore.  Exhausting the
        iteration budget strands the survivors: they terminate as
        ``Failed``, their rows are released, and ``stats["stranded"]``
        counts them."""
        it = 0
        while self._busy() and it < max_iters:
            self.step()
            it += 1
        if self._busy():
            self._strand(f"run() exhausted max_iters={max_iters}")
        # idle: the queue drained — checkpoint lowered plans so a
        # restart warm-starts instead of re-lowering
        self.checkpoint()
        return self.finished

    def drain(self, timeout: Optional[float] = None) -> dict:
        """Graceful drain: stop admitting (``submit`` raises
        :class:`EngineDraining`; already queued requests shed), finish
        every in-flight row, checkpoint the PlanStore, and report.  On
        ``timeout`` (seconds of wall clock) the survivors are stranded:
        terminated as ``Failed``, rows released, rids reported."""
        self._draining = True
        try:
            for req in list(self.waiting):
                self._shed_request(req, EngineDraining(
                    "shed from the queue by drain()"))
            self.waiting = []
            t0 = time.perf_counter()
            stranded: list = []
            it = 0
            while self._inflight():
                if timeout is not None \
                        and time.perf_counter() - t0 > timeout:
                    stranded = self._strand(
                        f"stranded at drain(timeout={timeout})")
                    break
                self.step()
                it += 1
            n = self.checkpoint()
            self._stats["drains"] += 1
            return {"iters": it, "checkpointed": n,
                    "stranded": stranded,
                    "finished": self._stats["finished"],
                    "shed": self._stats["shed"],
                    "failed": self._stats["failed"],
                    "free_rows": len(self.cache.free_rows)}
        finally:
            self._draining = False

    def checkpoint(self) -> int:
        """Persist the PlanStore when it is path-bound and changed since
        the last save; returns the number of outer entries written."""
        if not self.store.path or not self.store.dirty:
            return 0
        return self.store.save()

    def shutdown(self) -> int:
        """Abort in-flight work, drop this engine's graphs from the store
        and checkpoint it.  Rows held by active, chunking or pending
        requests are released (those requests terminate as ``Failed``,
        queued ones as ``Shed``), so the pool leaks nothing, and the
        checkpoint still runs.  The engine stays usable: its next steps
        capture anew."""
        if self._busy():
            self._strand("engine shutdown")
        self.store.evict_execs(_graphs_of(self._serial))
        return self.checkpoint()

    @property
    def stats(self) -> dict:
        out = dict(self._stats)
        out["tier_steps"] = dict(self._stats["tier_steps"])
        out["tier_builds"] = dict(self._stats["tier_builds"])
        out["plan_store"] = self.store.snapshot()
        out["kv"] = self.cache.kv_stats()
        if self.faults is not None:
            out["faults"] = self.faults.counts
        return out

    # -- lifecycle --------------------------------------------------------
    def _busy(self) -> bool:
        return bool(self.waiting or self._inflight())

    def _inflight(self) -> bool:
        return bool(self.active or self._chunking
                    or self._pending is not None or self._pending_prefill)

    def _decide(self, req: Request, now: float, chain=None):
        """Run the admission chain against a load snapshot."""
        waited = max(0.0, now - req.submitted_s)
        deadline_left = (req.submitted_s + req.deadline_s - now
                         if req.deadline_s is not None else None)
        ttft_left = (req.submitted_s + req.ttft_budget_s - now
                     if req.ttft_budget_s is not None
                     and not req.first_token_s else None)
        ctx = AdmissionContext(
            queue_depth=len(self.waiting),
            active=len(self.active), chunking=len(self._chunking),
            free_rows=len(self._usable_free_rows()),
            max_batch=self.cfg.max_batch,
            prompt_len=len(req.effective_prompt), priority=req.priority,
            waited_s=waited, deadline_left_s=deadline_left,
            ttft_left_s=ttft_left,
            free_tokens=self.cache.free_tokens(),
            capacity_tokens=self.cache.token_capacity())
        return (chain or self.admission)(ctx)

    def _release_row_of(self, req: Request):
        row = req.row
        if row >= 0 and self.cache.row_owner.get(row) == req.rid:
            self.active.pop(row, None)
            self.cache.release(row)
            self._gen[row] = 0
        req.row = -1

    def _shed_request(self, req: Request, reason):
        """Terminate a request as ``Shed(reason)`` — a typed result, not
        a stranded queue entry."""
        if req.done_s:
            return
        req.done_s = time.perf_counter()
        req.result = Shed(reason)
        self._release_row_of(req)
        self._chunking = [st for st in self._chunking
                          if st["req"] is not req]
        self._stats["shed"] += 1
        if isinstance(reason, DeadlineExceeded):
            self._stats["deadline_missed"] += 1
        self.finished.append(req)

    def _fail_request(self, req: Request, reason):
        """The per-request error boundary's sink: terminate as
        ``Failed(reason)``, release the row, keep the engine alive."""
        if req.done_s:
            return
        req.done_s = time.perf_counter()
        req.result = Failed(str(reason))
        self._release_row_of(req)
        self._chunking = [st for st in self._chunking
                          if st["req"] is not req]
        self._stats["failed"] += 1
        self.finished.append(req)

    def _finish(self, req: Request, now: float):
        self.active.pop(req.row, None)
        if req.row >= 0 and self.cache.row_owner.get(req.row) == req.rid:
            self.cache.release(req.row)
            self._gen[req.row] = 0
        req.row = -1
        req.done_s = now
        req.result = Finished()
        self._stats["finished"] += 1
        self.finished.append(req)

    def _deadline_blown(self, req: Request, now: float) -> bool:
        return (req.deadline_s is not None
                and now > req.submitted_s + req.deadline_s)

    def _fail_deadline(self, req: Request, now: float):
        self._stats["deadline_missed"] += 1
        self._fail_request(
            req, f"deadline {req.deadline_s}s exceeded after "
                 f"{len(req.output)} tokens")

    def _strand(self, reason: str) -> list:
        """Release every in-flight row and terminate its request
        (active / chunking -> ``Failed``, queued -> ``Shed``); returns
        the stranded rids.  Harvests the pending step first, so tokens
        the device already produced are kept."""
        self._flush_pending()
        inflight = list(self.active.values()) \
            + [st["req"] for st in self._chunking]
        for req in inflight:
            self._stats["stranded"] += 1
            self._fail_request(req, reason)
        for req in list(self.waiting):
            self._shed_request(req, Overloaded(reason))
        self.waiting = []
        self._chunking = []
        self._pending = None
        return [r.rid for r in inflight]

    def _flush_pending(self):
        """Synchronize: harvest the in-flight decode step and any pending
        prefill first-token vectors, so every request's host-side token
        list is current (preemption snapshots depend on this)."""
        if self._pending is not None or self._pending_prefill:
            self._harvest(self._pending)
            self._pending = None

    # -- admission --------------------------------------------------------
    def _bucket(self, n: int) -> int:
        for b in self.cfg.prefill_buckets:
            if n <= b:
                return b
        return self.cfg.prefill_buckets[-1]

    @staticmethod
    def _tier_for(n: int, tiers: tuple) -> int:
        for t in tiers:
            if t >= n:
                return t
        return tiers[-1]

    def _capacity(self) -> int:
        """Effective pool capacity: ``max_batch`` minus any rows
        embargoed by an injected memory-pressure window."""
        pressure = (self.faults.pressure_rows(self._cur_iter)
                    if self.faults is not None else 0)
        return max(0, self.cfg.max_batch - pressure)

    def _usable_free_rows(self) -> list:
        """Free rows the engine may hand out now — truncated so that
        occupancy never exceeds the effective capacity."""
        occ = len(self.active) + len(self._chunking)
        room = max(0, self._capacity() - occ)
        return self.cache.free_rows[:room]

    def _try_allocate(self, req: Request) -> Optional[int]:
        """Allocate a row under admission control: denied under
        pressure-shrunk capacity and by injected allocation faults (the
        request stays queued: exhaustion is an admission signal, not an
        exception)."""
        if not self._usable_free_rows():
            return None
        if self.faults is not None and self.faults.deny_alloc():
            self._stats["alloc_denied"] += 1
            return None
        # a dense row holds s_max tokens: nothing more to reserve
        return self.cache.allocate(req.rid)

    def _shed_expired(self, now: float):
        """Re-check deadlines over the queue: a request admissible at
        submit may have blown its deadline or TTFT budget while waiting
        for a row.  Load policies do not run again here — admission is a
        one-time gate."""
        keep = []
        for req in self.waiting:
            decision = self._decide(req, now, chain=self._deadline_gate)
            if isinstance(decision, Shed):
                self._shed_request(req, decision.reason)
            else:
                keep.append(req)
        self.waiting = keep

    def _admit(self):
        """Fair admission under lifecycle control: shed expired work,
        preempt if pressure or priority demands it, then admit waiting
        whole-prompt groups (highest priority first, submission order
        within a priority) and exactly one chunk of the oldest
        in-progress chunked prefill per iteration (round-robin).  An
        oversized prompt at the queue head only stages its chunk state;
        its chunks interleave with later iterations' admits."""
        now = time.perf_counter()
        self._shed_expired(now)
        self._maybe_preempt()
        big = self.cfg.prefill_buckets[-1]
        self.waiting.sort(key=lambda r: (-r.priority, r._seq))
        while self.waiting:
            if not self._usable_free_rows():
                break
            head = self.waiting[0]
            if len(head.effective_prompt) > big:
                row = self._try_allocate(head)
                if row is None:
                    break
                self._start_chunked(self.waiting.pop(0), row)
                continue
            group, denied = [], False
            while (self.waiting and len(group) < self.cfg.prefill_batch
                   and len(self.waiting[0].effective_prompt) <= big):
                row = self._try_allocate(self.waiting[0])
                if row is None:
                    denied = True
                    break
                req = self.waiting.pop(0)
                req.row = row
                group.append(req)
            if group:
                self._dispatch_prefill(group)
            if denied or not group:
                break
        self._step_chunked()

    # -- preemption -------------------------------------------------------
    def _maybe_preempt(self):
        """Evict decoding rows when the pool must shrink (a pressure
        window pushed occupancy over capacity) or a waiting request
        outranks the lowest-priority decoding row on a full pool."""
        if not self.cfg.preemption:
            return
        while (len(self.active) + len(self._chunking) > self._capacity()
               and self._preempt_one()):
            pass
        # priority eviction: one per iteration; admission takes the
        # freed row right after
        if self.waiting and not self._usable_free_rows() and self.active:
            best = max(r.priority for r in self.waiting)
            live = [r for r in self.active.values() if not r.done_s]
            if live and best > min(r.priority for r in live):
                self._preempt_one(max_priority=best - 1)

    def _preempt_one(self, max_priority: Optional[int] = None) -> bool:
        """Preempt the lowest-priority (then youngest) decoding row: its
        tokens so far are kept on the host, its row is released, and it
        re-enters the queue as a re-prefill over ``prompt + output``."""
        self._flush_pending()
        victims = [r for r in self.active.values()
                   if not r.done_s and r.output
                   and r.output[-1] != -100
                   and (max_priority is None
                        or r.priority <= max_priority)]
        if not victims:
            return False
        victim = min(victims, key=lambda r: (r.priority, -r._seq))
        self.active.pop(victim.row, None)
        self.cache.release(victim.row)
        self._gen[victim.row] = 0
        victim.row = -1
        victim.preemptions += 1
        victim._resume = np.concatenate(
            [np.asarray(victim.prompt, np.int32),
             np.asarray(victim.output, np.int32)])
        self.waiting.append(victim)
        self._stats["preempted"] += 1
        return True

    # -- prefill ----------------------------------------------------------
    def _dispatch_prefill(self, group: list):
        """One bucketed prefill call over a real batch of requests.

        Error boundary: an injected ``PoisonedRequest`` excises exactly
        the named request (it terminates as ``Failed``) and the dispatch
        retries with the survivors; an ``InjectedFault`` fails the whole
        group — never the engine.  The injector raises before anything is
        staged; any other error propagates."""
        while group:
            try:
                if self.faults is not None:
                    self.faults.check_dispatch(
                        "prefill", [r.rid for r in group])
            except PoisonedRequest as e:
                bad = next(r for r in group if r.rid == e.rid)
                self._fail_request(bad, e)
                group = [r for r in group if r is not bad]
                continue
            except InjectedFault as e:
                for req in group:
                    self._fail_request(req, f"prefill dispatch failed: {e}")
                return
            self._launch_prefill(group)
            return

    def _launch_prefill(self, group: list):
        bp = self._tier_for(len(group), self.prefill_tiers)
        prompts = [np.asarray(r.effective_prompt, np.int32) for r in group]
        bucket = self._bucket(max(len(p) for p in prompts))
        full = [len(pr) == bucket for pr in prompts]

        def fill(a):
            ids, rows, fl, last = self._group_views(a, bp, bucket)
            ids[:] = 0
            rows[:] = group[0].row          # padded slots alias rows[0]
            fl[:] = 0
            last[:] = 0
            for j, (req, pr) in enumerate(zip(group, prompts)):
                n = len(pr)
                ids[j, :n] = pr
                rows[j] = req.row
                fl[j] = full[j]
                last[j] = pr[n - 1]
        self._prefill_stage.put(fill, bp * (bucket + 3))
        if self._graphed:
            tok = self._group_graph("prefill", bp, bucket).replay()
            self._stats["prefill_graph_replays"] += 1
        else:
            tok = self._prefill_run(bp, bucket, self._prefill_stage.dev,
                                    self._last_ids, self.cache.caches)
        slots = []
        for j, (req, pr) in enumerate(zip(group, prompts)):
            n = len(pr)
            if req._resume is not None:
                self._stats["resumed"] += 1
            # tokens generated before a preemption count toward
            # max_new_tokens; a fresh request starts at 0
            self._gen[req.row] = len(req.output) + (1 if full[j] else 0)
            self.cache.lengths[req.row] = n if full[j] else n - 1
            self.active[req.row] = req
            if full[j]:
                slots.append((j, req))
            else:
                # bucket-padded: the cache holds [0, n-1); the first
                # decode step re-runs the last token at position n-1 and
                # yields the true next token (the -100 sentinel).
                req.output.append(-100)
        self._stats["prefill_steps"] += 1
        self._stats["prefill_reqs"] += len(group)
        self.dispatch_log.append(("prefill", tuple(r.rid for r in group)))
        if slots:
            self._pending_prefill.append((_Fetch(tok), slots))

    @staticmethod
    def _group_views(buf, b: int, width: int):
        """Four views of a flat staging buffer, host (numpy) or device
        (torch): a ``(b, width)`` id block and three ``(b,)`` vectors —
        prefill: rows, full flags, last tokens; chunk: offsets, rows,
        sentinel tokens (-1 on a chunk that is not a prompt's last)."""
        n = b * width
        return (buf[:n].reshape(b, width), buf[n:n + b],
                buf[n + b:n + 2 * b], buf[n + 2 * b:n + 3 * b])

    def _prefill_run(self, bp: int, bucket: int, inp, last_ids, caches):
        """One prefill group at ``(bp, bucket)`` over the given buffers,
        all in place: the forward, argmax, each slot's KV into its cache
        row and each slot's first token into ``last_ids``.  Slots are
        written one at a time in reversed order: padded slots alias
        ``rows[0]``, so slot 0's write lands last and wins
        (``index_copy_`` with repeated indices in one call is not
        ordered).  Returns the (bp,) argmax tokens.  This is what a
        prefill group's CUDA Graph captures."""
        fwd = self._forward("prefill", bp, bucket)
        ids, rows, full, sent_last = self._group_views(inp, bp, bucket)
        rows = rows.long()
        pos = torch.arange(bucket, dtype=torch.int32,
                           device=ids.device).expand(bp, bucket)
        out = fwd(self.params, {"ids": ids, "positions": pos})
        tok = out["logits"][:, -1, :].argmax(-1).to(torch.int32)
        bds = self.cache.batch_dims
        for j in reversed(range(bp)):
            r = rows[j:j + 1]
            for pk, pv, dk, dv in self._ck:
                for src, dst in ((pk, dk), (pv, dv)):
                    d = 1 if bds[dst] else 0    # (L, B, S, ...) or (B, S, ...)
                    c = caches[dst].narrow(d + 1, 0, bucket)
                    c.index_copy_(d, r, out[src].narrow(d, j, 1).to(c.dtype))
        first = torch.where(full.bool(), tok, sent_last)
        for j in reversed(range(bp)):
            last_ids.index_copy_(0, rows[j:j + 1], first[j:j + 1, None])
        return tok

    def _group_graph(self, kind: str, b: int, width: int) -> GraphStep:
        """The ``(b, width)`` prefill or chunk group as one CUDA Graph
        over the engine's buffers, warmed first on copies of the ones it
        writes."""
        run, stage = ((self._prefill_run, self._prefill_stage)
                      if kind == "prefill"
                      else (self._chunk_run, self._chunk_stage))

        def build():
            def warm():
                caches = {k: v.clone() for k, v in self.cache.caches.items()}
                run(b, width, stage.dev, self._last_ids.clone(), caches)

            g = GraphStep(
                lambda: run(b, width, stage.dev, self._last_ids,
                            self.cache.caches),
                warm, stream=self._capture_stream, pool=self._pool)
            self._stats[f"{kind}_graph_captures"] += 1
            self._stats[f"{kind}_capture_s"] += g.capture_s
            return g
        return self._graph_step((kind, b, width), build)

    # -- chunked prefill --------------------------------------------------
    def _chunk_plan(self, n: int) -> list:
        """Chunk schedule ``[(offset, chunk_len)]`` filling the cache up
        to position ``n - 1`` (the sentinel decode step recomputes the
        final prompt position and yields the first token).  Chunk lengths
        are prefill buckets, so their steps share the decode structure;
        the final chunk may overhang ``n - 1`` (the padding is masked by
        the offsets) but never ``s_max``: ``_write_time`` asserts a
        cache write past ``s_max`` on the device, where it would corrupt
        the row."""
        buckets = self.cfg.prefill_buckets
        big = buckets[-1]
        chunks, off, target = [], 0, n - 1
        while off < target:
            rem = target - off
            c = big if rem >= big else next(b for b in buckets if b >= rem)
            if off + c > self.cfg.s_max:
                fits = [b for b in buckets
                        if b >= rem and off + b <= self.cfg.s_max]
                if not fits:
                    raise UnchunkablePrompt(
                        f"prompt length {n} cannot be chunk-prefilled "
                        f"within s_max={self.cfg.s_max} with buckets "
                        f"{buckets}")
                c = fits[0]
            chunks.append((off, c))
            off += c
        return chunks

    def _start_chunked(self, req: Request, row: int):
        """Stage a prompt longer than the largest bucket for chunked
        prefill: bind its (allocated) row and queue its chunk schedule;
        ``_step_chunked`` dispatches one chunk group per iteration."""
        req.row = row
        prompt = np.asarray(req.effective_prompt, np.int32)
        n = len(prompt)
        try:
            chunks = self._chunk_plan(n)
        except UnchunkablePrompt as e:
            # a resumed prompt grew past submit-time validation
            self._fail_request(req, e)
            return
        if req._resume is not None:
            self._stats["resumed"] += 1
        # the chunks cover [0, n-1) and may fall one token short of the
        # prompt, so the staging copy is the longer of the two
        padded = np.zeros(max(n, chunks[-1][0] + chunks[-1][1]), np.int32)
        padded[:n] = prompt
        self._chunking.append({"req": req, "prompt": prompt,
                               "padded": padded, "chunks": chunks,
                               "next": 0})

    def _step_chunked(self):
        """Dispatch the pending chunk of the round-robin head, packed
        with every other in-progress chunked prefill whose next chunk has
        the same length (one call over a real batch, padded to a
        power-of-two group tier; padded slots duplicate slot 0, so their
        writes are identical).  When a request's final chunk is in flight
        it joins ``active`` and its first token comes from the sentinel
        decode step.  No host sync.  An injected dispatch fault fails
        exactly the packed requests."""
        if not self._chunking:
            return
        head = self._chunking.pop(0)
        c = head["chunks"][head["next"]][1]
        batch, keep = [head], []
        for st in self._chunking:
            if (len(batch) < self.cfg.prefill_batch
                    and st["chunks"][st["next"]][1] == c):
                batch.append(st)
            else:
                keep.append(st)
        self._chunking = keep
        try:
            if self.faults is not None:
                self.faults.check_dispatch(
                    "chunk", [st["req"].rid for st in batch])
        except INJECTED as e:
            for st in batch:
                self._fail_request(st["req"], f"chunk dispatch failed: {e}")
            return
        bc = self._tier_for(len(batch), self.prefill_tiers)
        offs = [st["chunks"][st["next"]][0] for st in batch]
        final = [st["next"] + 1 == len(st["chunks"]) for st in batch]

        def fill(a):
            ids, off, rows, last = self._group_views(a, bc, c)
            for j, st in enumerate(batch):
                ids[j] = st["padded"][offs[j]:offs[j] + c]
                off[j] = offs[j]
                rows[j] = st["req"].row
                last[j] = st["prompt"][-1] if final[j] else -1
            for j in range(len(batch), bc):
                ids[j], off[j], rows[j], last[j] = \
                    ids[0], off[0], rows[0], last[0]
        self._chunk_stage.put(fill, bc * (c + 3))
        if self._graphed:
            self._group_graph("chunk", bc, c).replay()
            self._stats["chunk_graph_replays"] += 1
        else:
            self._chunk_run(bc, c, self._chunk_stage.dev, self._last_ids,
                            self.cache.caches)
        self._stats["chunk_steps"] += 1
        self.dispatch_log.append(
            ("chunk", tuple(st["req"].rid for st in batch)))
        for j, st in enumerate(batch):
            req, row = st["req"], st["req"].row
            st["next"] += 1
            if not final[j]:
                # keep the host length mirror at the chunk frontier: a
                # decode step before the next chunk writes one garbage
                # K/V here for the (inactive) row, and the next chunk's
                # write covers it
                self.cache.lengths[row] = offs[j] + c
                self._chunking.append(st)      # round-robin: to the back
                continue
            self.cache.lengths[row] = len(st["prompt"]) - 1
            self._gen[row] = len(req.output)
            req.output.append(-100)
            self.active[row] = req

    def _chunk_run(self, bc: int, chunk: int, inp, last_ids, caches):
        """One chunk group at ``(bc, chunk)`` over the given buffers, all
        in place: gather each slot's row of every cache, run the decode
        forward at query width ``chunk`` from each slot's offset, write
        the rows back in reversed slot order (padded slots duplicate
        slot 0, so slot 0 lands last) and, for a slot on its prompt's
        final chunk, its sentinel token into ``last_ids``.  This is what
        a chunk group's CUDA Graph captures."""
        fwd = self._forward("chunk", bc, chunk)
        ids, offs, rows, last = self._group_views(inp, bc, chunk)
        rows = rows.long()
        pos = offs[:, None] + torch.arange(chunk, dtype=torch.int32,
                                           device=ids.device)
        bds = self.cache.batch_dims
        rcaches = {k: v.index_select(bds[k], rows) for k, v in caches.items()}
        out = fwd(self.params, {"ids": ids, "positions": pos,
                                "cache_len": offs, **rcaches})
        for j in reversed(range(bc)):
            r = rows[j:j + 1]
            for k, c in caches.items():
                c.index_copy_(bds[k], r, out[k].narrow(bds[k], j, 1)
                              .to(c.dtype))
            sent = last[j:j + 1, None]
            last_ids.index_copy_(0, r, torch.where(
                sent >= 0, sent, last_ids.index_select(0, r)))

    # -- steps --------------------------------------------------------------
    def _forward(self, phase: str, batch: int, seq: int):
        """The step of ``phase`` ("prefill", "decode" or "chunk" — the
        decode structure at query width ``seq``) at ``batch``."""
        key = (phase, batch, seq, self.cfg.lowered, self._graphed)
        fwd = self._steps.get(key)
        if fwd is None:
            graph_phase = "decode" if phase == "chunk" else phase
            q_len = 1 if phase == "decode" else seq
            segs, _ = self.model.build_segments(graph_phase, batch, q_len,
                                                s_max=self.cfg.s_max)
            info = ScheduleContext(
                local_batch=batch,
                seq_len=self.cfg.s_max if phase == "chunk" else seq,
                phase=graph_phase, arch=self.model.cfg.name)
            before = dict(self.store.stats)
            fwd = self._steps[key] = build_forward(
                segs, self.scheduler, info, lowered=self.cfg.lowered,
                plan_cache=self.store if self.cfg.lowered else None,
                op_config=self._op_config, capture=self._graphed)
            if phase == "decode":
                st = self.store.stats
                self._stats["tier_builds"][batch] = {
                    k: st[k] - before[k]
                    for k in ("misses", "shares", "restore_hits")}
        return fwd

    def _graph_step(self, key: tuple, build) -> GraphStep:
        """The graph under ``key`` in the store's executable level (keys
        name this engine: ``(kind, ("engine", serial), ...)``), captured
        by ``build()`` on a miss."""
        return self.store.get_or_build(
            (key[0], ("engine", self._serial)) + key[1:], build)

    # -- decode -----------------------------------------------------------
    def _compact(self, tier: int):
        """Restore the prefix invariant: every allocated row < tier —
        decoding requests and in-progress chunked prefills, whose
        partly filled rows move the same way."""
        chunk_rows = {st["req"].row: st for st in self._chunking}
        occupied = sorted((r for r in (*self.active, *chunk_rows)
                           if r >= tier), reverse=True)
        for src in occupied:
            dst = next(r for r in self.cache.free_rows if r < tier)
            self.cache.move_row(src, dst)
            self._last_ids[dst] = self._last_ids[src]
            self._gen[dst] = self._gen[src]
            if src in self.active:
                req = self.active.pop(src)
                req.row = dst
                self.active[dst] = req
            else:
                chunk_rows[src]["req"].row = dst
            self._stats["row_moves"] += 1

    def _decode_run(self, tier: int, last_ids, step_in, caches):
        """One decode step at ``tier`` over the given buffers, all in
        place: the forward over the tier's views, the cache updates,
        argmax, the masks, and the write of the next ids into
        ``last_ids``.  Returns the (2, max_batch) tok/done tensor.  This
        is what a tier's CUDA Graph captures."""
        fwd = self._forward("decode", tier, self.cfg.s_max)
        flags, clen = step_in[:3], step_in[3, :tier]
        bds = self.cache.batch_dims
        tcaches = {k: v.narrow(bds[k], 0, tier) for k, v in caches.items()}
        out = fwd(self.params, {"ids": last_ids[:tier],
                                "positions": clen[:, None],
                                "cache_len": clen, **tcaches})
        for k, c in tcaches.items():
            if out[k].data_ptr() != c.data_ptr():
                c.copy_(out[k])
        tok_t = out["logits"][:, -1, :].argmax(-1).to(torch.int32)
        prev = last_ids[:, 0]
        tok = prev.clone()
        tok[:tier] = tok_t
        active = flags[0].bool()
        tok = torch.where(active, tok, prev)
        done = active & (flags[1].bool() | (tok == flags[2]))
        prev.copy_(tok)
        return torch.stack([tok, done.to(torch.int32)])

    def _graph(self, tier: int) -> GraphStep:
        """The tier's step as one CUDA Graph over the engine's buffers,
        warmed first on copies of them."""
        def build():
            bds = self.cache.batch_dims

            def warm():
                caches = {k: v.narrow(bds[k], 0, tier).clone()
                          for k, v in self.cache.caches.items()}
                self._decode_run(tier, self._last_ids.clone(),
                                 self._step_in.clone(), caches)

            g = GraphStep(
                lambda: self._decode_run(tier, self._last_ids, self._step_in,
                                         self.cache.caches),
                warm, stream=self._capture_stream, pool=self._pool)
            self._stats["graph_captures"] += 1
            self._stats["capture_s"] += g.capture_s
            return g
        return self._graph_step(("decode", tier), build)

    def _stage_step_in(self, flags: np.ndarray):
        """Flags and cache lengths into ``_step_in``: one copy from
        pinned staging on CUDA."""
        def fill(a):
            a = a.reshape(4, -1)
            a[:3] = flags
            a[3] = self.cache.lengths
        self._step_stage.put(fill, self._step_in.numel())

    def _dispatch_decode(self):
        """Dispatch one decode step at the smallest tier covering every
        allocated row (chunking rows ride in the prefix, inactive).
        Returns ``(fetch, snapshot)`` for the harvest.

        Error boundary: an injected ``PoisonedRequest`` fails exactly
        that row and the dispatch retries with the survivors; an
        ``InjectedFault`` fails the rows of this dispatch (the batch,
        never the engine).  Any other error propagates."""
        while self.active:
            B = self.cfg.max_batch
            occ = len(self.active) + len(self._chunking)
            self._stats["peak_active"] = max(self._stats["peak_active"],
                                             occ)
            tier = self._tier_for(occ, self.tiers)
            self._compact(tier)
            flags = np.zeros((3, B), np.int32)     # active, will_end, eos
            flags[2] = -1
            snapshot = []
            for row, req in self.active.items():
                flags[0, row] = 1
                flags[1, row] = (self._gen[row] + 1 >= req.max_new_tokens
                                 or self.cache.lengths[row] + 1
                                 >= self.cfg.s_max - 1)
                flags[2, row] = req.eos_id
                snapshot.append((row, req))
            try:
                if self.faults is not None:
                    self.faults.check_dispatch(
                        "decode", [r.rid for _, r in snapshot])
            except PoisonedRequest as e:
                bad = next(r for _, r in snapshot if r.rid == e.rid)
                self._fail_request(bad, e)
                continue
            except InjectedFault as e:
                for _, req in snapshot:
                    self._fail_request(req, f"decode dispatch failed: {e}")
                return None
            graph = self._graph(tier) if self._graphed else None
            self._stage_step_in(flags)
            if graph is not None:
                out = graph.replay()
                self._stats["graph_replays"] += 1
            else:
                out = self._decode_run(tier, self._last_ids, self._step_in,
                                       self.cache.caches)
            # host mirrors advance at dispatch, not harvest
            for row, _ in snapshot:
                self.cache.lengths[row] += 1
                self._gen[row] += 1
            self._stats["decode_steps"] += 1
            self._stats["tier_steps"][tier] += 1
            return (_Fetch(out), snapshot)
        return None

    def _harvest(self, pending):
        """The loop's single host sync: wait for the pending decode step's
        token/done vector and any prefill first-token vectors, then run
        the host bookkeeping, each request inside its own error boundary
        (an injected harvest fault fails that request alone)."""
        prefills, self._pending_prefill = self._pending_prefill, []
        if pending is None and not prefills:
            return
        got = [f.wait() for f, _ in prefills]
        vals = pending[0].wait() if pending is not None else None
        self._stats["host_syncs"] += 1
        now = time.perf_counter()
        for (_, slots), toks in zip(prefills, got):
            for j, req in slots:
                if req.done_s:
                    continue
                try:
                    if self.faults is not None:
                        self.faults.check_harvest(req.rid)
                    req.output.append(int(toks[j]))
                    if not req.first_token_s:
                        req.first_token_s = now
                    if (len(req.output) >= req.max_new_tokens
                            or req.output[-1] == req.eos_id):
                        self._finish(req, now)
                    elif self._deadline_blown(req, now):
                        self._fail_deadline(req, now)
                except INJECTED as e:
                    self._fail_request(req, f"harvest failed: {e}")
        if pending is None:
            return
        tok, done = vals[0], vals[1]
        for row, req in pending[1]:
            if req.done_s:       # finished by an earlier harvest: the
                continue         # in-flight step decoded a stale row
            try:
                if self.faults is not None:
                    self.faults.check_harvest(req.rid)
                t = int(tok[row])
                if req.output and req.output[-1] == -100:
                    req.output[-1] = t     # sentinel: first real token
                    if not req.first_token_s:
                        req.first_token_s = now
                else:
                    req.output.append(t)
                self._stats["decode_tokens"] += 1
                if done[row]:
                    self._finish(req, now)
                elif self._deadline_blown(req, now):
                    self._fail_deadline(req, now)
            except INJECTED as e:
                self._fail_request(req, f"harvest failed: {e}")

    def _cache_keys(self):
        """[(prefill_k, prefill_v, decode_k_cache, decode_v_cache)]."""
        out = []
        for ps, ds in zip(self.model.layer_stacks("prefill"),
                          self.model.layer_stacks("decode")):
            pname, _, pcount, _, psc_out = ps[:5]
            if "k" not in psc_out:
                continue
            popts = ps[5] if len(ps) > 5 else {}
            omap = popts.get("output_map", {})
            dopts = ds[5] if len(ds) > 5 else {}
            imap = dopts.get("input_map", {})
            pk = omap.get("k", f"{pname}.k" if pcount > 1 else "k")
            pv = omap.get("v", f"{pname}.v" if pcount > 1 else "v")
            out.append((pk, pv, imap.get("k_cache", "k_cache"),
                        imap.get("v_cache", "v_cache")))
        return out


def _first_leaf(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            leaf = _first_leaf(v)
            if leaf is not None:
                return leaf
        return None
    return tree
