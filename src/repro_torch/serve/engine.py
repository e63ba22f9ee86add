"""Tiered serving engine: batched bucketed prefill, chunked prefill
through the decode graph, power-of-two decode tiers with row compaction,
a dense or paged KV cache, greedy or sampled decode on the device, a
double-buffered host loop with one host sync per decode iteration (or a
synchronous one), and a request lifecycle (admission control,
deadlines, preempt-and-requeue, fault isolation, drain).

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
  * **Paged KV cache** (``ServeConfig.cache``, ``serve/kv_cache.py``).
    With ``PagedCache`` the caches are a shared pool of pages and each
    row a page table: admission reserves the effective prompt's pages
    plus one (a shortfall keeps the request waiting and counts
    ``page_denied``), each decode dispatch first reserves every active
    row's next page (``_ensure_decode_pages``: on exhaustion the
    lowest-priority row is preempted, or the rows that cannot be served
    fail), and compaction hands page-table rows over with no device
    copy.  A step gathers its rows' pages into the dense ``(b, s_max,
    ...)`` view, runs the unchanged forward, and writes back only the
    pages it wrote: the frontier page per row after decode, each slot's
    bucket (prefill) or chunk pages.  The page table reaches the graphs
    through the staged buffers on every dispatch.  Models with
    recurrent decode state raise ``UnpageableCache``.
  * **Sampling** (``ServeConfig.sampling``, ``serve/sampling.py``).
    Greedy (``None`` or ``SamplingConfig()``) is an argmax; temperature,
    top-k and top-p draw with Gumbel-max from Philox bits keyed by
    ``(seed, rid, position)``, inside the same captured steps, the row
    seeds and rids staged beside the flags (``Request.seed`` over
    ``ServeConfig.seed``).  The policy salts the graphs' keys; seeds
    never do.
  * **Async host loop.**  Sampling and the eos/length masks run on the
    device; sampled tokens chain into the next step through a device
    ``last_ids`` vector.  Each step's small token/done vector is copied to
    pinned host memory as soon as it is enqueued, behind an event; the
    loop dispatches step k+1 before it waits on step k's event — one host
    sync per decode iteration.  ``async_host=False`` harvests each step
    right after its dispatch, as the JAX engine's synchronous loop does.
  * **One CUDA Graph per decode tier, prefill group and chunk group**
    (``ServeConfig.lowered``, the default).  A tier's whole step — the
    forward over the lowered slot IR, the cache updates, sampling, the
    masks and the write of the next ids — is captured once
    (``core/capture.py``) over buffers the engine owns and never
    reassigns: ``_last_ids``, the caches, and ``_step_in``, whose rows
    are the (active, will_end, eos) flags, the cache lengths and the row
    seeds and rids (and, paged, the page table ``_step_pages`` after
    them).  A step's host work is then one copy of that buffer from
    pinned staging, ``replay()``, and the fetch of tok/done.  A prefill
    group of one ``(bp, bucket)`` is captured the same way: its ids,
    rows, full flags, last tokens, seeds, rids and page rows are staged
    into one fixed device buffer, and the graph writes the cache rows
    (pages) and ``_last_ids`` with ``index_copy_`` one slot at a time,
    in reversed slot order, so that slot 0's write lands last, as the
    JAX engine's does.  A chunk group of one ``(bc, chunk)`` reads its
    ids, offsets, rows, sentinel tokens and page rows from a fixed
    buffer likewise: it gathers its rows of every cache, runs the decode
    forward at ``(bc, chunk)``, and writes the rows (pages) and, on a
    final chunk, the row's ``_last_ids`` back in reversed slot order.
    A graph is built on its first use, or ahead of
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
  * **Speculative decode** (``ServeConfig.spec``, ``serve/speculative.py``).
    A proposer drafts k tokens a row — ``ngram`` on the host, staged with
    the flags in the step's one copy; ``self`` on the device, as k
    width-1 passes through the first layers of the model, captured as
    one draft graph per ``(tier, k)`` whose output buffer the verify
    graph reads — and one verify step runs the decode forward at query
    width ``W = k + 1`` (the chunk step's structure), samples every
    position with the key plain decode would use, and accepts the
    longest matching draft prefix plus one token, cut at eos, the token
    budget and ``s_max``, all inside its graph.  Spec steps harvest at
    once (how far a row moved is the data-dependent accepted count):
    one copy of ``(u, n_emit, done)`` a step.  A rejected tail is rolled
    back as length bookkeeping (paged: its pages go back to the pool).
    A step that cannot speculate — no headroom of W positions, no pages
    for them, an injected allocation denial — falls back to plain decode
    (``spec_fallbacks``).  ``k="auto"`` asks the policy's
    ``spec_draft_k`` (``core/autotune.py``), which the engine feeds
    with each step's acceptance and time.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
import weakref
from typing import Optional

import numpy as np
import torch

from ..core.capture import GraphStep, Staged
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
from .kv_cache import cache_backend_salt, resolve_cache_backend
from .sampling import resolve_sampling, sample_tokens, sampling_salt
from .speculative import DRAFT_K_CANDIDATES, SpecConfig, resolve_proposer


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
    seed: Optional[int] = None             # sampling seed (None: engine's)
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
    # On-device sampling policy (serve/sampling.py): a SamplingConfig, or
    # None for greedy argmax.  The policy salts the graphs' keys; seeds
    # never do.
    sampling: object = None
    # Engine-wide sampling seed; Request(seed=) overrides it per request.
    seed: int = 0
    # Speculative multi-token decode (serve/speculative.py): a SpecConfig,
    # or None for plain one-token decode.  The verify step is the decode
    # forward at query width k+1 — another shape bucket of the decode
    # lowering, so it specializes with no new lowering.
    spec: object = None
    # KV storage backend (serve/kv_cache.py): a CacheBackend, the names
    # "dense" / "paged", or None for DenseCache.  Its identity salts
    # every PlanStore key.
    cache: object = None
    # Double-buffered host loop: dispatch step k+1 before fetching step
    # k's tokens.  False harvests every step synchronously.
    async_host: bool = True
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


_SERIAL = itertools.count()


def _graphs_of(serial: int):
    """Predicate over executable keys: the graphs of engine ``serial``."""
    mine = ("engine", serial)
    return lambda key: len(key) > 1 and key[1] == mine


# families whose steps take inputs the engine does not feed (it stages
# ids, (B, S) positions and the caches only): the JAX package's engine
# fails on both too, the encoder-decoder at construction and the VLM at
# its first prefill
UNSERVED_FAMILIES = {
    "encdec": "its prefill takes `frames` and its decode the encoder "
              "states `enc`",
    "vlm": "its prefill takes `vis` and its positions are M-RoPE's "
           "(3, B, S) streams",
}


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
        family = model.cfg.family
        if family in UNSERVED_FAMILIES:
            raise NotImplementedError(
                f"ServeEngine does not serve the {family!r} family "
                f"({model.cfg.name}): {UNSERVED_FAMILIES[family]}")
        self.model = model
        self.params = params
        if isinstance(scheduler, str):
            # one policy object for every step: a stateful policy (auto)
            # must keep its verdicts and observations across builds
            from ..core.policy import as_policy
            scheduler = as_policy(scheduler)
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
        self.backend = resolve_cache_backend(cfg.cache)
        self.cache = self.backend.build(model, cfg, self.device)
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
        # identity salts the store's outer keys, and a digest of it the
        # steps' and graphs' keys; the sampling policy is baked into a
        # graph, so its salt enters the decode and prefill graphs' keys
        self._op_config = model.op_closure_config() + (
            ("cache_backend", self.backend.identity()),)
        self._cache_tag = cache_backend_salt(self.backend)
        self.sampling = resolve_sampling(cfg.sampling)
        self._samp_salt = sampling_salt(self.sampling)
        # store-aware policies (AutoPolicy, or a PolicyScheduler over one)
        # persist their verdicts in this engine's store and take live
        # step timings
        target = getattr(scheduler, "policy", scheduler)
        bind = getattr(target, "bind_store", None)
        if callable(bind):
            bind(self.store)
        self._observer = getattr(target, "observe", None)
        self._obs_prev = None      # (tier, perf_counter) of the last dispatch
        self._init_spec(cfg, target)
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
        # page-table entries a row (0: the dense cache has no table)
        self._bpr = self.cache.blocks_per_row if self.cache.paged else 0
        self._last_ids = torch.zeros((B, 1), dtype=torch.int32,
                                     device=self.device)
        # decode: (active, will_end, eos) flags, cache lengths, row seeds
        # and rids, (6, B) — a verify step reads its rows' token budgets
        # where plain decode reads will_end; paged, then the page table
        # (B, blocks a row); with a host proposer, then the drafts (B, k)
        kd = self._kmax if self._spec is not None \
            and not self._proposer.device else 0
        self._step_stage = Staged(B * (6 + self._bpr + kd), self.device)
        self._step_in = self._step_stage.dev[:6 * B].view(6, B)
        self._step_pages = self._step_stage.dev[
            6 * B:B * (6 + self._bpr)].view(B, self._bpr)
        # the drafts the verify graph reads: staged from the host, or
        # written by the draft graph and never leaving the card
        self._drafts = (self._step_stage.dev[B * (6 + self._bpr):]
                        .view(B, kd) if kd else
                        torch.zeros((B, self._kmax), dtype=torch.int32,
                                    device=self.device))
        # prefill: ids, rows, full flags, last tokens, seeds, rids and
        # page rows of one group; chunk: ids, offsets, rows, sentinel
        # tokens (seeds, rids unused) and page rows of one chunk group;
        # laid out per (bp, bucket) / (bc, chunk) by _group_views
        group = self.prefill_tiers[-1] * (big + 5 + self._bpr)
        self._prefill_stage = Staged(group, self.device)
        self._chunk_stage = Staged(group, self.device)
        cuda = self.device.type == "cuda"
        self._graphed = cfg.lowered and cuda
        self._capture_stream = torch.cuda.Stream(self.device) \
            if self._graphed else None
        # one graph pool for all of this engine's graphs (core/capture.py:
        # its replays run in series and each output is read at once)
        self._pool = torch.cuda.graph_pool_handle() if self._graphed \
            else None
        self._gen = np.zeros((cfg.max_batch,), np.int32)   # tokens sampled
        # per-row sampling identity, moved by _compact with _gen
        self._row_seed = np.zeros((cfg.max_batch,), np.uint32)
        self._row_rid = np.zeros((cfg.max_batch,), np.int32)
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
                       "alloc_denied": 0, "page_denied": 0,
                       "peak_active": 0,
                       "stranded": 0, "drains": 0,
                       "graph_captures": 0, "graph_replays": 0,
                       "capture_s": 0.0, "prefill_graph_captures": 0,
                       "prefill_graph_replays": 0, "prefill_capture_s": 0.0,
                       "chunk_graph_captures": 0, "chunk_graph_replays": 0,
                       "chunk_capture_s": 0.0,
                       "spec_steps": 0, "spec_drafted": 0,
                       "spec_accepted": 0, "spec_rollbacks": 0,
                       "spec_fallbacks": 0, "spec_builds": {},
                       "spec_graph_captures": 0, "spec_capture_s": 0.0,
                       "verify_graph_replays": 0,
                       "draft_graph_replays": 0,
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
        if self.cache.paged and (self.cache.pages_needed(n + 1)
                                 > self.cache.num_pages):
            raise PromptOverflow(
                f"prompt length {n} needs "
                f"{self.cache.pages_needed(n + 1)} KV pages but the pool "
                f"holds only {self.cache.num_pages} in total")
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
        handle = self._dispatch_decode()
        if self._spec is not None:
            # speculative steps harvest at once: how far each row moved
            # (the accepted count) is data-dependent, so the host mirrors
            # cannot advance at dispatch.  Still one sync an iteration.
            self._harvest(handle)
        elif self.cfg.async_host:
            # double-buffered: step k+1 is in flight before step k's
            # harvest
            prev, self._pending = self._pending, handle
            self._harvest(prev)
        else:
            self._harvest(handle)
        return self._busy()

    def warmup(self, tiers: Optional[tuple] = None, prefill=(), chunks=()):
        """Build decode tiers' steps (every tier when ``tiers`` is None or
        empty) with, under ``ServeConfig.spec``, each tier's verify step
        at every draft length it may run (and the draft step of a device
        proposer), the prefill steps of the given ``(group tier, bucket)``
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
            if self._spec is not None:
                # after the decode step: the canonical decode lowering
                # exists, so verify widths purely specialize
                ks = ([self._spec.k] if isinstance(self._spec.k, int)
                      else list(self._k_candidates))
                for k in ks:
                    self._spec_forwards(t, k)
                    if self._graphed:
                        self._spec_graph("verify", t, k)
                        if self._proposer.device:
                            self._spec_graph("draft", t, k)
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
        out["spec_builds"] = dict(self._stats["spec_builds"])
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
        row = self.cache.allocate(req.rid)
        if row is None:
            return None
        # a paged row reserves the whole (effective) prompt's pages up
        # front, so a chunked prefill never runs out mid prompt; the +1
        # is the first decode write, at position len(prompt).  A
        # shortfall keeps the request waiting (a dense row always fits)
        if not self.cache.reserve(row, len(req.effective_prompt) + 1):
            self.cache.release(row)
            self._stats["page_denied"] += 1
            return None
        return row

    def _req_seed(self, req: Request) -> np.uint32:
        return np.uint32(req.seed if req.seed is not None
                         else self.cfg.seed)

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
        for req in group:
            self._row_seed[req.row] = self._req_seed(req)
            self._row_rid[req.row] = req.rid
        if self.cache.paged:
            self.cache.check_unaliased(
                self.cache.page_table[[r.row for r in group]])

        def fill(a):
            ids, rows, fl, last, seeds, rids, pages = \
                self._group_views(a, bp, bucket)
            ids[:] = 0
            fl[:] = 0
            last[:] = 0
            # padded slots alias slot 0 (its row, seed, rid and pages)
            for j in range(bp):
                req = group[j if j < len(group) else 0]
                rows[j] = req.row
                seeds[j] = self._row_seed.view(np.int32)[req.row]
                rids[j] = req.rid
                if self._bpr:
                    pages[j] = self.cache.page_table[req.row]
                if j < len(group):
                    ids[j, :len(prompts[j])] = prompts[j]
                    fl[j] = full[j]
                    last[j] = prompts[j][-1]
        self._prefill_stage.put(fill, self._group_len(bp, bucket))
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

    def _group_len(self, b: int, width: int) -> int:
        return b * (width + 5 + self._bpr)

    def _group_views(self, buf, b: int, width: int):
        """Views of a flat staging buffer, host (numpy) or device (torch):
        a ``(b, width)`` id block, five ``(b,)`` vectors — prefill: rows,
        full flags, last tokens; chunk: offsets, rows, sentinel tokens
        (-1 on a chunk that is not a prompt's last); then seeds and rids
        — and the slots' page-table rows ``(b, blocks a row)`` (empty on
        the dense cache)."""
        n = b * width
        vec = [buf[n + i * b:n + (i + 1) * b] for i in range(5)]
        pages = buf[n + 5 * b:self._group_len(b, width)]
        return (buf[:n].reshape(b, width), *vec,
                pages.reshape(b, self._bpr))

    def _prefill_run(self, bp: int, bucket: int, inp, last_ids, caches):
        """One prefill group at ``(bp, bucket)`` over the given buffers,
        all in place: the forward, sampling, each slot's KV into its
        cache row (paged: its pages; the bucket's blocks past the pages
        reserved go to the trash page) and each slot's first token into
        ``last_ids``.  Slots are written one at a time in reversed order:
        padded slots alias slot 0, so slot 0's write lands last and wins
        (``index_copy_`` with repeated indices in one call is not
        ordered).  A full bucket emits position ``bucket``; the tokens of
        the other slots are not used.  Returns the (bp,) tokens.  This is
        what a prefill group's CUDA Graph captures."""
        fwd = self._forward("prefill", bp, bucket)
        ids, rows, full, sent_last, seeds, rids, pages = \
            self._group_views(inp, bp, bucket)
        rows = rows.long()
        pos = torch.arange(bucket, dtype=torch.int32,
                           device=ids.device).expand(bp, bucket)
        out = fwd(self.params, {"ids": ids, "positions": pos})
        tok = sample_tokens(out["logits"][:, -1, :], self.sampling,
                            seeds=seeds, rids=rids, positions=bucket)
        cache = self.cache
        bds = cache.batch_dims
        for j in reversed(range(bp)):
            r = rows[j:j + 1]
            for pk, pv, dk, dv in self._ck:
                for src, dst in ((pk, dk), (pv, dv)):
                    d = 1 if bds[dst] else 0    # (L, B, S, ...) or (B, S, ...)
                    if cache.paged:
                        cache.scatter_row_pages(
                            {dst: caches[dst]}, {dst: out[src]}, pages[j],
                            0, bucket // cache.page_size, row=j)
                        continue
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
        salts = ((self._cache_tag, self._samp_salt) if kind == "prefill"
                 else (self._cache_tag,))
        return self._graph_step((kind, *salts, b, width), build)

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
        self._row_seed[row] = self._req_seed(req)
        self._row_rid[row] = req.rid
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
        if self.cache.paged:
            self.cache.check_unaliased(
                self.cache.page_table[[st["req"].row for st in batch]])

        def fill(a):
            ids, off, rows, last, _, _, pages = self._group_views(a, bc, c)
            # padded slots duplicate slot 0: identical writes
            for j in range(bc):
                i = j if j < len(batch) else 0
                st, o = batch[i], offs[i]
                ids[j] = st["padded"][o:o + c]
                off[j] = o
                rows[j] = st["req"].row
                last[j] = st["prompt"][-1] if final[i] else -1
                if self._bpr:
                    pages[j] = self.cache.page_table[st["req"].row]
        self._chunk_stage.put(fill, self._group_len(bc, c))
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
        ids, offs, rows, last, _, _, pages = self._group_views(inp, bc, chunk)
        rows = rows.long()
        pos = offs[:, None] + torch.arange(chunk, dtype=torch.int32,
                                           device=ids.device)
        cache = self.cache
        bds = cache.batch_dims
        if cache.paged:
            rcaches = cache.gather_row_batch(caches, pages)
        else:
            rcaches = {k: v.index_select(bds[k], rows)
                       for k, v in caches.items()}
        out = fwd(self.params, {"ids": ids, "positions": pos,
                                "cache_len": offs, **rcaches})
        for j in reversed(range(bc)):
            r = rows[j:j + 1]
            if cache.paged:
                # chunk offsets are bucket sums and buckets whole pages
                # (checked at the backend's build): each slot writes
                # chunk / page whole blocks from its offset
                ps = cache.page_size
                cache.scatter_row_pages(caches, out, pages[j],
                                        offs[j:j + 1].long() // ps,
                                        chunk // ps, row=j)
            else:
                for k, c in caches.items():
                    c.index_copy_(bds[k], r, out[k].narrow(bds[k], j, 1)
                                  .to(c.dtype))
            sent = last[j:j + 1, None]
            last_ids.index_copy_(0, r, torch.where(
                sent >= 0, sent, last_ids.index_select(0, r)))

    # -- steps --------------------------------------------------------------
    def _forward(self, phase: str, batch: int, seq: int):
        """The step of ``phase`` ("prefill", "decode" or "chunk" — the
        decode structure at query width ``seq``) at ``batch``.  Engines
        of one program share it whatever their cache backend or sampling
        policy: a step reads the dense ``(b, s_max, ...)`` views either
        way, and sampling follows it."""
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
        name this engine: ``(kind, ("engine", serial), ...)``, then the
        JAX engine's salts: the cache tag, and the sampling salt of a
        prefill or decode graph), captured by ``build()`` on a miss."""
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
            self._row_seed[dst] = self._row_seed[src]
            self._row_rid[dst] = self._row_rid[src]
            if src in self.active:
                req = self.active.pop(src)
                req.row = dst
                self.active[dst] = req
            else:
                chunk_rows[src]["req"].row = dst
            self._stats["row_moves"] += 1

    def _tier_caches(self, tier: int, caches: dict, pages) -> dict:
        """The tier's rows of every cache: views of the dense caches, or
        the paged rows gathered into a fresh dense view."""
        if self.cache.paged:
            return self.cache.gather_rows(caches, pages, tier)
        bds = self.cache.batch_dims
        return {key: v.narrow(bds[key], 0, tier) for key, v in caches.items()}

    def _decode_run(self, tier: int, last_ids, step_in, caches, pages):
        """One decode step at ``tier`` over the given buffers, all in
        place: the forward over the tier's views (paged: its rows' pages
        gathered into them), the cache updates (paged: each row's
        frontier page), sampling at position ``cache_len + 1``, the
        masks, and the write of the next ids into ``last_ids``.  Returns
        the (2, max_batch) tok/done tensor.  This is what a tier's CUDA
        Graph captures."""
        fwd = self._forward("decode", tier, self.cfg.s_max)
        flags, clen = step_in[:3], step_in[3, :tier]
        cache = self.cache
        tcaches = self._tier_caches(tier, caches, pages)
        out = fwd(self.params, {"ids": last_ids[:tier],
                                "positions": clen[:, None],
                                "cache_len": clen, **tcaches})
        if cache.paged:
            cache.scatter_frontier(caches, out, pages, clen, tier)
        else:
            for k, c in tcaches.items():
                if out[k].data_ptr() != c.data_ptr():
                    c.copy_(out[k])
        tok_t = sample_tokens(out["logits"][:, -1, :], self.sampling,
                              seeds=step_in[4, :tier],
                              rids=step_in[5, :tier], positions=clen + 1)
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
                # paged: the whole pool, since the tier's pages lie anywhere
                caches = {k: (v.clone() if self.cache.paged
                              else v.narrow(bds[k], 0, tier).clone())
                          for k, v in self.cache.caches.items()}
                self._decode_run(tier, self._last_ids.clone(),
                                 self._step_in.clone(), caches,
                                 self._step_pages.clone())

            g = GraphStep(
                lambda: self._decode_run(tier, self._last_ids, self._step_in,
                                         self.cache.caches, self._step_pages),
                warm, stream=self._capture_stream, pool=self._pool)
            self._stats["graph_captures"] += 1
            self._stats["capture_s"] += g.capture_s
            return g
        return self._graph_step(
            ("decode", self._cache_tag, self._samp_salt, tier), build)

    def _stage_step_in(self, flags: np.ndarray, tier: int,
                       drafts: Optional[np.ndarray] = None):
        """Flags, cache lengths, row seeds and rids into ``_step_in``,
        paged, the page table into ``_step_pages`` and, for a host
        proposer's verify step, the drafts into ``_drafts``: one copy from
        pinned staging on CUDA.  Pages change between steps (``reserve``),
        so the table is staged on every dispatch; a real page mapped twice
        among the tier's rows raises first."""
        B = self.cfg.max_batch
        if self.cache.paged:
            self.cache.check_unaliased(self.cache.page_table[:tier])

        def fill(a):
            s = a[:6 * B].reshape(6, B)
            s[:3] = flags
            s[3] = self.cache.lengths
            s[4] = self._row_seed.view(np.int32)
            s[5] = self._row_rid
            if self._bpr:
                a[6 * B:B * (6 + self._bpr)] = self.cache.page_table.reshape(-1)
            if drafts is not None:
                a[B * (6 + self._bpr):] = drafts.reshape(-1)
        self._step_stage.put(fill, self._step_stage.dev.numel())

    def _dispatch_decode(self):
        """Dispatch one decode step at the smallest tier covering every
        allocated row (chunking rows ride in the prefix, inactive).
        Returns ``(fetch, snapshot)`` for the harvest.

        Error boundary: an injected ``PoisonedRequest`` fails exactly
        that row and the dispatch retries with the survivors; an
        ``InjectedFault`` fails the rows of this dispatch (the batch,
        never the engine).  Any other error propagates."""
        while self.active:
            self._ensure_decode_pages()
            if not self.active:
                return None
            B = self.cfg.max_batch
            occ = len(self.active) + len(self._chunking)
            self._stats["peak_active"] = max(self._stats["peak_active"],
                                             occ)
            tier = self._tier_for(occ, self.tiers)
            self._compact(tier)
            if self._spec is not None:
                k = self._spec_k_for_dispatch()
                if k:
                    result = self._dispatch_spec(tier, k)
                    if result == "retry":
                        continue
                    return result
                self._stats["spec_fallbacks"] += 1
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
            self._stage_step_in(flags, tier)
            if graph is not None:
                out = graph.replay()
                self._stats["graph_replays"] += 1
            else:
                out = self._decode_run(tier, self._last_ids, self._step_in,
                                       self.cache.caches, self._step_pages)
            # host mirrors advance at dispatch, not harvest
            for row, _ in snapshot:
                self.cache.lengths[row] += 1
                self._gen[row] += 1
            self._stats["decode_steps"] += 1
            self._stats["tier_steps"][tier] += 1
            if self._observer is not None:
                self._feed_observer(tier)
            return (_Fetch(out), snapshot)
        return None

    def _feed_observer(self, tier: int):
        """Feed the policy live step timings: the wall clock between two
        successive same-tier decode dispatches bounds one device step
        (the loop is double-buffered, so dispatch N+1 waits on step N)
        and needs no extra sync."""
        t_now = time.perf_counter()
        prev = self._obs_prev
        self._obs_prev = (tier, t_now)
        if prev is None or prev[0] != tier:
            return
        self._observer(
            phase="decode", arch=self.model.cfg.name,
            local_batch=tier, seq_len=self.cfg.s_max,
            seconds=t_now - prev[1],
            stats={"decode_steps": self._stats["decode_steps"],
                   "active": len(self.active),
                   "shed": self._stats["shed"]})

    def _ensure_decode_pages(self):
        """Paged only: every active row writes position ``lengths[row]``
        this step, which needs a fresh page whenever the length crosses a
        page boundary.  On exhaustion, preempt the lowest-priority
        decoding row (its release frees pages; it may be one of the short
        rows itself) and retry; rows that still get no page fail, so the
        others keep decoding."""
        if not self.cache.paged:
            return
        while True:
            short = [row for row in sorted(self.active)
                     if not self.cache.reserve(
                         row, int(self.cache.lengths[row]) + 1)]
            if not short:
                return
            self._stats["page_denied"] += len(short)
            if self.cfg.preemption and self._preempt_one():
                continue
            for row in short:
                req = self.active.get(row)
                if req is not None:
                    self._fail_request(req, (
                        "KV page pool exhausted: no page free for the "
                        f"decode write at position {self.cache.lengths[row]}"
                        " and no preemptible victim"))
            return

    def _harvest(self, pending):
        """The loop's single host sync: wait for the pending decode step's
        token/done vector and any prefill first-token vectors, then run
        the host bookkeeping, each request inside its own error boundary
        (an injected harvest fault fails that request alone)."""
        prefills, self._pending_prefill = self._pending_prefill, []
        if pending is None and not prefills:
            return
        spec = pending is not None and isinstance(pending[0], str)
        got = [f.wait() for f, _ in prefills]
        vals = (pending[1] if spec else pending[0]).wait() \
            if pending is not None else None
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
        if spec:
            self._harvest_spec(vals, pending, now)
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

    # -- speculative decode -----------------------------------------------
    def _init_spec(self, cfg: ServeConfig, target):
        """Validate ``cfg.spec`` and resolve its proposer, sampling and
        draft lengths (``target``: the policy, for ``k="auto"``)."""
        if cfg.spec is not None and not isinstance(cfg.spec, SpecConfig):
            raise ValueError(
                "ServeConfig.spec must be a serve.SpecConfig or None")
        self._spec = cfg.spec
        self._spec_t0 = 0.0        # perf_counter of the last spec dispatch
        if self._spec is None:
            self._proposer = None
            self._spec_sampling = self.sampling
            self._spec_salt = self._samp_salt
            self._k_candidates = DRAFT_K_CANDIDATES
            self._k_picker = None
            self._kmax = 0
            return
        self._proposer = resolve_proposer(self._spec.proposer)
        self._spec_sampling = resolve_sampling(
            self._spec.sampling if self._spec.sampling is not None
            else cfg.sampling)
        self._spec_salt = sampling_salt(self._spec_sampling)
        from ..core.strategies import registry
        space = dict(registry.get_entry("spec_decode").param_space)
        self._k_candidates = tuple(int(v) for v in space["draft_k"])
        self._k_picker = getattr(target, "spec_draft_k", None)
        self._kmax = (self._spec.k if isinstance(self._spec.k, int)
                      else max(self._k_candidates))
        # verify width k+1 must not exceed the smallest chunk length: a
        # chunking row's frontier garbage is overwritten only when the
        # next chunk's slab covers it
        if self._kmax + 1 > cfg.prefill_buckets[0]:
            raise ValueError(
                f"speculative draft k={self._kmax} needs verify width "
                f"{self._kmax + 1} <= the smallest prefill bucket "
                f"{cfg.prefill_buckets[0]}")
        # rollback is length bookkeeping, which only works for positional
        # (attention) caches: a recurrent state advances irreversibly
        bad = [key for key in self.model.decode_cache_layout()
               if not (key.endswith("k_cache") or key.endswith("v_cache"))]
        if bad:
            raise ValueError(
                "speculative decode needs positional decode caches "
                f"(rollback = length decrement); {self.model.cfg.name} "
                f"has non-positional state {bad}")
        self._draft_layers = 0
        if self._proposer.device:
            stacks = self.model.layer_stacks("decode")
            if len(stacks) != 1 or stacks[0][2] < 2:
                raise ValueError(
                    "SelfSpecProposer needs a model whose decode phase "
                    "is a single layer stack; "
                    f"{self.model.cfg.name} has "
                    f"{[st[0] for st in stacks]} — use the 'ngram' "
                    "proposer instead")
            total = stacks[0][2]
            n = self._proposer.n_layers or max(1, total // 2)
            self._draft_layers = min(n, total)

    def _pick_k(self) -> int:
        """Draft length for this iteration: the static ``SpecConfig.k``,
        or under ``k="auto"`` the policy's pick from measured acceptance
        (``AutoPolicy.spec_draft_k``), else 4."""
        if isinstance(self._spec.k, int):
            return self._spec.k
        if self._k_picker is not None:
            k = int(self._k_picker(arch=self.model.cfg.name,
                                   candidates=self._k_candidates))
            if k >= 1:
                return k
        return 4 if 4 in self._k_candidates else self._k_candidates[0]

    def _spec_k_for_dispatch(self) -> int:
        """Whether this iteration can speculate, and at what k (0: plain
        decode).  A verify step writes ``W = k + 1`` cache positions per
        allocated row (active rows at their frontier; chunking rows
        garbage that their next chunk overwrites), so every row needs W
        positions of headroom and, paged, W positions of reserved pages.
        A page shortfall or an injected allocation denial falls back
        rather than failing rows: plain decode needs only the +1 already
        reserved."""
        k = self._pick_k()
        W = k + 1
        for row in self.active:
            if int(self.cache.lengths[row]) + W > self.cfg.s_max:
                return 0
        for st in self._chunking:
            _, c = st["chunks"][st["next"]]
            if c < W or int(self.cache.lengths[st["req"].row]) + W \
                    > self.cfg.s_max:
                return 0
        if self.cache.paged:
            for row in sorted(self.active):
                need = self.cache.pages_needed(
                    int(self.cache.lengths[row]) + W)
                if need > int(self.cache.blocks_used[row]):
                    if self.faults is not None \
                            and self.faults.deny_alloc():
                        self._stats["alloc_denied"] += 1
                        return 0
                if not self.cache.reserve(
                        row, int(self.cache.lengths[row]) + W):
                    self._stats["page_denied"] += 1
                    return 0
        return k

    def _dispatch_spec(self, tier: int, k: int):
        """Dispatch one speculative step: the drafts (staged from the
        host, or the draft graph's replay), then the verify step.  Host
        mirrors do not advance here: how far each row moved is the
        accepted count, applied at harvest.  Returns ``"retry"`` after
        excising a poisoned request."""
        B = self.cfg.max_batch
        flags = np.zeros((3, B), np.int32)     # active, gen_left, eos
        flags[1] = 1
        flags[2] = -1
        snapshot = []
        for row, req in self.active.items():
            flags[0, row] = 1
            flags[1, row] = max(1, req.max_new_tokens - self._gen[row])
            flags[2, row] = req.eos_id
            snapshot.append((row, req))
        try:
            if self.faults is not None:
                self.faults.check_dispatch(
                    "decode", [r.rid for _, r in snapshot])
        except PoisonedRequest as e:
            bad = next(r for _, r in snapshot if r.rid == e.rid)
            self._fail_request(bad, e)
            return "retry"
        except InjectedFault as e:
            for _, req in snapshot:
                self._fail_request(req, f"decode dispatch failed: {e}")
            return None
        self._spec_forwards(tier, k)
        device = self._proposer.device
        if self._graphed:
            draft = self._spec_graph("draft", tier, k) if device else None
            verify = self._spec_graph("verify", tier, k)
        drafts = None if device else self._host_drafts(k, snapshot)
        self._stage_step_in(flags, tier, drafts)
        if device:
            if self._graphed:
                draft.replay()
                self._stats["draft_graph_replays"] += 1
            else:
                self._draft_run(tier, k, self._last_ids, self._step_in,
                                self._drafts, self.cache.caches,
                                self._step_pages)
        if self._graphed:
            out = verify.replay()
            self._stats["verify_graph_replays"] += 1
        else:
            out = self._verify_run(tier, k, self._last_ids, self._step_in,
                                   self._drafts, self.cache.caches,
                                   self._step_pages)
        self._stats["decode_steps"] += 1
        self._stats["spec_steps"] += 1
        self._stats["spec_drafted"] += k * len(snapshot)
        self._stats["tier_steps"][tier] += 1
        self._spec_t0 = time.perf_counter()
        return ("spec", _Fetch(out), snapshot, k, tier)

    def _host_drafts(self, k: int, snapshot: list) -> np.ndarray:
        """(max_batch, kmax) int32 drafts of a host proposer, each row's
        from its token stream so far (a trailing ``-100`` sentinel is a
        placeholder, not a token: dropped before drafting)."""
        drafts = np.zeros((self.cfg.max_batch, self._kmax), np.int32)
        streams, rows = [], []
        for row, req in snapshot:
            st = list(req.prompt) + list(req.output)
            if st and st[-1] == -100:
                st.pop()
            streams.append(st)
            rows.append(row)
        if streams:
            got = np.asarray(self._proposer.draft(streams, k), np.int32)
            for i, row in enumerate(rows):
                drafts[row, :k] = got[i]
        return drafts

    def _spec_forwards(self, tier: int, k: int):
        """Build (or find) the forwards of the ``(tier, k)`` spec steps —
        the verify step is the decode structure at query width ``k + 1``
        (the chunk step's), the draft step the plain decode step run
        through its first layers — and record what building them cost
        the store in ``stats["spec_builds"][(tier, k)]``: after the
        decode step of the tier exists, no misses."""
        if (tier, k) in self._stats["spec_builds"]:
            return
        before = dict(self.store.stats)
        self._forward("chunk", tier, k + 1)
        if self._proposer.device:
            self._forward("decode", tier, self.cfg.s_max)
        st = self.store.stats
        self._stats["spec_builds"][(tier, k)] = {
            key: st[key] - before[key]
            for key in ("misses", "shares", "restore_hits")}

    def _verify_run(self, tier: int, k: int, last_ids, step_in, drafts,
                    caches, pages):
        """One verify step at ``(tier, k)`` over the given buffers, all in
        place: the decode forward at query width ``W = k + 1`` over each
        row's last token and drafts (paged: over its gathered pages, and
        every block of the W positions scattered back), every position
        sampled with the ``(seed, rid, position)`` key plain decode would
        use, and the acceptance: the longest draft prefix matching the
        target's tokens plus one, cut at the first eos, the token budget
        and ``s_max`` position by position as plain decode's masks are —
        which makes greedy speculative decode equal plain greedy decode.
        Writes the next ids into ``last_ids`` and returns the
        ``(tier, W + 2)`` int32 tensor ``[u | n_emit | done]``.  This is
        what a verify graph captures."""
        W = k + 1
        fwd = self._forward("chunk", tier, W)
        act = step_in[0, :tier].bool()
        gl, eo = step_in[1, :tier], step_in[2, :tier]
        clen = step_in[3, :tier]
        dr = drafts[:tier, :k]
        tcaches = self._tier_caches(tier, caches, pages)
        steps = torch.arange(W, dtype=torch.int32, device=clen.device)
        pos = clen[:, None] + steps                              # (tier, W)
        out = fwd(self.params, {"ids": torch.cat([last_ids[:tier], dr], 1),
                                "positions": pos, "cache_len": clen,
                                **tcaches})
        if self.cache.paged:
            self.cache.scatter_span(caches, out, pages, clen, tier, W)
        else:
            for key, c in tcaches.items():
                if out[key].data_ptr() != c.data_ptr():
                    c.copy_(out[key])
        u = sample_tokens(out["logits"], self._spec_sampling,
                          seeds=step_in[4, :tier, None],
                          rids=step_in[5, :tier, None], positions=pos + 1)
        m = torch.cumprod((dr == u[:, :k]).to(torch.int32), 1).sum(1)
        n_base = m + 1                     # accepted prefix + correction
        hit = (u == eo[:, None]) & (eo[:, None] >= 0) \
            & (steps[None] < n_base[:, None])
        any_eos = hit.any(1)
        first_eos = hit.to(torch.int32).argmax(1).to(torch.int32)
        n_emit = torch.where(any_eos, first_eos + 1, n_base)
        n_emit = torch.minimum(n_emit, gl)
        n_emit = torch.minimum(n_emit, self.cfg.s_max - 1 - clen)
        n_emit = torch.where(act, n_emit.clamp(min=1),
                             torch.zeros_like(n_emit)).to(torch.int32)
        new_last = u.gather(1, (n_emit - 1).clamp(min=0)[:, None].long())
        done = act & ((any_eos & (first_eos < n_emit)) | (n_emit >= gl)
                      | (clen + n_emit >= self.cfg.s_max - 1))
        li = last_ids[:tier]
        li.copy_(torch.where(act[:, None], new_last, li))
        return torch.cat([u, n_emit[:, None], done[:, None].to(torch.int32)],
                         1)

    def _draft_run(self, tier: int, k: int, last_ids, step_in, drafts,
                   caches, pages):
        """One self-speculative draft step at ``(tier, k)``: k width-1
        decode passes through the first ``n`` layers of the same model
        (``Forward(..., depth=n)`` over the decode step's per-layer
        plan), each token sampled as plain decode samples it, the k
        tokens written into ``drafts``.  The dense cache takes the
        draft's K/V in place at positions ``cache_len … cache_len+k-1``
        of layers ``[:n]``; the verify step that follows writes positions
        ``cache_len … cache_len+k`` of every layer of every tier row
        before its attention reads them, so nothing the draft wrote is
        ever read after it.  Paged, the draft writes only its gathered
        view and the pool stays untouched.  This is what a draft graph
        captures."""
        fwd = self._forward("decode", tier, self.cfg.s_max)
        clen = step_in[3, :tier]
        sd, rd = step_in[4, :tier], step_in[5, :tier]
        tcaches = self._tier_caches(tier, caches, pages)
        cur, cl = last_ids[:tier], clen
        for i in range(k):
            out = fwd(self.params, {"ids": cur, "positions": cl[:, None],
                                    "cache_len": cl, **tcaches},
                      depth=self._draft_layers)
            tok = sample_tokens(out["logits"][:, -1, :], self._spec_sampling,
                                seeds=sd, rids=rd, positions=cl + 1)
            drafts[:tier, i].copy_(tok)
            tcaches = {key: out[key] for key in tcaches}
            cur, cl = tok[:, None], cl + 1

    def _spec_graph(self, kind: str, tier: int, k: int) -> GraphStep:
        """The ``(tier, k)`` verify or draft step as one CUDA Graph over
        the engine's buffers, warmed first on copies of those it
        writes."""
        run = self._verify_run if kind == "verify" else self._draft_run

        def build():
            bds = self.cache.batch_dims

            def warm():
                caches = {key: (v.clone() if self.cache.paged
                                else v.narrow(bds[key], 0, tier).clone())
                          for key, v in self.cache.caches.items()}
                run(tier, k, self._last_ids.clone(), self._step_in.clone(),
                    self._drafts.clone(), caches, self._step_pages.clone())

            g = GraphStep(
                lambda: run(tier, k, self._last_ids, self._step_in,
                            self._drafts, self.cache.caches,
                            self._step_pages),
                warm, stream=self._capture_stream, pool=self._pool)
            self._stats["spec_graph_captures"] += 1
            self._stats["spec_capture_s"] += g.capture_s
            return g
        key = (f"spec_{kind}", self._cache_tag, self._spec_salt)
        if kind == "draft":
            key += (self._proposer.identity(),)
        return self._graph_step(key + (tier, k), build)

    def _harvest_spec(self, vals, pending, now: float):
        """Apply one verify step: append each row's accepted tokens and
        the correction, advance the host mirrors by that count, and roll
        the cache length — and, paged, the pages reserved past it — back
        over the rejected tail.  The rejected positions' K/V is garbage
        the attention mask hides and later writes overwrite."""
        _, _, snapshot, k, tier = pending
        W = k + 1
        u, n_emit, done = vals[:, :W], vals[:, W], vals[:, W + 1]
        accepted = 0
        for row, req in snapshot:
            if req.done_s:
                continue
            try:
                if self.faults is not None:
                    self.faults.check_harvest(req.rid)
                n = int(n_emit[row])
                toks = [int(t) for t in u[row, :n]]
                if toks and req.output and req.output[-1] == -100:
                    req.output[-1] = toks[0]       # sentinel: first token
                    req.output.extend(toks[1:])
                else:
                    req.output.extend(toks)
                if toks and not req.first_token_s:
                    req.first_token_s = now
                self._gen[row] += n
                self.cache.lengths[row] += n
                if n < W:
                    self._stats["spec_rollbacks"] += 1
                    self.cache.rollback(row, int(self.cache.lengths[row]))
                self._stats["decode_tokens"] += n
                accepted += max(0, n - 1)
                if done[row]:
                    self._finish(req, now)
                elif self._deadline_blown(req, now):
                    self._fail_deadline(req, now)
            except INJECTED as e:
                self._fail_request(req, f"harvest failed: {e}")
        self._stats["spec_accepted"] += accepted
        if self._observer is not None and snapshot:
            self._observer(
                phase="spec_decode", arch=self.model.cfg.name,
                local_batch=tier, seq_len=k, seconds=now - self._spec_t0,
                stats={"draft_k": k, "accepted": accepted,
                       "acceptance_rate":
                           accepted / max(1, k * len(snapshot))})

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
