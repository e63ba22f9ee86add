"""Tiered greedy serving engine: batched bucketed prefill, power-of-two
decode tiers with row compaction, and a double-buffered host loop with
one host sync per decode iteration.

  * **Decode batch tiers.**  Decode steps are built at power-of-two batch
    tiers (1, 2, 4, …, ``max_batch``); each iteration runs the smallest
    tier covering the active rows.  Active rows are compacted into the low
    slots on tier shrink (in-place row copies on the device) so the tier
    prefix is always dense, and the step reads the tier's rows of the
    stacked caches as views.
  * **Batched prefill.**  ``_admit`` packs up to ``prefill_batch`` waiting
    requests into one bucketed prefill call (a real batch dimension,
    padded to a power-of-two group tier).  Padded slots alias the first
    real row and are written first, so the real write wins.  Each row's
    KV is copied into its preallocated cache row in place.  A prompt
    shorter than its bucket leaves its last token to the first decode
    step (the ``-100`` sentinel), exactly as the JAX engine does.
  * **Async host loop.**  Greedy argmax and the eos/length masks run on
    the device; sampled tokens chain into the next step through a device
    ``last_ids`` vector.  Each step's small token/done vector is copied to
    pinned host memory as soon as it is enqueued, behind an event; the
    loop dispatches step k+1 before it waits on step k's event — one host
    sync per decode iteration.
  * **One CUDA Graph per decode tier and per prefill group**
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
    that slot 0's write lands last, as the JAX engine's does.  A graph
    is built on its first use, or ahead of traffic by ``warmup()``.  On
    the CPU the slot IR runs eagerly and nothing is captured;
    ``lowered=False`` runs the interpreter eagerly on either device.
  * **PlanStore.**  Every lowered step is built through the engine's
    ``PlanStore`` (``core/plan_store.py``): a tier or bucket whose
    structure the store holds is specialized from it, one it holds
    persisted is restored, and ``run()`` checkpoints a path-bound store
    when the queue drains.  The graphs live in the store's executable
    level under keys that name this engine, since a graph binds its
    engine's buffers, all in one graph memory pool of the engine; they
    are dropped when the engine is collected.
    ``stats["plan_store"]`` is the store's ``snapshot()``.

Admission control, faults, preemption, chunked prefill, the paged cache,
speculative and sampled decode arrive with later slices; a prompt longer
than the largest bucket is refused at ``submit``.
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
from .kv_cache import DenseCache


def pow2_tiers(n: int) -> tuple:
    """Power-of-two capture tiers up to and including ``n``."""
    ts, t = [], 1
    while t < n:
        ts.append(t)
        t *= 2
    ts.append(n)
    return tuple(sorted(set(ts)))


@dataclasses.dataclass(frozen=True)
class Finished:
    """Terminal result of a request that produced all its tokens."""


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int = 16
    eos_id: int = -1                   # -1: never stop early
    # filled by the engine:
    output: list = dataclasses.field(default_factory=list)
    row: int = -1
    submitted_s: float = 0.0
    first_token_s: float = 0.0
    done_s: float = 0.0
    result: object = None

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
    # Realize steps through the lowered slot IR and, on CUDA, replay each
    # decode tier's and each prefill group's step as one CUDA Graph;
    # False runs the interpreter eagerly (the yardstick).
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
        self.waiting: list[Request] = []
        self.active: dict[int, Request] = {}     # row -> request
        self.finished: list[Request] = []
        # fixed buffers the graphs read and write: never rebound
        B = cfg.max_batch
        self._last_ids = torch.zeros((B, 1), dtype=torch.int32,
                                     device=self.device)
        # decode: (active, will_end, eos) flags and cache lengths, (4, B)
        self._step_stage = _Staged(4 * B, self.device)
        self._step_in = self._step_stage.dev.view(4, B)
        # prefill: ids, rows, full flags, last tokens of one group, laid
        # out per (bp, bucket) by _prefill_views
        self._prefill_stage = _Staged(
            self.prefill_tiers[-1] * (cfg.prefill_buckets[-1] + 3),
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
        # step key -> Forward; a shared dict lets engines of one program
        # reuse each other's traced and scheduled steps
        self._steps: dict = {} if step_cache is None else step_cache
        self._stats = {"prefill_steps": 0, "prefill_reqs": 0,
                       "decode_steps": 0, "decode_tokens": 0,
                       "host_syncs": 0, "row_moves": 0, "finished": 0,
                       "graph_captures": 0, "graph_replays": 0,
                       "capture_s": 0.0, "prefill_graph_captures": 0,
                       "prefill_graph_replays": 0, "prefill_capture_s": 0.0,
                       "tier_steps": {t: 0 for t in self.tiers},
                       "tier_builds": {}}
        self._ck = self._cache_keys()

    # -- public -----------------------------------------------------------
    def submit(self, req: Request):
        n = len(req.prompt)
        if n < 1:
            raise ValueError("empty prompt")
        if n > self.cfg.s_max - 1:
            raise ValueError(
                f"prompt length {n} cannot fit s_max={self.cfg.s_max} "
                "(need at least one decode slot)")
        if n > self.cfg.prefill_buckets[-1]:
            raise ValueError(
                f"prompt length {n} exceeds the largest prefill bucket "
                f"{self.cfg.prefill_buckets[-1]} (chunked prefill is not "
                "ported yet)")
        req.submitted_s = time.perf_counter()
        self.waiting.append(req)

    def step(self) -> bool:
        """One engine iteration: admit, dispatch, harvest.  Returns True
        while work remains."""
        self._admit()
        # double-buffered: step k+1 is in flight before step k's harvest
        prev, self._pending = self._pending, self._dispatch_decode()
        self._harvest(prev)
        return self._busy()

    def warmup(self, tiers: Optional[tuple] = None, prefill=()):
        """Build decode tiers' steps (all tiers by default) and the
        prefill steps of the given ``(group tier, bucket)`` pairs ahead of
        traffic — and, when graphed, capture them — so that neither a
        tier switch nor a new bucket under load hits a cold build or a
        capture.  Changes no cache, id or length: a graph is warmed on
        copies of the buffers its step writes, and its capture runs
        nothing.  (A CUDA Graph binds one engine's buffers, so this is
        the port's counterpart of executables shared across engines.)"""
        for t in self.tiers if tiers is None else tiers:
            if self._graphed:
                self._graph(t)
            else:
                self._forward("decode", t, self.cfg.s_max)
        for bp, bucket in prefill:
            if bp not in self.prefill_tiers \
                    or bucket not in self.cfg.prefill_buckets:
                raise ValueError(
                    f"no prefill group ({bp}, {bucket}): group tiers "
                    f"{self.prefill_tiers}, buckets "
                    f"{self.cfg.prefill_buckets}")
            if self._graphed:
                self._prefill_graph(bp, bucket)
            else:
                self._forward("prefill", bp, bucket)

    def run(self, max_iters: int = 10_000) -> list:
        """Drive the loop until every request terminates, then
        checkpoint the PlanStore."""
        it = 0
        while self._busy() and it < max_iters:
            self.step()
            it += 1
        if self._busy():
            raise RuntimeError(f"run() exhausted max_iters={max_iters}")
        # idle: the queue drained — checkpoint lowered plans so a
        # restart warm-starts instead of re-lowering
        self.checkpoint()
        return self.finished

    def checkpoint(self) -> int:
        """Persist the PlanStore when it is path-bound and changed since
        the last save; returns the number of outer entries written."""
        if not self.store.path or not self.store.dirty:
            return 0
        return self.store.save()

    def shutdown(self) -> int:
        """Drop this engine's graphs from the store and checkpoint it.
        The engine stays usable: its next steps capture anew."""
        self.store.evict_execs(_graphs_of(self._serial))
        return self.checkpoint()

    @property
    def stats(self) -> dict:
        out = dict(self._stats)
        out["tier_steps"] = dict(self._stats["tier_steps"])
        out["tier_builds"] = dict(self._stats["tier_builds"])
        out["plan_store"] = self.store.snapshot()
        return out

    # -- helpers ------------------------------------------------------------
    def _busy(self) -> bool:
        return bool(self.waiting or self.active or self._pending is not None
                    or self._pending_prefill)

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

    def _forward(self, phase: str, batch: int, seq: int):
        key = (phase, batch, seq, self.cfg.lowered, self._graphed)
        fwd = self._steps.get(key)
        if fwd is None:
            q_len = 1 if phase == "decode" else seq
            segs, _ = self.model.build_segments(phase, batch, q_len,
                                                s_max=self.cfg.s_max)
            info = ScheduleContext(local_batch=batch, seq_len=seq,
                                   phase=phase, arch=self.model.cfg.name)
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

    # -- prefill ----------------------------------------------------------
    def _admit(self):
        while self.waiting and self.cache.free_rows:
            group = []
            while (self.waiting and len(group) < self.cfg.prefill_batch
                   and self.cache.free_rows):
                req = self.waiting.pop(0)
                req.row = self.cache.allocate(req.rid)
                group.append(req)
            self._dispatch_prefill(group)

    def _dispatch_prefill(self, group: list):
        """One bucketed prefill call over a real batch of requests."""
        bp = self._tier_for(len(group), self.prefill_tiers)
        prompts = [np.asarray(r.prompt, np.int32) for r in group]
        bucket = self._bucket(max(len(p) for p in prompts))
        full = [len(pr) == bucket for pr in prompts]

        def fill(a):
            ids, rows, fl, last = self._prefill_views(a, bp, bucket)
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
        n = bp * (bucket + 3)
        self._prefill_stage.put(fill, n)
        if self._graphed:
            tok = self._prefill_graph(bp, bucket).replay()
            self._stats["prefill_graph_replays"] += 1
        else:
            tok = self._prefill_run(bp, bucket, self._prefill_stage.dev,
                                    self._last_ids, self.cache.caches)
        slots = []
        for j, (req, pr) in enumerate(zip(group, prompts)):
            n = len(pr)
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
        if slots:
            self._pending_prefill.append((_Fetch(tok), slots))

    @staticmethod
    def _prefill_views(buf, bp: int, bucket: int):
        """(ids (bp, bucket), rows, full, last token) — views of a flat
        staging buffer, host (numpy) or device (torch)."""
        n = bp * bucket
        return (buf[:n].reshape(bp, bucket), buf[n:n + bp],
                buf[n + bp:n + 2 * bp], buf[n + 2 * bp:n + 3 * bp])

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
        ids, rows, full, sent_last = self._prefill_views(inp, bp, bucket)
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

    def _prefill_graph(self, bp: int, bucket: int) -> GraphStep:
        """The ``(bp, bucket)`` prefill group as one CUDA Graph over the
        engine's buffers, warmed first on copies of the ones it writes."""
        def build():
            def warm():
                caches = {k: v.clone() for k, v in self.cache.caches.items()}
                self._prefill_run(bp, bucket, self._prefill_stage.dev,
                                  self._last_ids.clone(), caches)

            g = GraphStep(
                lambda: self._prefill_run(bp, bucket, self._prefill_stage.dev,
                                          self._last_ids, self.cache.caches),
                warm, stream=self._capture_stream, pool=self._pool)
            self._stats["prefill_graph_captures"] += 1
            self._stats["prefill_capture_s"] += g.capture_s
            return g
        return self._graph_step(("prefill", bp, bucket), build)

    # -- decode -----------------------------------------------------------
    def _compact(self, tier: int):
        """Restore the prefix invariant: every active row < tier."""
        for src in sorted((r for r in self.active if r >= tier),
                          reverse=True):
            dst = next(r for r in self.cache.free_rows if r < tier)
            self.cache.move_row(src, dst)
            self._last_ids[dst] = self._last_ids[src]
            self._gen[dst] = self._gen[src]
            req = self.active.pop(src)
            req.row = dst
            self.active[dst] = req
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
        """Dispatch one decode step at the smallest covering tier.
        Returns ``(fetch, snapshot)`` for the harvest."""
        if not self.active:
            return None
        B = self.cfg.max_batch
        tier = self._tier_for(len(self.active), self.tiers)
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

    def _harvest(self, pending):
        """The loop's single host sync: wait for the pending decode step's
        token/done vector and any prefill first-token vectors, then run
        the host bookkeeping."""
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
                req.output.append(int(toks[j]))
                if not req.first_token_s:
                    req.first_token_s = now
                if (len(req.output) >= req.max_new_tokens
                        or req.output[-1] == req.eos_id):
                    self._finish(req, now)
        if pending is None:
            return
        tok, done = vals[0], vals[1]
        for row, req in pending[1]:
            if req.done_s:       # finished by an earlier harvest: the
                continue         # in-flight step decoded a stale row
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
