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
  * **One CUDA Graph per decode tier** (``ServeConfig.lowered``, the
    default).  A tier's whole step — the forward over the lowered slot
    IR, the cache updates, argmax, the masks and the write of the next
    ids — is captured once (``core/capture.py``) over buffers the engine
    owns and never reassigns: ``_last_ids``, the tier views of the
    caches, and ``_step_in``, whose rows are the (active, will_end, eos)
    flags and the cache lengths.  A step's host work is then one copy of
    flags and lengths from pinned staging, ``replay()``, and the fetch of
    tok/done.  A tier's graph is built on its first use, or ahead of
    traffic by ``warmup()``.  On the CPU the slot IR runs eagerly and
    nothing is captured; ``lowered=False`` runs the interpreter eagerly
    on either device.

Admission control, faults, preemption, chunked prefill, the paged cache,
speculative and sampled decode arrive with later slices; a prompt longer
than the largest bucket is refused at ``submit``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core.capture import GraphStep
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
    # decode tier's step as one CUDA Graph; False runs the interpreter
    # eagerly (the yardstick).
    lowered: bool = True


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


class ServeEngine:
    """``scheduler`` accepts an ``OpSchedulerBase``, a ``StrategyPolicy``
    or a strategy name (resolved per step context by ``build_forward``).
    Params and caches live on ``device`` (default: the GPU; raises
    without one unless the caller passes ``device="cpu"``)."""

    def __init__(self, model, params, scheduler, cfg: ServeConfig,
                 device=None, step_cache: Optional[dict] = None):
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
        self.cache = DenseCache().build(model, cfg, self.device)
        self.waiting: list[Request] = []
        self.active: dict[int, Request] = {}     # row -> request
        self.finished: list[Request] = []
        # fixed buffers the decode graphs read and write: never rebound
        B = cfg.max_batch
        self._last_ids = torch.zeros((B, 1), dtype=torch.int32,
                                     device=self.device)
        self._step_in = torch.zeros((4, B), dtype=torch.int32,
                                    device=self.device)
        # pinned staging for _step_in, two buffers: the loop keeps two
        # steps in flight, and a buffer is rewritten only once the copy
        # that read it has run (its event)
        cuda = self.device.type == "cuda"
        self._stage = [torch.zeros((4, B), dtype=torch.int32,
                                   pin_memory=cuda) for _ in range(2)]
        self._stage_ev = [torch.cuda.Event() if cuda else None
                          for _ in range(2)]
        self._stage_i = 0
        self._graphed = cfg.lowered and cuda
        self._graphs: dict = {}            # tier -> GraphStep
        self._capture_stream = torch.cuda.Stream(self.device) \
            if self._graphed else None
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
                       "capture_s": 0.0,
                       "tier_steps": {t: 0 for t in self.tiers}}
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

    def warmup(self, tiers: Optional[tuple] = None):
        """Build every decode tier's step (all tiers by default) ahead of
        traffic — and, when graphed, capture it — so that a tier switch
        under load never hits a cold build.  Changes no cache, id or
        length: a graph is warmed on copies and its capture runs
        nothing."""
        for t in tiers or self.tiers:
            if self._graphed:
                self._graph(t)
            else:
                self._forward("decode", t, self.cfg.s_max)

    def run(self, max_iters: int = 10_000) -> list:
        """Drive the loop until every request terminates."""
        it = 0
        while self._busy() and it < max_iters:
            self.step()
            it += 1
        if self._busy():
            raise RuntimeError(f"run() exhausted max_iters={max_iters}")
        return self.finished

    @property
    def stats(self) -> dict:
        out = dict(self._stats)
        out["tier_steps"] = dict(self._stats["tier_steps"])
        return out

    # -- helpers ------------------------------------------------------------
    def _busy(self) -> bool:
        return bool(self.waiting or self.active or self._pending is not None
                    or self._pending_prefill)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

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
        key = (phase, batch, seq, self.cfg.lowered)
        fwd = self._steps.get(key)
        if fwd is None:
            q_len = 1 if phase == "decode" else seq
            segs, _ = self.model.build_segments(phase, batch, q_len,
                                                s_max=self.cfg.s_max)
            info = ScheduleContext(local_batch=batch, seq_len=seq,
                                   phase=phase, arch=self.model.cfg.name)
            fwd = self._steps[key] = build_forward(
                segs, self.scheduler, info, lowered=self.cfg.lowered)
        return fwd

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
        ids = np.zeros((bp, bucket), np.int32)
        rows = np.full((bp,), group[0].row, np.int64)
        full = np.zeros((bp,), bool)
        sent_last = np.zeros((bp,), np.int32)
        for j, (req, pr) in enumerate(zip(group, prompts)):
            n = len(pr)
            ids[j, :n] = pr
            rows[j] = req.row
            full[j] = n == bucket
            sent_last[j] = int(pr[n - 1])
        fwd = self._forward("prefill", bp, bucket)
        pos = torch.arange(bucket, dtype=torch.int32,
                           device=self.device).expand(bp, bucket)
        out = fwd(self.params, {"ids": self._to_device(ids),
                                "positions": pos})
        tok = out["logits"][:, -1, :].argmax(-1).to(torch.int32)
        caches, bds = self.cache.caches, self.cache.batch_dims
        # reversed: padded slots (which alias rows[0]) are written first,
        # so slot 0's real write lands last and wins
        for j in reversed(range(bp)):
            r = int(rows[j])
            for pk, pv, dk, dv in self._ck:
                for src, dst in ((pk, dk), (pv, dv)):
                    if bds[dst]:             # stacked (L, B, S, ...)
                        caches[dst][:, r, :bucket].copy_(out[src][:, j])
                    else:                    # per-layer (B, S, ...)
                        caches[dst][r, :bucket].copy_(out[src][j])
        n_real = len(group)
        first = torch.where(self._to_device(full), tok,
                            self._to_device(sent_last))
        self._last_ids[self._to_device(rows[:n_real]), 0] = first[:n_real]
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
        g = self._graphs.get(tier)
        if g is None:
            bds = self.cache.batch_dims

            def warm():
                caches = {k: v.narrow(bds[k], 0, tier).clone()
                          for k, v in self.cache.caches.items()}
                self._decode_run(tier, self._last_ids.clone(),
                                 self._step_in.clone(), caches)

            g = self._graphs[tier] = GraphStep(
                lambda: self._decode_run(tier, self._last_ids, self._step_in,
                                         self.cache.caches),
                warm, stream=self._capture_stream, pool=self._pool)
            self._stats["graph_captures"] += 1
            self._stats["capture_s"] += g.capture_s
        return g

    def _stage_step_in(self, flags: np.ndarray):
        """Flags and cache lengths into ``_step_in``: one copy from
        pinned staging on CUDA."""
        stage = self._stage[self._stage_i]
        ev = self._stage_ev[self._stage_i]
        self._stage_i ^= 1
        if ev is not None:
            ev.synchronize()       # the copy that last read it has run
        a = stage.numpy()
        a[:3] = flags
        a[3] = self.cache.lengths
        self._step_in.copy_(stage, non_blocking=ev is not None)
        if ev is not None:
            ev.record()

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
