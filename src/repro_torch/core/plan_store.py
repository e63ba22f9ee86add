"""Unified PlanStore — the plan/capture cache behind cheap re-dispatch.

DynaFlow's backend wins by amortizing scheduling work across many
invocation shapes (the paper's CUDA-graph capture/replay, §3.3.2).
``PlanStore`` is that amortization in one subsystem: a two-level plan
cache of lowered slot programs, and an executable level of captured
CUDA Graphs.

  * **outer key — fingerprint v2** (``outer_key``; printable digest via
    ``fingerprint_v2``): the shape-free structural identity of the
    (graph, plan) pair, combined with the strategy identity (the
    caller's ``salt``) and the op-closure config (attention impl, shard
    layout, dtype policy — everything the op callables close over that
    the graph cannot see).
  * **inner key — the shape bucket** (``bucket_key``): graph input
    shapes/dtypes, concrete split sizes, capture flag (whether the step
    that runs the plan is captured as a CUDA Graph).

The first bucket of an outer entry pays the full ``lower`` (static
analysis + slot allocation) and becomes the **canonical** lowering;
every later bucket is derived from it via ``specialize`` — a single
pass that rewrites slice offsets and merge-buffer pads — and is counted
as a *share*, not a miss.

**Persistence.**  Because fingerprint v2 is shape-free and closure-aware,
a lowering is a reusable artifact *across processes*: ``save()``
serializes every persistable entry (``core.plan_serde`` — instruction
tuples, slots, liveness, interned param paths, merge-pad metadata;
callables and CUDA Graphs excluded), and ``load()`` /
``PlanStore.open()`` restore them lazily.  A restored bucket is
*redeemed* on first request — callables rebound from the caller's live
(graph, plan), counted as a ``restore_hit`` — and an unseen bucket of a
restored entry specializes a rehydrated canonical skeleton instead of
re-lowering.  A warm-started process therefore serves every
previously-seen bucket without a single ``lower`` call.  Corrupt or
version-mismatched files degrade to cold lowering, counted under the
``restore_*`` stats family.

**Admission policy.**  Eviction stats feed persistence: a bucket evicted
before a second touch is recorded as *one-shot* and never re-admitted to
the on-disk artifact (the record itself is persisted in the file
header), keeping the store bounded under bucket churn.

Entries are LRU-bounded both by count and by an estimated byte budget;
evictions, hits, misses and shares are all counted in ``stats``.

**Executable level** (``get_or_build``, ``exec_*`` counters, its own
entry-count and byte budgets).  The JAX package keeps jitted executables
here and measures them with XLA; the port keeps what its builders
return, and the serve engine's builders return ``core.capture.GraphStep``
— one CUDA Graph of a whole decode or prefill step.  A graph's bytes
(``nbytes``) are what its capture took from the graph memory pool, its
``capture_s`` (warm-up and capture) counts as ``compile_s``, and
evicting it drops the graph, so its next use captures anew.
"""
from __future__ import annotations

import os
import time
from collections import OrderedDict
from typing import Callable, Optional

from .lowering import LoweredPlan, LoweringError, lower, specialize
from .plan import FINGERPRINT_VERSION, dtype_name, structural_key
from .plan_serde import (RestoreError, encode_analysis,
                         encode_lowered, entry_line, key_digest,
                         parse_payload, persistable_key, read_store,
                         rehydrate, split_entry_line, split_verdict_line,
                         verdict_line, write_store)

_ONE_SHOT_CAP = 4096          # bounded one-shot eviction record
_PASSTHROUGH_CAP = 1024       # max never-redeemed entries kept per save
_EXEC_DEFAULT_NBYTES = 1 << 12  # floor estimate for un-analyzable execs


def outer_key(graph, plan, salt: str = "", op_config=(),
              struct_key_: Optional[tuple] = None) -> tuple:
    """Fingerprint-v2 outer key: structure + strategy identity + op
    closures, as a raw hashable tuple (the store's dict key — tuple
    hashing is ~3x cheaper than a digest on the warm-up path).

    ``op_config`` is a canonical tuple of (name, value) pairs describing
    what the op callables close over — see ``LMBase.op_closure_config``.
    ``struct_key_`` short-circuits the structural walk when the caller
    already holds ``structural_key(graph, plan)``.
    """
    return (struct_key_ if struct_key_ is not None
            else structural_key(graph, plan),
            salt, tuple(sorted(tuple(op_config))))


def fingerprint_v2(graph, plan, salt: str = "", op_config=()) -> str:
    """Printable digest of the fingerprint-v2 outer key (logs, docs,
    and the per-entry header of the persisted store)."""
    return key_digest(outer_key(graph, plan, salt, op_config))


def bucket_key(graph, plan, capture: bool = False) -> tuple:
    """Inner PlanStore key: the shape bucket of a (graph, plan) pair.

    ``capture`` holds the place of the JAX package's jaxpr-capture flag.
    The port's lowering captures nothing per plan; the flag says whether
    the step that runs the plan is captured as one CUDA Graph (the serve
    engine's graphed steps), so graphed and eager builds of one shape
    are separate buckets, as they are in the JAX package.  Dtypes enter
    by their bare name (``"bfloat16"``), as the JAX package's do."""
    shapes = tuple(
        (name, graph.tensors[t].shape, dtype_name(graph.tensors[t].dtype))
        for name, t in sorted(graph.inputs.items()))
    return (shapes, tuple(plan.split_sizes), bool(capture))


def plan_nbytes(lowered: LoweredPlan) -> int:
    """Deterministic host-memory estimate of one lowered plan.

    Not a profiler — a monotone proxy (instructions, slots, interned
    paths) so the byte budget evicts big plans before small ones.  The
    JAX package's formula, so the two stores evict alike; the stream
    program (``core/streams.py``: a few small tuples an instruction,
    derived, never saved) rides in the 256 bytes an instruction counts.
    """
    n = 512
    for ins in lowered.instrs:
        n += 256 + 48 * (len(ins.reads) + len(ins.writes) + len(ins.frees)
                         + len(ins.fused_pairs)
                         + len(ins.member_pairs or ()))
    n += 64 * (lowered.n_slots + len(lowered.param_paths)
               + len(lowered.input_slots) + len(lowered.output_slots))
    return n


class PlanStore:
    """Two-level lowered-plan cache + executable cache, unified.

    Plan level  — ``get_or_lower``: (fingerprint v2) -> (bucket) ->
    ``LoweredPlan``; cross-bucket requests specialize the canonical
    lowering instead of re-running analysis + lowering; cross-process
    requests redeem entries restored from a persisted store file.

    Exec level  — ``get_or_build``: arbitrary key -> what the builder
    returns; the serve engine's ``GraphStep``s (whole steps captured as
    CUDA Graphs).
    """

    def __init__(self, plan_capacity: int = 256,
                 plan_budget_bytes: Optional[int] = None,
                 exec_capacity: int = 128,
                 exec_budget_bytes: Optional[int] = None,
                 path: Optional[str] = None,
                 verify_restored: bool = True):
        self.plan_capacity = plan_capacity
        # semantic verification of rehydrated instruction streams — the
        # check *behind* the checksum: a stale or tampered artifact whose
        # digest and fingerprint both pass can still alias live slots
        self.verify_restored = verify_restored
        self.plan_budget_bytes = plan_budget_bytes
        self.exec_capacity = exec_capacity
        self.exec_budget_bytes = exec_budget_bytes
        self.path = path
        self._plans: OrderedDict = OrderedDict()   # (outer, inner) -> entry
        self._canonical: dict = {}                 # outer -> (outer, inner)
        self._execs: OrderedDict = OrderedDict()   # key -> (fn, nbytes)
        self._touches: dict = {}                   # plan key -> reuse count
        self._one_shot: OrderedDict = OrderedDict()  # (odig, bdig) -> None
        # restored-but-unredeemed state: verbatim entry lines by fp2
        # digest (checksum-verified at load, JSON parse deferred to
        # first use) and parsed entries by outer key
        self._restored_raw: dict = {}
        self._restored_parsed: dict = {}
        self._verdicts: dict = {}                  # context_fp -> payload
        self._dirty = False                        # plan-level state vs disk
        self.stats = {
            "hits": 0, "misses": 0, "shares": 0, "evictions": 0,
            "specialize_rejects": 0,
            "lower_s": 0.0, "specialize_s": 0.0, "plan_bytes": 0,
            "one_shot_evictions": 0,
            "restore_hits": 0, "restore_canonicals": 0,
            "restore_entries": 0, "restore_rejected": 0,
            "restore_verify_rejected": 0,
            "restore_errors": 0, "restore_saved": 0, "restore_skipped": 0,
            "restore_s": 0.0,
            "exec_hits": 0, "exec_misses": 0, "exec_evictions": 0,
            "exec_bytes": 0, "compile_s": 0.0, "trace_s": 0.0,
            "verdicts_put": 0, "verdict_hits": 0, "verdict_misses": 0,
            "verdict_rejected": 0,
        }

    # -- plan level --------------------------------------------------------
    def get_or_lower(self, graph, plan, analysis=None, salt: str = "",
                     capture: bool = False, op_config=()) -> LoweredPlan:
        skey = structural_key(graph, plan)
        outer = outer_key(graph, plan, salt=salt, op_config=op_config,
                          struct_key_=skey)
        key = (outer, bucket_key(graph, plan, capture))
        hit = self._plans.get(key)
        if hit is not None:
            self.stats["hits"] += 1
            self._touches[key] = self._touches.get(key, 0) + 1
            self._plans.move_to_end(key)
            return hit[0]
        restored = self._restored_entry(outer) \
            if (self._restored_raw or self._restored_parsed) else None
        if restored is not None:
            # the record is kept after a successful redeem: it serves
            # again if LRU churn evicts the live entry, and save()'s
            # pass-through re-persists it (a short-lived or
            # budget-squeezed process must never shrink the artifact)
            rec = restored["buckets"].get(key[1])
            if rec is not None:
                lowered = self._redeem(rec, restored, graph, plan, skey,
                                       outer, key)
                if lowered is not None:
                    return lowered
                restored["buckets"].pop(key[1], None)   # rejected: no retry
        canonical = self._canonical_plan(outer)
        if canonical is None and restored is not None:
            canonical = self._skeleton_canonical(restored, outer, graph,
                                                 plan, skey)
        if canonical is not None:
            t0 = time.perf_counter()
            try:
                lowered = specialize(canonical, graph, plan, capture=capture,
                                     struct_key=skey)
            except LoweringError:
                # structure drifted (e.g. a batch tier whose scheduler
                # changed the micro-batch count): full lower below,
                # observable so tier configs that never share are loud
                lowered = None
                self.stats["specialize_rejects"] += 1
            if lowered is not None:
                self.stats["specialize_s"] += time.perf_counter() - t0
                self.stats["shares"] += 1
                # a specialized plan has the canonical's instr structure,
                # so its byte estimate is the canonical's — skip the walk
                # (unless the canonical is a restored skeleton not held
                # in the live table)
                nbytes = None
                ck = self._canonical.get(outer)
                if ck is not None:
                    entry = self._plans.get(ck)
                    if entry is not None:
                        nbytes = entry[1]
                        self._touches[ck] = self._touches.get(ck, 0) + 1
                self._insert(outer, key, lowered, nbytes)
                return lowered
        self.stats["misses"] += 1
        t0 = time.perf_counter()
        lowered = lower(graph, plan, analysis, capture=capture)
        self.stats["lower_s"] += time.perf_counter() - t0
        self._insert(outer, key, lowered)
        return lowered

    @property
    def share_rate(self) -> float:
        """Fraction of cold (non-hit) lookups served by specialization."""
        cold = self.stats["shares"] + self.stats["misses"]
        return self.stats["shares"] / cold if cold else 0.0

    def _canonical_plan(self, outer) -> Optional[LoweredPlan]:
        key = self._canonical.get(outer)
        entry = self._plans.get(key) if key is not None else None
        return entry[0] if entry is not None else None

    def _insert(self, outer, key, lowered: LoweredPlan,
                nbytes: Optional[int] = None):
        if nbytes is None:
            nbytes = plan_nbytes(lowered)
        self._plans[key] = (lowered, nbytes)
        self._touches.setdefault(key, 0)
        self.stats["plan_bytes"] += nbytes
        self._canonical.setdefault(outer, key)
        self._dirty = True
        self._evict_plans()

    def _evict_plans(self):
        while len(self._plans) > self.plan_capacity or (
                self.plan_budget_bytes is not None
                and self.stats["plan_bytes"] > self.plan_budget_bytes
                and len(self._plans) > 1):
            key, (_, nbytes) = self._plans.popitem(last=False)
            self.stats["plan_bytes"] -= nbytes
            self.stats["evictions"] += 1
            if self._touches.pop(key, 0) == 0:
                # evicted before a second touch: a one-shot bucket.  The
                # admission policy bars it from the persisted artifact.
                self.stats["one_shot_evictions"] += 1
                self._one_shot[(key_digest(key[0]),
                                key_digest(key[1]))] = None
                while len(self._one_shot) > _ONE_SHOT_CAP:
                    self._one_shot.popitem(last=False)
            outer = key[0]
            if self._canonical.get(outer) == key:
                # promote the most-recently-used surviving bucket of this
                # outer entry (scan from the MRU end — the LRU end is next
                # in line for eviction, which would re-trigger promotion
                # on every pop under sustained pressure)
                repl = next((k for k in reversed(self._plans)
                             if k[0] == outer), None)
                if repl is None:
                    del self._canonical[outer]
                else:
                    self._canonical[outer] = repl

    # -- persistence -------------------------------------------------------
    @classmethod
    def open(cls, path: str, **kwargs) -> "PlanStore":
        """Construct a store bound to ``path``, warm-starting from it when
        the file exists (missing file = empty store, not an error).
        ``save()`` with no argument writes back to the same path."""
        store = cls(path=path, **kwargs)
        if os.path.exists(path):
            store.load(path)
        return store

    def load(self, path: Optional[str] = None) -> int:
        """Restore persisted entries from ``path`` (default: the bound
        path).  Returns the number of restorable outer entries staged.

        Entries are staged lazily: the load pass verifies the header and
        per-entry checksums only; JSON parsing and callable rebinding
        happen on first request (*redeem*).  A corrupt or
        version-mismatched file rejects wholesale (``restore_errors``);
        a corrupt entry rejects alone (``restore_rejected``) — either
        way requests degrade to a cold ``lower``.
        """
        path = path or self.path
        if path is None:
            raise ValueError("PlanStore.load: no path given or bound")
        try:
            one_shot, lines = read_store(
                path, fingerprint_version=FINGERPRINT_VERSION)
        except RestoreError:
            self.stats["restore_errors"] += 1
            return 0
        for dig in one_shot:
            self._one_shot.setdefault(dig, None)
        n = 0
        for line in lines:
            if line.startswith("V "):
                try:
                    fp, payload = split_verdict_line(line)
                except RestoreError:
                    self.stats["verdict_rejected"] += 1
                    continue
                # setdefault: a verdict put live this process wins over
                # the (older) persisted one
                self._verdicts.setdefault(fp, payload)
                continue
            try:
                fp2, _payload = split_entry_line(line)
            except RestoreError:
                self.stats["restore_rejected"] += 1
                continue
            self._restored_raw[fp2] = line
            n += 1
        self.stats["restore_entries"] += n
        return n

    def save(self, path: Optional[str] = None) -> int:
        """Atomically persist the canonical lowerings to ``path``
        (default: the bound path).  Returns the number of outer entries
        written.

        Only **canonical** buckets are serialized: every derived bucket
        is one cheap ``specialize`` away at restore time, so persisting
        it would grow the artifact without shrinking the warm path.
        Excluded entirely: entries whose outer key carries a
        process-local closure identity (they could never match after a
        restart) and canonicals recorded one-shot by the admission
        policy.  Restored-but-unredeemed entries pass through, so
        short-lived processes do not shrink the artifact.
        """
        path = path or self.path
        if path is None:
            raise ValueError("PlanStore.save: no path given or bound")
        lines = []
        covered = set()
        skipped = 0
        for outer, ckey in self._canonical.items():
            entry = self._plans.get(ckey)
            if entry is None:
                continue
            bkey = ckey[1]
            if not (persistable_key(outer) and persistable_key(bkey)):
                skipped += 1
                continue
            odig = key_digest(outer)
            if (odig, key_digest(bkey)) in self._one_shot:
                skipped += 1
                continue
            lowered = entry[0]
            lines.append(entry_line(
                outer, encode_analysis(lowered.analysis), bkey,
                [encode_lowered(bkey, lowered)], fp2=odig))
            covered.add(odig)
        # entries parsed but not superseded by a live canonical pass
        # through (their canonical bucket was never redeemed here)
        for outer, parsed in self._restored_parsed.items():
            if parsed["fp2"] in covered or not parsed["buckets"]:
                continue
            rec = parsed["buckets"].get(parsed["canonical"]) \
                or next(iter(parsed["buckets"].values()))
            lines.append(entry_line(outer, parsed["analysis"],
                                    rec["bucket"], [rec],
                                    fp2=parsed["fp2"]))
            covered.add(parsed["fp2"])
        # raw entries never touched this process pass through verbatim
        # (checksums were verified at load — no re-hash), capped so a
        # store relayed across many generations cannot accumulate stale
        # entries without bound
        passthrough = sorted(fp2 for fp2 in self._restored_raw
                             if fp2 not in covered)
        skipped += max(0, len(passthrough) - _PASSTHROUGH_CAP)
        for fp2 in passthrough[:_PASSTHROUGH_CAP]:
            lines.append(self._restored_raw[fp2])
        for fp, payload in sorted(self._verdicts.items()):
            lines.append(verdict_line(fp, payload))
        n = write_store(path, lines, one_shot=self._one_shot,
                        fingerprint_version=FINGERPRINT_VERSION)
        self.stats["restore_saved"] = n
        self.stats["restore_skipped"] += skipped
        if path == self.path:
            self._dirty = False
        return n

    @property
    def dirty(self) -> bool:
        """True when plan-level state changed since the last ``save()``
        to the bound path — lets periodic checkpoints (serve idle loop)
        skip rewriting an unchanged artifact."""
        return self._dirty

    # -- verdict level -----------------------------------------------------
    def put_verdict(self, context_fp: str, payload: dict):
        """Record an autotuner verdict (``core.autotune``) for
        persistence; last write per context fingerprint wins."""
        self._verdicts[context_fp] = payload
        self.stats["verdicts_put"] += 1
        self._dirty = True

    def get_verdict(self, context_fp: str) -> Optional[dict]:
        """The persisted/recorded verdict payload for a context
        fingerprint, or ``None`` (caller re-tunes cold)."""
        payload = self._verdicts.get(context_fp)
        if payload is None:
            self.stats["verdict_misses"] += 1
        else:
            self.stats["verdict_hits"] += 1
        return payload

    @property
    def verdict_count(self) -> int:
        return len(self._verdicts)

    def _restored_entry(self, outer) -> Optional[dict]:
        parsed = self._restored_parsed.get(outer)
        if parsed is not None:
            return parsed
        if not self._restored_raw:
            return None
        raw = self._restored_raw.pop(key_digest(outer), None)
        if raw is None:
            return None
        try:
            payload = parse_payload(raw.split(" ", 4)[4])
            # entries are digest-addressed; the salt rides along as a
            # cheap cross-check (full safety comes from rehydrate's
            # plan-fingerprint verification)
            if payload["salt"] != outer[1]:
                raise RestoreError("entry digest does not match its key")
        except RestoreError:
            self.stats["restore_rejected"] += 1
            return None
        parsed = {"fp2": key_digest(outer),
                  "analysis": payload["analysis"],
                  "canonical": payload["canonical"],
                  "buckets": {rec["bucket"]: rec
                              for rec in payload["buckets"]
                              if isinstance(rec, dict) and "bucket" in rec}}
        self._restored_parsed[outer] = parsed
        return parsed

    def _redeem(self, rec, restored, graph, plan, skey, outer,
                key) -> Optional[LoweredPlan]:
        """Exact-bucket restore: rebind callables from the live (graph,
        plan) and admit the result as a live entry — zero ``lower`` and
        zero ``specialize`` cost."""
        t0 = time.perf_counter()
        try:
            lowered = rehydrate(rec, restored["analysis"], graph, plan,
                                struct_key=skey)
        except RestoreError:
            self.stats["restore_rejected"] += 1
            return None
        if not self._verify_restored_plan(lowered):
            return None
        self.stats["restore_s"] += time.perf_counter() - t0
        self.stats["restore_hits"] += 1
        self._insert(outer, key, lowered)
        # a cross-generation reuse is by definition not one-shot
        self._touches[key] = self._touches.get(key, 0) + 1
        return lowered

    def _skeleton_canonical(self, restored, outer, graph, plan,
                            skey) -> Optional[LoweredPlan]:
        """Rehydrate the restored entry's canonical bucket as a fn-less
        skeleton for ``specialize`` to derive *unseen* buckets from.
        ``specialize`` rebinds every callable and rewrites every
        shape-dependent field, so the skeleton's dangling fns and stale
        offsets are never observable.  No memo: whatever follows this
        call — a successful specialize or a cold lower — installs a real
        canonical via ``_insert``, so the skeleton path runs at most
        once per outer entry."""
        rec = restored["buckets"].get(restored["canonical"])
        if rec is None and restored["buckets"]:
            rec = next(iter(restored["buckets"].values()))
        if rec is None:
            return None
        try:
            skel = rehydrate(rec, restored["analysis"], graph, plan,
                             struct_key=skey, bind_fns=False)
        except RestoreError:
            self.stats["restore_rejected"] += 1
            return None
        if not self._verify_restored_plan(skel):
            return None
        self.stats["restore_canonicals"] += 1
        return skel

    def _verify_restored_plan(self, lowered: LoweredPlan) -> bool:
        """Semantic gate behind the checksum: symbolically replay the
        rehydrated slot machine (``core.verify``).  A rejected artifact
        degrades to a cold lower under ``restore_verify_rejected`` — it
        is never admitted, never retried."""
        if not self.verify_restored:
            return True
        from .verify import verify_lowered
        errors = [d for d in verify_lowered(lowered)
                  if d.severity == "error"]
        if errors:
            self.stats["restore_rejected"] += 1
            self.stats["restore_verify_rejected"] += 1
            return False
        return True

    # -- executable level --------------------------------------------------
    def key_for(self, plan_fp: str, inputs: dict) -> tuple:
        """Executable cache key over a plan fingerprint + example inputs.

        Accepts tensors (anything with ``.shape``/``.dtype``) keyed
        structurally and plain Python scalars keyed by type + value.
        Anything else raises — a silently id-keyed object would make
        every lookup a miss and every stale hit a wrong executable.
        """
        items = []
        for k, v in sorted(inputs.items()):
            if hasattr(v, "shape") and hasattr(v, "dtype"):
                items.append((k, tuple(v.shape), dtype_name(v.dtype)))
            elif isinstance(v, (bool, int, float, str, bytes, type(None))):
                items.append((k, "py", type(v).__name__, v))
            else:
                raise TypeError(
                    f"PlanStore.key_for: input {k!r} is neither an array "
                    f"nor a static Python scalar (got {type(v).__name__}); "
                    "it cannot form a stable executable key")
        return (plan_fp, tuple(items))

    def get_or_build(self, key, build: Callable[[], Callable]):
        """The executable under ``key``, built by ``build()`` on a miss.

        A built object with ``capture_s`` and ``nbytes`` (a
        ``GraphStep``) is accounted as a capture: ``compile_s`` gains
        its capture time and its bytes are what the capture took from
        the graph pool; anything else is timed under ``trace_s`` at the
        floor byte estimate."""
        hit = self._execs.get(key)
        if hit is not None:
            self.stats["exec_hits"] += 1
            self._execs.move_to_end(key)
            return hit[0]
        self.stats["exec_misses"] += 1
        t0 = time.perf_counter()
        fn = build()
        dt = time.perf_counter() - t0
        capture_s = getattr(fn, "capture_s", None)
        nbytes = 0
        if capture_s is None:
            self.stats["trace_s"] += dt
        else:
            self.stats["compile_s"] += capture_s
            self.stats["trace_s"] += max(0.0, dt - capture_s)
            nbytes = int(getattr(fn, "nbytes", 0) or 0)
        nbytes = nbytes or _EXEC_DEFAULT_NBYTES
        self._execs[key] = (fn, nbytes)
        self.stats["exec_bytes"] += nbytes
        while len(self._execs) > self.exec_capacity or (
                self.exec_budget_bytes is not None
                and self.stats["exec_bytes"] > self.exec_budget_bytes
                and len(self._execs) > 1):
            _, (_, nb) = self._execs.popitem(last=False)
            self.stats["exec_bytes"] -= nb
            self.stats["exec_evictions"] += 1
        return fn

    def evict_execs(self, match: Callable[[tuple], bool]) -> int:
        """Drop every executable whose key ``match``es (the serve engine
        drops its graphs when it is collected: they bind its buffers);
        counted as evictions.  Returns how many went."""
        gone = [k for k in list(self._execs) if match(k)]
        for k in gone:
            _, nb = self._execs.pop(k)
            self.stats["exec_bytes"] -= nb
            self.stats["exec_evictions"] += 1
        return len(gone)

    @property
    def exec_hit_rate(self) -> float:
        """Fraction of executable lookups served from cache (the plan
        level's ``share_rate`` analogue)."""
        total = self.stats["exec_hits"] + self.stats["exec_misses"]
        return self.stats["exec_hits"] / total if total else 0.0

    # -- introspection -----------------------------------------------------
    @property
    def n_plans(self) -> int:
        return len(self._plans)

    @property
    def n_execs(self) -> int:
        return len(self._execs)

    @property
    def n_restorable(self) -> int:
        """Restored entries staged but not yet redeemed."""
        return len(self._restored_raw) + sum(
            len(p["buckets"]) for p in self._restored_parsed.values())

    def __len__(self):
        return len(self._plans) + len(self._execs)

    def snapshot(self) -> dict:
        out = dict(self.stats)
        out["n_plans"] = self.n_plans
        out["n_execs"] = self.n_execs
        out["n_restorable"] = self.n_restorable
        out["share_rate"] = round(self.share_rate, 4)
        out["exec_hit_rate"] = round(self.exec_hit_rate, 4)
        return out


def resolve_plan_store(plan_store, plan_store_path) -> Optional[PlanStore]:
    """Bind a ``PlanStore`` to an on-disk artifact.

    No path: the given store (possibly ``None``) unchanged.  Path only:
    open/warm-start a store from it.  Both: bind the path to the given
    store so ``checkpoint_plan_store`` writes back.  Shared by
    ``api.compile`` and the serve engine, so a restarted server skips
    re-lowering.
    """
    if not plan_store_path:
        return plan_store
    if plan_store is None:
        return PlanStore.open(plan_store_path)
    plan_store.path = plan_store_path
    return plan_store


def checkpoint_plan_store(plan_store) -> int:
    """Persist a path-bound store (no-op otherwise); builders call this
    right after lowering so the artifact exists even if the process
    dies before serving a single step."""
    if plan_store is not None and plan_store.path:
        return plan_store.save()
    return 0


GLOBAL_STORE = PlanStore()
