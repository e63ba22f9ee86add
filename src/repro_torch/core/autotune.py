"""Cost-model-driven autotuning — closing the programmable-scheduling loop.

The paper's thesis is that the *choice* of intra-device parallelism
strategy should be programmable per execution context (§3).  ``dynamic``
programs that choice by hand (threshold tables); :class:`AutoPolicy`
programs it with the repo's own roofline model: per
:class:`~repro_torch.core.scheduler.ScheduleContext` it

  1. enumerates every candidate (strategy × parameterization) the
     strategy registry declares tunable (``registry.tunable_candidates``),
     plus — for small graphs — an enumerative :class:`ExhaustiveOrder`
     sweep over topological orders, the brute-force floor no hand-written
     strategy should lose to;
  2. records each candidate's plan on the *same partitioned graph*
     ``build_forward`` will execute (the union of every candidate's
     partition rules) and ranks them by modeled exposed time
     (:func:`~repro_torch.roofline.overlap.plan_overlap`, charged with the
     Fig. 2a split-weight re-read penalty) with peak prealloc memory as
     the pareto second axis;
  3. optionally refines the model's top-K by measuring real step times
     through the existing lowering path (pass ``measurer=``, e.g.
     :func:`realizer_measurer`);
  4. records a :class:`TuningVerdict` — winner identity, full scoreboard,
     measurement provenance — keyed by a context fingerprint, and
     persists it into the PlanStore artifact (versioned ``V`` records,
     ``core/plan_serde.py``), so a restarted process inherits every
     decision with **zero** re-tunes.

``AutoPolicy`` is an ordinary :class:`~repro_torch.core.policy.StrategyPolicy`:
``api.compile(model, policy="auto")`` is the whole user surface, and its
``identity()`` salts the outer plan key exactly like any other policy —
two AutoPolicies with different candidate sets or cost-model calibration
never alias persisted plans.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Optional

from .. import hw
from ..roofline.overlap import plan_overlap, split_weight_penalty
from .analysis import static_analysis
from .graph import FULL, OpGraph
from .partition import partition
from .plan import ExecutionPlan, OpHandle, PlanStep, graph_fingerprint
from .policy import StrategyPolicy
from .scheduler import OpSchedulerBase, ScheduleContext, record_plan
from .strategies import registry

# Version of the verdict semantics (candidate scoring + fingerprint
# recipe).  Enters every verdict payload and the AutoPolicy identity:
# bumping it orphans persisted verdicts (cold re-tune) instead of
# replaying decisions made under different rules.
AUTOTUNE_VERSION = 1


def context_fingerprint(info: ScheduleContext, graph: OpGraph) -> str:
    """Stable key of one tuning decision: the schedule-relevant context
    fields plus the (unpartitioned) graph structure.  Anything that can
    change which candidate wins must enter here."""
    payload = (info.arch, info.phase, int(info.local_batch),
               int(info.seq_len),
               tuple(sorted((str(k), int(v))
                            for k, v in (info.mesh_shape or {}).items())),
               graph_fingerprint(graph))
    return hashlib.sha256(repr(payload).encode()).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class TuningVerdict:
    """One persisted tuning decision (who won, by how much, and how we
    know) — the unit ``PlanStore.put_verdict`` serializes."""

    context_fp: str
    winner: str                     # registry name, or "exhaustive"
    params: tuple                   # ((kwarg, value), ...) for the winner
    identity: str                   # repr of the winner's scheduler_identity
    t_model: float                  # modeled step seconds of the winner
    t_sequential: float             # modeled sequential-baseline seconds
    peak_bytes: int                 # winner's prealloc buffer footprint
    provenance: str                 # "model" | "measured"
    scores: tuple                   # ((label, t_model, peak_bytes), ...)
    measured_s: float = 0.0         # live/measured seconds (0 = none yet)
    # candidates excluded from the scoreboard and why:
    # ((label, code, message), ...) — code is a verify diagnostic code
    # ("VFY003", ...) or an exception class name for record-time crashes
    pruned: tuple = ()
    version: int = AUTOTUNE_VERSION
    arch: str = ""
    phase: str = ""
    local_batch: int = 0
    seq_len: int = 0

    def to_payload(self) -> dict:
        d = dataclasses.asdict(self)
        d["params"] = [[k, v] for k, v in self.params]
        d["scores"] = [[label, t, mem] for label, t, mem in self.scores]
        d["pruned"] = [[label, code, msg]
                       for label, code, msg in self.pruned]
        return d

    @classmethod
    def from_payload(cls, payload: dict) -> "TuningVerdict":
        d = dict(payload)
        if d.get("version") != AUTOTUNE_VERSION:
            raise ValueError(
                f"verdict version {d.get('version')!r} != {AUTOTUNE_VERSION}")
        missing = {f.name for f in dataclasses.fields(cls)
                   if f.default is dataclasses.MISSING} - set(d)
        if missing:
            raise ValueError(f"verdict payload missing {sorted(missing)}")
        d["params"] = tuple((str(k), v) for k, v in d["params"])
        d["scores"] = tuple((str(label), float(t), int(mem))
                            for label, t, mem in d["scores"])
        d["pruned"] = tuple((str(label), str(code), str(msg))
                            for label, code, msg in d.get("pruned") or ())
        return cls(**{k: v for k, v in d.items()
                      if k in {f.name for f in dataclasses.fields(cls)}})


def pareto_front(points):
    """Indices of the (t, mem)-pareto-optimal entries of
    ``[(label, t, mem), ...]`` — no other entry is <= on both axes and <
    on one."""
    keep = []
    for i, (_, t_i, m_i) in enumerate(points):
        dominated = any(
            (t_j <= t_i and m_j <= m_i) and (t_j < t_i or m_j < m_i)
            for j, (_, t_j, m_j) in enumerate(points) if j != i)
        if not dominated:
            keep.append(i)
    return keep


# -- enumerative fallback -----------------------------------------------------


def _topo_orders(graph: OpGraph, max_orders: int) -> list:
    """All linear extensions of the graph's dependency order, bounded by
    ``max_orders`` (deterministic: branches explored in oid order)."""
    deps = {oid: graph.node_deps(oid) for oid in graph.topo_order()}
    orders: list = []
    order: list = []
    done: set = set()

    def rec():
        if len(orders) >= max_orders:
            return
        if len(order) == len(deps):
            orders.append(tuple(order))
            return
        for oid in deps:
            if oid in done or not deps[oid] <= done:
                continue
            done.add(oid)
            order.append(oid)
            rec()
            done.discard(oid)
            order.pop()

    rec()
    return orders


def _order_plan(graph: OpGraph, order) -> ExecutionPlan:
    steps = [PlanStep("exec", (OpHandle(oid, FULL, graph.nodes[oid].name),))
             for oid in order]
    return ExecutionPlan(steps, (), graph_fingerprint(graph))


class ExhaustiveOrder(OpSchedulerBase):
    """Enumerate every topological order of a (small) graph, score each
    with the overlap model, and replay the best — the paper's "search
    the schedule space" floor for graphs where enumeration is feasible.

    Gated by ``max_ops`` (beyond it: sequential fallback, enumeration is
    factorial) and ``max_orders`` (search budget).  Deterministic: ties
    keep the first order in oid-lexicographic enumeration."""

    name = "exhaustive"

    def __init__(self, max_ops: int = 9, max_orders: int = 256,
                 tp: int = 16, bw_scale: float = 1.0,
                 coll_latency_s: float = hw.COLL_LATENCY_S):
        self.max_ops = max_ops
        self.max_orders = max_orders
        self.tp = tp
        self.bw_scale = bw_scale
        self.coll_latency_s = coll_latency_s

    def identity(self):
        return ("exhaustive", self.max_ops, self.max_orders, self.tp,
                self.bw_scale, self.coll_latency_s)

    def best_order(self, graph: OpGraph):
        """(order, t_overlapped) of the best enumerated order, or None
        when the graph exceeds ``max_ops``."""
        if len(graph.nodes) > self.max_ops:
            return None
        best = None
        for order in _topo_orders(graph, self.max_orders):
            t = plan_overlap(graph, _order_plan(graph, order), tp=self.tp,
                             bw_scale=self.bw_scale,
                             coll_latency_s=self.coll_latency_s).t_overlapped
            if best is None or t < best[1]:
                best = (order, t)
        return best

    def schedule(self, ctx):
        best = self.best_order(ctx.graph)
        if best is None:
            ctx.run_rest_sequential()
            return
        for oid in best[0]:
            ctx.execute(OpHandle(oid, FULL, ctx.graph.nodes[oid].name))


# -- measured refinement ------------------------------------------------------


def realizer_measurer(params, inputs, repeats: int = 2) -> Callable:
    """Build a ``measurer(info, graph, plan) -> seconds | None`` that
    times real executions through the port's lowering path
    (:class:`~repro_torch.core.backend.Realizer`): one warm-up call, then
    the best of ``repeats`` — CUDA events around each call, then a
    synchronize, when the inputs live on the card; ``perf_counter`` on
    the CPU.  ``params`` and ``inputs`` are the trees the realized plan
    is called with, or callables ``(info, graph) -> tree`` when one
    measurer serves several segments (an embed, a layer stack and a
    head have different params and inputs).  On the card the plan runs
    over its per-resource streams, which fork from the current stream
    and join back into it before the call returns (``core/streams.py``),
    so the two events on the current stream bracket every stream's
    work.  Returns ``None`` (the
    candidate keeps its modeled score) when the plan cannot be realized
    — it fails to lower or to schedule; any other error, a CUDA error
    included, propagates."""
    import time

    import torch

    from .lowering import LoweringError
    from .scheduler import ScheduleError

    def measure(info, graph, plan):
        p = params(info, graph) if callable(params) else params
        x = inputs(info, graph) if callable(inputs) else inputs
        try:
            from .backend import Realizer
            run = Realizer(graph, plan)
        except (LoweringError, ScheduleError):
            return None
        leaf = next((t for t in _leaves(x) if torch.is_tensor(t)), None)
        cuda = leaf is not None and leaf.device.type == "cuda"
        run(p, x)                                           # warm-up
        best = None
        for _ in range(repeats):
            if cuda:
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                run(p, x)
                t1.record()
                torch.cuda.synchronize(leaf.device)
                dt = t0.elapsed_time(t1) / 1e3
            else:
                t0 = time.perf_counter()
                run(p, x)
                dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        return best

    return measure


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _portable_identity(sched) -> str:
    """``repr`` of the winner's ``scheduler_identity`` with its class's
    module named in the layout this package shares with the JAX package
    (``core.strategies.<name>`` under the top-level name ``repro``), so
    a ``V`` record is the same bytes whichever of the two packages
    decided it."""
    from .plan import scheduler_identity
    top = __name__.split(".")[0]
    return repr(scheduler_identity(sched)).replace(f"'{top}.", "'repro.")


# -- the policy ---------------------------------------------------------------


class AutoPolicy(StrategyPolicy):
    """Rank every registered candidate with the roofline overlap model
    and schedule each context with the winner; see the module docstring
    for the full loop.  Construct via ``api.compile(policy="auto")`` /
    ``AutoPolicy(...)`` for custom calibration.  The default calibration
    is the H100 of ``hw.py``; ``tp=16`` models the plans of a 16-way
    tensor-parallel deployment, as the JAX package's default does."""

    name = "auto"

    def __init__(self, tp: int = 16, bw_scale: float = 1.0,
                 coll_latency_s: float = hw.COLL_LATENCY_S,
                 exhaustive_max_ops: int = 9,
                 exhaustive_max_orders: int = 256,
                 measure_top_k: int = 0,
                 measurer: Optional[Callable] = None):
        self.tp = tp
        self.bw_scale = bw_scale
        self.coll_latency_s = coll_latency_s
        self.exhaustive_max_ops = exhaustive_max_ops
        self.exhaustive_max_orders = exhaustive_max_orders
        self.measure_top_k = measure_top_k
        self.measurer = measurer
        self.retunes = 0                 # cold tunes this process
        self._store = None               # bound PlanStore (verdict home)
        self._verdicts: dict = {}        # context_fp -> TuningVerdict
        self._schedulers: dict = {}      # context_fp -> scheduler
        self._ctx_groups: dict = {}      # (arch, phase, b, s) -> {fp}
        # speculative-decode draft-k feedback (ServeEngine spec loop):
        # (arch, k) -> {"rate", "seconds", "steps"} EWMAs
        self._spec_obs: dict = {}
        self._spec_loaded: set = set()   # arches with persisted obs read

    # identity() deliberately excludes the measurement knobs: a measured
    # and a model-only AutoPolicy share the verdict namespace (measured
    # verdicts are refinements, not different policies), and a different
    # *winner* already separates outer plan keys via the structural key.
    def identity(self):
        cands = tuple((name, tuple(sorted(params.items())))
                      for name, params in registry.tunable_candidates())
        return ("auto", AUTOTUNE_VERSION, self.tp, self.bw_scale,
                self.coll_latency_s, self.exhaustive_max_ops,
                self.exhaustive_max_orders, cands)

    def partition_rules(self):
        # union over every candidate: partitioning must not depend on
        # which candidate a context selects (StrategyPolicy contract)
        rules, seen = [], set()
        for name, params in registry.tunable_candidates():
            try:
                sched = registry.make_scheduler(name, **params)
            except Exception:
                continue
            for r in sched.partition_rules():
                key = repr(r)
                if key not in seen:
                    seen.add(key)
                    rules.append(r)
        return rules

    # -- store plumbing ------------------------------------------------------
    def bind_store(self, store):
        """Attach the PlanStore that persists verdicts (``api.compile``
        and ``ServeEngine`` call this with the store they resolved)."""
        self._store = store

    # -- StrategyPolicy ------------------------------------------------------
    def __call__(self, ctx: ScheduleContext) -> OpSchedulerBase:
        graph = (ctx.extra or {}).get("graph")
        if graph is None:
            # no graph rode along (bare resolve_strategy without graph=):
            # nothing to rank — defer to the hand-written selection
            from .strategies.dynamic import dynamic_policy
            return dynamic_policy()(ctx)
        fp = context_fingerprint(ctx, graph)
        v = self._verdicts.get(fp)
        if v is None and self._store is not None:
            payload = self._store.get_verdict(fp)
            if payload is not None:
                try:
                    v = TuningVerdict.from_payload(payload)
                except (ValueError, KeyError, TypeError):
                    v = None            # corrupt/foreign verdict: re-tune
                else:
                    self._verdicts[fp] = v
        if v is None:
            v = self._tune(ctx, graph, fp)
        self._ctx_groups.setdefault(
            (v.arch, v.phase, v.local_batch, v.seq_len), set()).add(fp)
        return self._scheduler_of(fp, v)

    # -- tuning --------------------------------------------------------------
    def _tuning_graph(self, graph: OpGraph) -> OpGraph:
        if any(n.members for n in graph.nodes.values()):
            return graph                # already partitioned (pick path)
        return partition(graph, self.partition_rules(), default_depth=2)

    def _score(self, g: OpGraph, plan: ExecutionPlan, tp: int):
        rep = plan_overlap(
            g, plan, tp=tp,
            extra_weight_read_bytes=split_weight_penalty(g, plan.num_mb),
            bw_scale=self.bw_scale, coll_latency_s=self.coll_latency_s)
        return rep, static_analysis(g, plan).buffer_bytes

    def _tune(self, info: ScheduleContext, graph: OpGraph,
              fp: str) -> TuningVerdict:
        self.retunes += 1
        g = self._tuning_graph(graph)
        tp = int((info.mesh_shape or {}).get("tp") or self.tp)
        scored = []     # (label, name, params, plan, t, mem, t_seq)
        pruned = []     # (label, code, message) — the verdict scoreboard
        for name, params in registry.tunable_candidates():
            label = name if not params else \
                name + "(" + ",".join(f"{k}={v}"
                                      for k, v in sorted(params.items())) \
                + ")"
            cand = self._try_candidate(label, g, info, tp, pruned,
                                       lambda: registry.make_scheduler(
                                           name, **params))
            if cand is not None:
                plan, rep, mem = cand
                scored.append((label, name, tuple(sorted(params.items())),
                               plan, rep.t_overlapped, mem,
                               rep.t_sequential))
        if len(g.nodes) <= self.exhaustive_max_ops:
            cand = self._try_candidate(
                "exhaustive", g, info, tp, pruned,
                lambda: ExhaustiveOrder(self.exhaustive_max_ops,
                                        self.exhaustive_max_orders, tp,
                                        self.bw_scale,
                                        self.coll_latency_s))
            if cand is not None:
                plan, rep, mem = cand
                scored.append(("exhaustive", "exhaustive", (), plan,
                               rep.t_overlapped, mem, rep.t_sequential))
        if not scored:
            why = "; ".join(f"{lab}: [{code}] {msg}"
                            for lab, code, msg in pruned[:4])
            raise RuntimeError(
                f"autotuner found no viable candidate for context "
                f"{info.arch}/{info.phase} (graph of {len(g.nodes)} units)"
                + (f"; pruned: {why}" if why else ""))

        provenance = "model"
        measured_s = 0.0
        if self.measure_top_k > 0 and self.measurer is not None:
            scored.sort(key=lambda c: (c[4], c[5],
                                   c[1] != "sequential", c[0]))
            top = scored[:self.measure_top_k]
            times = [self.measurer(info, g, c[3]) for c in top]
            if any(t is not None for t in times):
                provenance = "measured"
                # measured seconds override the model for the refined set
                scored = [
                    (lab, nm, pr, pl, (t if t is not None else tm), mem,
                     ts)
                    for (lab, nm, pr, pl, tm, mem, ts), t
                    in zip(top, times)
                ] + scored[self.measure_top_k:]

        scored.sort(key=lambda c: (c[4], c[5],
                                   c[1] != "sequential", c[0]))
        points = [(lab, t, mem) for lab, _, _, _, t, mem, _ in scored]
        front = set(pareto_front(points))
        win = scored[0]
        if provenance == "measured":
            measured_s = win[4]
        seq = next((c for c in scored if c[1] == "sequential"), None)
        t_sequential = seq[4] if seq is not None else win[6]
        sched = self._instantiate(win[1], dict(win[2]), tp)
        v = TuningVerdict(
            context_fp=fp, winner=win[1], params=win[2],
            identity=_portable_identity(sched),
            t_model=win[4], t_sequential=t_sequential, peak_bytes=win[5],
            provenance=provenance,
            scores=tuple(points[i] for i in range(len(points))
                         if i in front or i < 4),
            measured_s=measured_s,
            pruned=tuple(pruned),
            arch=info.arch, phase=info.phase,
            local_batch=int(info.local_batch), seq_len=int(info.seq_len))
        self._verdicts[fp] = v
        self._schedulers[fp] = sched
        if self._store is not None:
            self._store.put_verdict(fp, v.to_payload())
        return v

    def _try_candidate(self, label: str, g: OpGraph,
                       info: ScheduleContext, tp: int, pruned: list,
                       make: Callable):
        """Record, verify and score one candidate.  A candidate that
        crashes during recording or whose plan fails static verification
        is *pruned* — excluded with a typed (label, code, message) row on
        the verdict scoreboard — never silently swallowed and never
        allowed to abort the sweep."""
        from .verify import verify as verify_plan_fn
        try:
            sched = make()
            plan = record_plan(g, sched, info)
        except Exception as e:                          # noqa: BLE001
            pruned.append((label, type(e).__name__, str(e)[:200]))
            return None
        report = verify_plan_fn(g, plan)
        if not report.ok:
            d = report.errors[0]
            pruned.append((label, d.code, str(d)[:200]))
            return None
        try:
            rep, mem = self._score(g, plan, tp)
        except Exception as e:                          # noqa: BLE001
            pruned.append((label, type(e).__name__,
                           f"cost model failed: {str(e)[:160]}"))
            return None
        return plan, rep, mem

    def _instantiate(self, winner: str, params: dict, tp: int):
        if winner == "exhaustive":
            return ExhaustiveOrder(self.exhaustive_max_ops,
                                   self.exhaustive_max_orders, tp,
                                   self.bw_scale, self.coll_latency_s)
        return registry.make_scheduler(winner, **params)

    def _scheduler_of(self, fp: str, v: TuningVerdict):
        sched = self._schedulers.get(fp)
        if sched is None:
            tp = self.tp
            sched = self._instantiate(v.winner, dict(v.params), tp)
            self._schedulers[fp] = sched
        return sched

    # -- introspection / live feedback --------------------------------------
    def lookup(self, info: ScheduleContext,
               graph: OpGraph) -> Optional[TuningVerdict]:
        """The verdict this policy holds for (context, graph), if any —
        memory first, then the bound store (no tuning)."""
        fp = context_fingerprint(info, graph)
        v = self._verdicts.get(fp)
        if v is None and self._store is not None:
            payload = self._store.get_verdict(fp)
            if payload is not None:
                try:
                    v = TuningVerdict.from_payload(payload)
                except (ValueError, KeyError, TypeError):
                    return None
        return v

    def observe(self, *, phase: str, arch: str, local_batch: int,
                seq_len: int, seconds: float, stats: Optional[dict] = None):
        """Live feedback from the serving loop: fold a measured step time
        (EWMA) into every verdict recorded for this context group and
        persist meaningful changes, so ``explain()`` and future processes
        see model-vs-reality drift.

        Speculative-decode feedback (``stats`` carrying ``draft_k``)
        routes to the per-(arch, k) acceptance/latency EWMAs behind
        :meth:`spec_draft_k` instead."""
        if stats and "draft_k" in stats:
            self._observe_spec(arch, int(stats["draft_k"]), seconds, stats)
            return
        del stats   # reserved: admission/store counters for future re-tune
        key = (arch, phase, int(local_batch), int(seq_len))
        for fp in self._ctx_groups.get(key, ()):
            v = self._verdicts.get(fp)
            if v is None:
                continue
            ewma = seconds if v.measured_s <= 0.0 else \
                0.8 * v.measured_s + 0.2 * seconds
            changed = v.measured_s <= 0.0 or \
                abs(ewma - v.measured_s) > 0.2 * v.measured_s
            v = dataclasses.replace(v, measured_s=ewma)
            self._verdicts[fp] = v
            if changed and self._store is not None:
                self._store.put_verdict(fp, v.to_payload())

    # -- speculative draft-k tuning ------------------------------------------
    def _spec_fp(self, arch: str) -> str:
        """Synthetic verdict key for the per-arch draft-k scoreboard —
        same PlanStore verdict namespace, disjoint by construction from
        any schedule-context fingerprint."""
        payload = ("spec_decode", AUTOTUNE_VERSION, arch)
        return hashlib.sha256(repr(payload).encode()).hexdigest()[:16]

    def _spec_load(self, arch: str):
        if arch in self._spec_loaded:
            return
        self._spec_loaded.add(arch)
        if self._store is None:
            return
        payload = self._store.get_verdict(self._spec_fp(arch))
        if not payload or payload.get("version") != AUTOTUNE_VERSION:
            return
        for ks, rec in (payload.get("obs") or {}).items():
            try:
                self._spec_obs.setdefault((arch, int(ks)), {
                    "rate": float(rec["rate"]),
                    "seconds": float(rec["seconds"]),
                    "steps": int(rec["steps"])})
            except (KeyError, TypeError, ValueError):
                continue            # corrupt/foreign entry: re-learn

    def _observe_spec(self, arch: str, k: int, seconds: float,
                      stats: dict):
        self._spec_load(arch)
        rec = self._spec_obs.setdefault(
            (arch, k), {"rate": 0.0, "seconds": 0.0, "steps": 0})
        rate = float(stats.get("acceptance_rate") or 0.0)
        if rec["steps"] == 0:
            rec["rate"], rec["seconds"] = rate, float(seconds)
        else:
            rec["rate"] = 0.8 * rec["rate"] + 0.2 * rate
            rec["seconds"] = 0.8 * rec["seconds"] + 0.2 * float(seconds)
        rec["steps"] += 1
        # persist on first sight and then sparsely — the serve loop
        # calls this once per verify step
        if self._store is not None and rec["steps"] % 8 == 1:
            obs = {str(kk): dict(v)
                   for (a, kk), v in self._spec_obs.items() if a == arch}
            self._store.put_verdict(self._spec_fp(arch), {
                "kind": "spec_decode", "version": AUTOTUNE_VERSION,
                "arch": arch, "obs": obs})

    def spec_draft_k(self, *, arch: str, candidates) -> int:
        """Pick the draft length for ``SpecConfig(k="auto")``: explore
        each candidate once, then maximize expected accepted-tokens/s —
        ``(1 + k * acceptance_rate(k)) / seconds(k)`` from the live
        EWMAs (seeded from the persisted scoreboard on restart)."""
        self._spec_load(arch)
        for k in candidates:
            if (arch, int(k)) not in self._spec_obs:
                return int(k)

        def score(k):
            rec = self._spec_obs[(arch, int(k))]
            return (1.0 + int(k) * rec["rate"]) \
                / max(rec["seconds"], 1e-9)

        return int(max(candidates, key=score))

    def explain(self) -> list:
        """Decision table: one row per verdict this policy holds, sorted
        by (arch, phase, tokens) — the payload behind
        ``Program.explain()``."""
        rows = []
        for fp, v in self._verdicts.items():
            rows.append({
                "context": f"{v.arch}/{v.phase} b={v.local_batch} "
                           f"s={v.seq_len}",
                "arch": v.arch, "phase": v.phase,
                "local_batch": v.local_batch, "seq_len": v.seq_len,
                "winner": v.winner, "params": dict(v.params),
                "t_model_us": round(v.t_model * 1e6, 2),
                "t_sequential_us": round(v.t_sequential * 1e6, 2),
                "speedup": round(v.t_sequential / max(v.t_model, 1e-12), 3),
                "peak_bytes": v.peak_bytes,
                "provenance": v.provenance,
                "measured_us": round(v.measured_s * 1e6, 2),
                "scores": list(v.scores),
                "pruned": list(v.pruned),
                "context_fp": fp,
            })
        rows.sort(key=lambda r: (r["arch"], r["phase"], r["local_batch"],
                                 r["seq_len"]))
        return rows
