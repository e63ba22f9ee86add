"""Plan lowering — compile an ExecutionPlan to a slot-based instruction IR.

The interpreted backend (``Realizer`` with ``lowered=False``) re-derives
everything per step at call time: dict-keyed ``(tid, part)`` env lookups,
read-mode resolution, param-path walks, merge-buffer bookkeeping.  That
interpretation layer dominates plan-to-dispatch latency — the cost the
paper's CUDA-graph mode (§3.3.2) engineers away.

``lower(graph, plan, analysis)`` simulates the plan once against the
Alg.-1 analysis and emits a flat ``LoweredPlan`` whose instructions are
fully pre-resolved:

  * every read is an integer **env slot** (the env becomes a flat list);
    slots are allocated from liveness, so a dead tensor's slot is reused
    by later writes instead of dict-popped,
  * every micro-batch slice carries precomputed ``(axis, offset, size)``
    and is taken as a ``narrow`` view (zero-copy),
  * every step's param subtree is an index into one per-call resolved
    param list (one path-walk pass per call, not per step),
  * prealloc merge buffers are **created by the first producer**: it
    allocates the buffer with ``torch.empty`` and writes its slice in
    place; later producers write theirs through ``narrow(...).copy_()``.
    No zero fill: Alg. 1 only lets a merged read resolve once every
    slice has landed.

Replaying the ``LoweredPlan`` is a thin loop: list-index reads, one
callable per step, list-index frees at the precomputed death sites.

There is no per-plan capture here.  A CUDA Graph bakes in every address
it touches, and the layer loop (``models/base.py``) hands each call of a
layer plan another layer's slice of the stacked params and caches, so a
single plan's call has no fixed addresses to capture.  The unit with
fixed addresses is the whole step — forward, cache update, argmax and
masks over buffers the serve engine owns — and that is what
``serve/engine.py`` captures, one CUDA Graph per decode tier and per
prefill group (``core/capture.py``).  ``LoweredPlan.capture`` keeps the
place of the JAX package's jaxpr-capture flag: it records that the step
running the plan is captured, and the PlanStore keys on it
(``core/plan_store.py:bucket_key``); nothing here reads it.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Optional

from .analysis import BUF, AnalysisResult, static_analysis
from .graph import FULL, OpGraph
from .plan import ExecutionPlan, graph_fingerprint, structural_key


class LoweringError(ValueError):
    """Plan / analysis / graph triple is inconsistent — refuse to lower."""


@dataclasses.dataclass
class Instr:
    """One pre-resolved plan step.

    ``reads``  — ((slot, slice), ...); slice is None or (axis, off, size)
    ``writes`` — ((slot, buf), ...); slot -1 drops the value (dead at
                 birth), buf is None or (buf_slot, start, pad_cfg, axis):
                 pad_cfg set => this write creates the merge buffer, its
                 extent along each dim being the value's plus
                 ``(before, after, 0)`` (``lax.pad``'s layout, as the
                 JAX package records it); else the value lands at
                 ``start[axis]`` along ``axis`` of the existing buffer.
    ``frees``  — env slots cleared after the step (death sites).

    Not frozen: ``specialize`` re-derives instrs per shape bucket via
    shallow copy + targeted field writes.  Treat instances as immutable
    otherwise.
    """

    fn: Callable
    reads: tuple
    writes: tuple
    frees: tuple
    fused: bool = False
    param_ix: int = -1                 # index into the resolved param list
    member_pairs: Optional[tuple] = None   # ((path, ix), ...) composite node
    fused_pairs: tuple = ()            # ((path, ix), ...) fused param dict
    step: Any = None                   # originating PlanStep (fused info)
    ext_inputs: tuple = ()             # fused: external (tid, part) reads
    ext_outputs: tuple = ()            # fused: external (tid, part) writes
    label: str = ""


@dataclasses.dataclass
class LoweredPlan:
    """Flat instruction stream + metadata; callable like a Realizer."""

    graph: OpGraph
    split_sizes: tuple
    instrs: tuple
    input_slots: tuple                 # ((graph input name, slot), ...)
    output_slots: tuple                # ((graph output name, slot), ...)
    param_paths: tuple                 # distinct param paths, index order
    n_slots: int
    fingerprint: str
    analysis: AnalysisResult
    stats: dict
    capture: bool = False              # run inside a captured CUDA Graph
    struct_key: tuple = ()             # shape-free (graph, plan) identity
    _spec_cache: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def __call__(self, params, inputs: dict) -> dict:
        from .backend import FusedCallInfo, _resolve_path
        pvals = [_resolve_path(params, p) for p in self.param_paths]
        env: list = [None] * self.n_slots
        for name, slot in self.input_slots:
            if name not in inputs:
                raise KeyError(f"missing graph input {name!r}")
            env[slot] = inputs[name]
        for ins in self.instrs:
            args = []
            for slot, sl in ins.reads:
                v = env[slot]
                if sl is not None:
                    v = v.narrow(*sl)
                args.append(v)
            if ins.fused:
                pdict = {p: pvals[ix] for p, ix in ins.fused_pairs}
                info = FusedCallInfo(ins.step, self.graph,
                                     list(ins.ext_inputs),
                                     list(ins.ext_outputs),
                                     self.split_sizes, pdict)
                outs = ins.fn(info, *args)
            else:
                if ins.member_pairs is not None:
                    p = {pp: pvals[ix] for pp, ix in ins.member_pairs}
                elif ins.param_ix >= 0:
                    p = pvals[ins.param_ix] or {}
                else:
                    p = {}
                outs = ins.fn(p, *args)
            if not isinstance(outs, tuple):
                outs = (outs,)
            if len(outs) != len(ins.writes):
                raise ValueError(
                    f"{ins.label} returned {len(outs)} outputs; expected "
                    f"{len(ins.writes)}")
            for (slot, buf), v in zip(ins.writes, outs):
                if slot >= 0:
                    env[slot] = v
                if buf is not None:
                    bslot, start, pad_cfg, axis = buf
                    if pad_cfg is not None:
                        before, after, _ = pad_cfg[axis]
                        shape = list(v.shape)
                        shape[axis] += before + after
                        b = env[bslot] = v.new_empty(shape)
                        b.narrow(axis, before, v.shape[axis]).copy_(v)
                    else:
                        env[bslot].narrow(axis, start[axis],
                                          v.shape[axis]).copy_(v)
            for s in ins.frees:
                env[s] = None
        return {name: env[slot] for name, slot in self.output_slots}


def _pad_cfg(ref, off: int, size: int) -> tuple:
    bd = ref.batch_dim
    return tuple((off, ref.shape[d] - off - size, 0) if d == bd
                 else (0, 0, 0) for d in range(len(ref.shape)))


def _start(ref, off: int) -> tuple:
    bd = ref.batch_dim
    return tuple(off if d == bd else 0 for d in range(len(ref.shape)))


def lower(graph: OpGraph, plan: ExecutionPlan,
          analysis: Optional[AnalysisResult] = None,
          capture: bool = False) -> LoweredPlan:
    """Compile ``(plan, analysis, graph)`` into a ``LoweredPlan``."""
    if plan.graph_fingerprint:
        gfp = graph_fingerprint(graph)
        if plan.graph_fingerprint != gfp:
            raise LoweringError(
                f"plan was recorded for graph {plan.graph_fingerprint}, "
                f"got graph {gfp}")
    plan_fp = plan.fingerprint()
    if analysis is None:
        analysis = static_analysis(graph, plan)
    if analysis.plan_fingerprint and analysis.plan_fingerprint != plan_fp:
        raise LoweringError(
            f"analysis belongs to plan {analysis.plan_fingerprint}, "
            f"got plan {plan_fp}")
    if analysis.n_steps != len(plan.steps):
        raise LoweringError(
            f"analysis covers {analysis.n_steps} steps, plan has "
            f"{len(plan.steps)}")

    offsets = []
    acc = 0
    for s in plan.split_sizes:
        offsets.append(acc)
        acc += s

    deaths_by_step: dict[int, list] = {}
    for key, d in analysis.death.items():
        deaths_by_step.setdefault(d, []).append(key)

    # slot allocator: liveness-driven reuse
    slot_of: dict = {}
    free: list[int] = []
    n_slots = 0
    reused = 0

    def alloc(pending: list[int]) -> int:
        nonlocal n_slots, reused
        if pending:
            reused += 1
            return pending.pop()
        if free:
            reused += 1
            return free.pop()
        s = n_slots
        n_slots += 1
        return s

    # param-path interning: one resolve pass per call, integer refs per step
    path_ix: dict = {}

    def ix_of(path) -> int:
        if path not in path_ix:
            path_ix[path] = len(path_ix)
        return path_ix[path]

    input_slots = []
    for name, t in graph.inputs.items():
        slot_of[(t, FULL)] = alloc([])
        input_slots.append((name, slot_of[(t, FULL)]))

    def slot_for_read(t, part, mode, key, i):
        try:
            if mode == "direct":
                return slot_of[(t, key)]
            if mode == "assemble":
                return slot_of[(t, BUF)]
            return slot_of[(t, FULL)]          # slice
        except KeyError:
            raise LoweringError(
                f"step {i} reads tensor {t} part {part} ({mode}) before "
                "any live producer — plan/analysis mismatch") from None

    pad_inits = 0
    instrs = []
    for i, step in enumerate(plan.steps):
        reads = []
        for (t, p, mode, key) in analysis.reads[i]:
            slot = slot_for_read(t, p, mode, key, i)
            sl = None
            if mode == "slice":
                ref = graph.tensors[t]
                sl = (ref.batch_dim, offsets[p], plan.split_sizes[p])
            reads.append((slot, sl))

        # keys whose last read was this step free up before the writes,
        # so this step's outputs can reuse their slots (reads are already
        # materialized as Python references when the writes land)
        pending = []
        for key in deaths_by_step.get(i, ()):
            if key in slot_of:
                pending.append(slot_of.pop(key))

        writes = []
        for (t, p) in analysis.writes[i]:
            key = (t, p)
            if analysis.death.get(key) == i:
                slot = -1                      # dead at birth: never stored
            else:
                slot = alloc(pending)
                slot_of[key] = slot
            buf = None
            if t in analysis.prealloc and p != FULL:
                ref = graph.tensors[t]
                bkey = (t, BUF)
                if bkey not in slot_of:
                    bslot = alloc(pending)
                    slot_of[bkey] = bslot
                    buf = (bslot, None,
                           _pad_cfg(ref, offsets[p], plan.split_sizes[p]),
                           ref.batch_dim)
                    pad_inits += 1
                else:
                    buf = (slot_of[bkey], _start(ref, offsets[p]), None,
                           ref.batch_dim)
            writes.append((slot, buf))

        frees = tuple(pending)
        free.extend(pending)

        if step.kind == "fused":
            fseen, fpairs = set(), []
            for h in step.handles:
                for pp in graph.nodes[h.oid].param_paths:
                    if pp not in fseen:
                        fseen.add(pp)
                        fpairs.append((pp, ix_of(pp)))
            instrs.append(Instr(
                fn=step.replace_fn, reads=tuple(reads), writes=tuple(writes),
                frees=frees, fused=True, fused_pairs=tuple(fpairs),
                step=step,
                ext_inputs=tuple((t, p) for (t, p, m, k) in analysis.reads[i]),
                ext_outputs=tuple(analysis.writes[i]),
                label=f"fused kernel {step.replace_name}"))
        else:
            node = graph.nodes[step.handles[0].oid]
            param_ix, member_pairs = -1, None
            if node.param_paths:
                if node.members:
                    member_pairs = tuple((pp, ix_of(pp))
                                         for pp in node.param_paths)
                else:
                    param_ix = ix_of(node.param_paths[0])
            instrs.append(Instr(
                fn=node.fn, reads=tuple(reads), writes=tuple(writes),
                frees=frees, param_ix=param_ix, member_pairs=member_pairs,
                label=f"op {node.name}"))

    output_slots = []
    for (t, _p, mode, key), name in zip(analysis.reads[-1],
                                       graph.outputs.keys()):
        output_slots.append((name, slot_for_read(t, FULL, mode, key,
                                                 len(plan.steps))))

    n_keys = len(analysis.death) + len(graph.inputs)
    return LoweredPlan(
        graph=graph, split_sizes=plan.split_sizes, instrs=tuple(instrs),
        input_slots=tuple(input_slots), output_slots=tuple(output_slots),
        param_paths=tuple(path_ix), n_slots=n_slots, fingerprint=plan_fp,
        analysis=analysis, capture=capture,
        struct_key=structural_key(graph, plan),
        stats={"n_slots": n_slots, "n_env_keys": n_keys,
               "slots_reused": reused, "pad_inits": pad_inits,
               "n_instrs": len(instrs)})


def specialize(canonical: LoweredPlan, graph: OpGraph, plan: ExecutionPlan,
               capture: Optional[bool] = None,
               struct_key: Optional[tuple] = None) -> LoweredPlan:
    """Re-derive a canonical lowering for a new shape bucket.

    A prefill bucket re-traces the same layer program at a different
    sequence length, and a decode batch tier at a different *batch* size:
    either way the (graph, plan) pair is *structurally* identical to an
    already-lowered one — same nodes, same step stream, same slots and
    death sites — and only the shape-dependent pieces differ: slice
    ``(axis, offset, size)`` triples (micro-batch offsets/sizes re-read
    from the new plan's ``split_sizes``), merge-buffer extents (from the
    new graph's tensor shapes, batch dim included), and the op callables
    (closures re-traced with the new shapes).  ``specialize`` rewrites
    exactly those from ``canonical``, skipping static analysis and slot
    allocation; everything liveness-derived (slots, frees, param
    interning, input/output slot maps) is reused verbatim.  A tier whose
    scheduler asks for a different micro-batch *count* changes the
    structural key and must be lowered as its own canonical.

    ``capture`` (default: the canonical's) sets the new plan's flag.
    Raises ``LoweringError`` when the structural keys disagree.
    ``struct_key``, when given, must be ``structural_key(graph, plan)``
    already computed by the caller.
    """
    skey = struct_key or structural_key(graph, plan)
    if canonical.struct_key != skey:
        import hashlib

        def _digest(k):
            return hashlib.sha256(repr(k).encode()).hexdigest()[:16]
        raise LoweringError(
            f"cannot specialize: canonical lowering has structure "
            f"{_digest(canonical.struct_key)}, new (graph, plan) has "
            f"{_digest(skey)}")
    plan_fp = plan.fingerprint()
    ana = canonical.analysis
    sizes = plan.split_sizes
    tensors = graph.tensors
    nodes = graph.nodes

    offsets = []
    acc = 0
    for s in sizes:
        offsets.append(acc)
        acc += s

    # which instrs carry shape-dependent reads/writes — and the op id each
    # non-fused instr rebinds to — is itself structural: computed once
    # per canonical, not once per bucket
    recipe = canonical._spec_cache.get("recipe")
    if recipe is None:
        recipe = tuple(
            (any(sl is not None for _, sl in ins.reads),
             any(b is not None for _, b in ins.writes),
             -1 if ins.fused else step.handles[0].oid)
            for ins, step in zip(canonical.instrs, plan.steps))
        canonical._spec_cache["recipe"] = recipe

    copy_ = copy.copy
    instrs = []
    for i, ins in enumerate(canonical.instrs):
        dyn_r, dyn_w, oid = recipe[i]
        new = copy_(ins)
        if oid < 0:                       # fused: rebind kernel + step
            step = plan.steps[i]
            new.fn = step.replace_fn
            new.step = step
        else:
            new.fn = nodes[oid].fn
        if dyn_r:
            rr = []
            for (slot, sl), (t, p, _m, _k) in zip(ins.reads, ana.reads[i]):
                if sl is not None:
                    sl = (tensors[t].batch_dim, offsets[p], sizes[p])
                rr.append((slot, sl))
            new.reads = tuple(rr)
        if dyn_w:
            ww = []
            for (slot, buf), (t, p) in zip(ins.writes, ana.writes[i]):
                if buf is not None:
                    bslot, _, pad_cfg, _ = buf
                    ref = tensors[t]
                    if pad_cfg is not None:   # first producer: creates
                        buf = (bslot, None, _pad_cfg(ref, offsets[p],
                                                     sizes[p]),
                               ref.batch_dim)
                    else:
                        buf = (bslot, _start(ref, offsets[p]), None,
                               ref.batch_dim)
                ww.append((slot, buf))
            new.writes = tuple(ww)
        instrs.append(new)

    analysis = dataclasses.replace(
        ana, plan_fingerprint=plan_fp,
        buffer_bytes=sum(tensors[t].nbytes for t in ana.prealloc))
    return LoweredPlan(
        graph=graph, split_sizes=sizes, instrs=tuple(instrs),
        input_slots=canonical.input_slots,
        output_slots=canonical.output_slots,
        param_paths=canonical.param_paths, n_slots=canonical.n_slots,
        fingerprint=plan_fp, analysis=analysis,
        capture=canonical.capture if capture is None else capture,
        struct_key=skey,
        stats={**canonical.stats,
               "specialized_from": canonical.fingerprint})
