"""Plan verifier and schedule linter — typed diagnostics over plans and
their slot IR.

Programmable scheduling hands users the rope to hang themselves: a buggy
``schedule()`` can record a plan that reads a value before it is
written, runs an op twice or never, or fuses a non-convex group, and a
mutated or stale lowered plan can run with aliased slots.  This module
checks a ``(graph, ExecutionPlan)`` pair and (optionally) its lowered
instruction IR and reports every problem it finds as a typed,
provenance-carrying :class:`Diagnostic` instead of crashing on the
first.  Three layers, as in the JAX package's ``core/verify.py``:

  1. **plan-level data-flow** (:func:`verify_plan`) — read-before-write,
     double or missing execution per micro-batch, merged-step coverage
     and merged-read feasibility, fused-group convexity, dead ops.  Read
     resolution reuses :func:`~repro_torch.core.analysis.resolve_read`,
     the rule the interpreter, Alg.-1 analysis and lowering use, so the
     verifier and the runtime cannot disagree about a read.
  2. **lowered-IR memory safety** (:func:`verify_lowered`) — a symbolic
     replay of the slot machine against the plan's Alg.-1 analysis:
     use-after-death under liveness-driven slot reuse, writes that
     clobber live values, premature frees, and prealloc merge-buffer
     hazards (a part written twice, the buffer re-created after parts
     landed, or assembled before every part is written).  ``PlanStore``
     runs it on every rehydrated plan
     (``core/plan_store.py:_verify_restored_plan``): a persisted artifact
     whose checksum and fingerprint both pass can still carry a stale or
     tampered instruction stream.
  3. **lint-severity warnings** (:func:`lint_plan`) — scheduling smells
     that run correctly but leave performance behind: two collectives in
     one overlap window (they serialize on the interconnect), an exposed
     collective with independent work available later, and degenerate
     split sizes.

``verify`` runs the layers, ``enforce`` applies a ``verify=`` mode
(``build_forward``, ``record_plan``, ``api.compile``) and ``lint_table``
renders the ``python -m repro_torch.lint`` table.  Diagnostic codes are
the JAX package's and stable (tests key on them); see ``CODES``.
Severity ``"error"`` means the plan would crash or compute the wrong
value; ``"warning"`` means it runs but smells.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

from .analysis import BUF, resolve_read, step_reads, step_writes
from .graph import FULL, VBATCH, OpGraph
from .plan import ExecutionPlan, OpHandle, graph_fingerprint

ERROR = "error"
WARNING = "warning"

#: code -> (severity, one-line description).  Stable: tests and the lint
#: CLI key on these.
CODES = {
    "VFY001": (ERROR, "unknown op / graph mismatch"),
    "VFY002": (ERROR, "invalid split sizes"),
    "VFY003": (ERROR, "read-before-write (operand unavailable)"),
    "VFY004": (ERROR, "op executed more than once per micro-batch"),
    "VFY005": (ERROR, "op never executed for some micro-batch"),
    "VFY006": (ERROR, "merged step does not cover all micro-batches"),
    "VFY007": (ERROR, "merged read infeasible (no sliceable batch dim)"),
    "VFY008": (ERROR, "fused group not dependency-closed (non-convex)"),
    "VFY009": (WARNING, "dead op: outputs never consumed"),
    "VFY101": (ERROR, "slot read invalid / use-after-death"),
    "VFY102": (ERROR, "write clobbers a live slot (donation aliasing)"),
    "VFY103": (ERROR, "prealloc merge-buffer hazard"),
    "VFY104": (ERROR, "premature free: slot has reads owed"),
    "VFY105": (ERROR, "lowered plan / analysis metadata inconsistent"),
    "VFY201": (WARNING, "resource oversubscription in overlap window"),
    "VFY202": (WARNING, "missed overlap: exposed collective"),
    "VFY203": (WARNING, "degenerate split sizes"),
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding.  ``step_index`` is the plan step (or instruction)
    the finding anchors to, ``-1`` for plan-wide findings and
    ``n_steps`` for the virtual final-output step; ``op_handles`` carry
    the provenance (op names + micro-batch) of the involved ops."""

    severity: str
    code: str
    step_index: int
    op_handles: tuple
    message: str
    fix_hint: str = ""

    @property
    def ops(self) -> str:
        """Compact ``name[mb]`` provenance string."""
        return ", ".join(
            h.name if h.mb == FULL else f"{h.name}[mb={h.mb}]"
            for h in self.op_handles)

    def __str__(self):
        where = "plan" if self.step_index < 0 else f"step {self.step_index}"
        ops = f" ({self.ops})" if self.op_handles else ""
        hint = f"  hint: {self.fix_hint}" if self.fix_hint else ""
        return (f"[{self.severity.upper()} {self.code}] {where}{ops}: "
                f"{self.message}{hint}")


@dataclasses.dataclass(frozen=True)
class VerifyReport:
    """All diagnostics of one verification pass, queryable by severity."""

    diagnostics: tuple = ()

    @property
    def errors(self) -> tuple:
        return tuple(d for d in self.diagnostics if d.severity == ERROR)

    @property
    def warnings(self) -> tuple:
        return tuple(d for d in self.diagnostics if d.severity == WARNING)

    @property
    def ok(self) -> bool:
        """True when no *error*-severity diagnostics exist (warnings are
        advisory and never fail a verification)."""
        return not self.errors

    def raise_if_errors(self, what: str = "plan"):
        if self.errors:
            raise PlanVerificationError(self, what=what)

    def merged(self, other: "VerifyReport") -> "VerifyReport":
        return VerifyReport(self.diagnostics + other.diagnostics)

    def pretty(self) -> str:
        """Human-readable table, one diagnostic per line."""
        if not self.diagnostics:
            return "verification clean: no diagnostics"
        lines = [f"{len(self.errors)} error(s), "
                 f"{len(self.warnings)} warning(s):"]
        lines.extend(f"  {d}" for d in self.diagnostics)
        return "\n".join(lines)


class PlanVerificationError(RuntimeError):
    """Raised under ``verify="strict"`` when a plan carries error-severity
    diagnostics; ``.report`` holds the full :class:`VerifyReport`."""

    def __init__(self, report: VerifyReport, what: str = "plan"):
        self.report = report
        super().__init__(
            f"{what} failed verification with {len(report.errors)} "
            f"error(s):\n{report.pretty()}")


def format_missing(missing: Sequence[tuple], cap: int = 8) -> str:
    """Render ``[(op_name, missing_parts), ...]`` with the full count and
    an explicit overflow marker — the incomplete-schedule report format
    shared by ``SchedCtx.finalize`` and the VFY005 diagnostics."""
    def one(name, parts):
        ps = sorted(parts, key=lambda p: (p == FULL, p))
        if ps == [FULL]:
            return name
        return f"{name}[mb={','.join(str(p) for p in ps)}]"
    shown = ", ".join(one(n, p) for n, p in missing[:cap])
    more = len(missing) - cap
    if more > 0:
        shown += f" … and {more} more"
    return f"{len(missing)} op(s) missing: {shown}"


def _fmt_key(graph: OpGraph, key) -> str:
    t, p = key
    name = graph.tensors[t].name if t in graph.tensors else "?"
    part = "buf" if p == BUF else ("FULL" if p == FULL else f"mb{p}")
    return f"t{t}({name})/{part}"


# ---------------------------------------------------------------------------
# layer 1: plan-level data-flow
# ---------------------------------------------------------------------------


def verify_plan(graph: OpGraph, plan: ExecutionPlan) -> list:
    """Simulate the plan against the graph, collecting every data-flow
    violation.  A failing step is assumed to have executed anyway so one
    root cause does not cascade into dozens of downstream findings."""
    diags = []
    if plan.graph_fingerprint:
        gfp = graph_fingerprint(graph)
        if plan.graph_fingerprint != gfp:
            diags.append(Diagnostic(
                ERROR, "VFY001", -1, (),
                f"plan was recorded for graph {plan.graph_fingerprint}, "
                f"verifying against graph {gfp}",
                "re-record the plan against this graph"))
    sizes = tuple(plan.split_sizes)
    nparts = len(sizes)
    if any(s <= 0 for s in sizes):
        diags.append(Diagnostic(
            ERROR, "VFY002", -1, (),
            f"split sizes must be positive, got {sizes}",
            "fix the ctx.split() sizes"))
    parts = list(range(nparts)) if nparts else [FULL]
    first_part = 0 if nparts else FULL
    producer = {}
    for oid, n in graph.nodes.items():
        for t in n.outputs:
            producer[t] = oid
    out_tids = set(graph.outputs.values())

    avail: dict = {t: {FULL} for t in graph.inputs.values()}
    done: dict = {}
    for i, step in enumerate(plan.steps):
        known = []
        for h in step.handles:
            if h.oid in graph.nodes:
                known.append(h)
            else:
                diags.append(Diagnostic(
                    ERROR, "VFY001", i, (h,),
                    f"references op {h.name or h.oid!r} (oid {h.oid}) "
                    "which is not in the graph",
                    "the plan belongs to a different graph"))
        if not known:
            continue
        if step.kind == "merged":
            diags.extend(_check_merged(graph, step, known, nparts, i))
        elif step.kind == "fused":
            diags.extend(_check_fused(graph, step, known, producer, i))
        # double execution (same bookkeeping as SchedCtx._record)
        exec_handles = known[:1] if step.kind == "merged" else known
        for h in exec_handles:
            d = done.setdefault(h.oid, set())
            newparts = set(parts) if step.kind == "merged" else {h.mb}
            dup = d & newparts
            if dup:
                diags.append(Diagnostic(
                    ERROR, "VFY004", i, (h,),
                    f"op {h.name!r} executed again (micro-batch(es) "
                    f"{sorted(dup, key=repr)} already done)",
                    "each op runs exactly once per micro-batch"))
            d |= newparts
        # reads through the runtime's own resolution rules
        for (t, p) in step_reads(graph, step, nparts):
            if t not in graph.tensors:
                diags.append(Diagnostic(
                    ERROR, "VFY001", i, tuple(known),
                    f"reads tensor {t} which is not in the graph"))
                continue
            ref = graph.tensors[t]
            a = avail.get(t, set())
            try:
                resolve_read(a, ref, p, nparts)
            except KeyError as e:
                infeasible = (
                    (p != FULL and FULL in a and ref.batch_dim == VBATCH)
                    or (p == FULL and nparts and a >= set(range(nparts))
                        and ref.batch_dim in (None, VBATCH)))
                if infeasible:
                    diags.append(Diagnostic(
                        ERROR, "VFY007", i, tuple(known),
                        str(e).strip("'\""),
                        "merge/split only tensors with a real batch dim"))
                else:
                    diags.append(Diagnostic(
                        ERROR, "VFY003", i, tuple(known),
                        str(e).strip("'\""),
                        "schedule the producer (for every micro-batch) "
                        "before this step"))
        for (t, p) in step_writes(graph, step, nparts):
            avail.setdefault(t, set()).add(p)

    # completeness — the finalize() contract, reported per op
    for oid in graph.topo_order():
        need = set(parts) if graph.splittable(oid) else {first_part}
        d = done.get(oid, set())
        if not (need <= d or FULL in d):
            name = graph.nodes[oid].name
            lack = need - d
            diags.append(Diagnostic(
                ERROR, "VFY005", -1,
                tuple(OpHandle(oid, p, name)
                      for p in sorted(lack, key=repr)),
                format_missing([(name, lack)]),
                "execute every op for every micro-batch (or merged)"))

    # the virtual final step: every graph output is consumed at FULL
    for name, t in graph.outputs.items():
        if t not in graph.tensors:
            continue
        ref = graph.tensors[t]
        a = avail.get(t, set())
        try:
            resolve_read(a, ref, FULL, nparts)
        except KeyError as e:
            infeasible = (nparts and a >= set(range(nparts))
                          and ref.batch_dim in (None, VBATCH))
            diags.append(Diagnostic(
                ERROR, "VFY007" if infeasible else "VFY003",
                len(plan.steps), (),
                f"graph output {name!r}: {str(e).strip(chr(39))}",
                "the output's producer must run (for every micro-batch)"))

    # dead ops: outputs feed neither another op nor a graph output
    for oid, n in graph.nodes.items():
        if n.outputs and all(not graph.consumers.get(t)
                             and t not in out_tids for t in n.outputs):
            diags.append(Diagnostic(
                WARNING, "VFY009", -1, (OpHandle(oid, FULL, n.name),),
                f"op {n.name!r} outputs are never consumed",
                "drop the op from the graph or consume its outputs"))
    return diags


def _check_merged(graph, step, known, nparts, i):
    oids = {h.oid for h in known}
    if len(oids) > 1:
        return [Diagnostic(
            ERROR, "VFY006", i, tuple(known),
            f"merged step mixes {len(oids)} different ops "
            f"({', '.join(sorted(graph.nodes[o].name for o in oids))})",
            "a merged step is one op across all micro-batches")]
    mbs = sorted(h.mb for h in known)
    if mbs != list(range(nparts)) or not nparts:
        return [Diagnostic(
            ERROR, "VFY006", i, tuple(known),
            f"merged execution of {known[0].name!r} covers micro-batches "
            f"{mbs}, plan has {nparts} micro-batch(es)",
            "pass the op's handle for every micro-batch")]
    return []


def _check_fused(graph, step, known, producer, i):
    """Fused-group convexity: an external input produced *downstream* of
    the group's own outputs means some excluded op must run both before
    and after the (atomic) kernel — impossible.  The kernel body itself
    is unverifiable (arbitrary user code); convexity is what static
    analysis can promise."""
    group = {h.oid for h in known}
    group_out = {t for h in known for t in graph.nodes[h.oid].outputs}
    ext_in = {t for h in known for t in graph.nodes[h.oid].inputs} \
        - group_out
    # ops reachable downstream of the group's outputs, excluding members
    reach = set()
    frontier = [c for t in group_out
                for c in graph.consumers.get(t, ()) if c not in group]
    while frontier:
        oid = frontier.pop()
        if oid in reach:
            continue
        reach.add(oid)
        for t in graph.nodes[oid].outputs:
            frontier.extend(c for c in graph.consumers.get(t, ())
                            if c not in reach and c not in group)
    bad = sorted(t for t in ext_in if producer.get(t) in reach)
    if bad:
        names = ", ".join(
            f"t{t}({graph.tensors[t].name})" for t in bad)
        return [Diagnostic(
            ERROR, "VFY008", i, tuple(known),
            f"fused group {step.replace_name!r} is not dependency-closed: "
            f"external input(s) {names} are produced downstream of the "
            "group's own outputs",
            "include the intermediate op in the group or split the "
            "kernel")]
    return []


# ---------------------------------------------------------------------------
# layer 2: lowered-IR memory safety
# ---------------------------------------------------------------------------


def verify_lowered(lowered) -> list:
    """Symbolically replay a ``LoweredPlan``'s slot machine against its
    Alg.-1 analysis: every read must find the key the analysis says it
    needs, every write must not clobber a live value, every free must
    not owe future reads, and prealloc merge buffers must be created
    once, written once per part, and assembled only complete.  Works on
    freshly lowered, specialized and rehydrated plans alike."""
    diags = []
    ana = lowered.analysis
    graph = lowered.graph
    n = len(lowered.instrs)
    n_slots = lowered.n_slots
    nmb = len(lowered.split_sizes)

    def meta(i, msg):
        diags.append(Diagnostic(
            ERROR, "VFY105", i, _instr_handles(lowered, i), msg,
            "re-lower the plan; the artifact is stale or corrupt"))

    if ana.n_steps != n or len(ana.writes) != n \
            or len(ana.reads) != n + 1:
        meta(-1, f"lowered plan has {n} instrs; analysis covers "
                 f"{ana.n_steps} steps ({len(ana.reads)} read rows, "
                 f"{len(ana.writes)} write rows)")
        return diags

    contents: dict = {}                # slot -> env key currently held
    for name, slot in lowered.input_slots:
        t = graph.inputs.get(name)
        if t is None or not _slot_ok(slot, n_slots):
            meta(-1, f"input slot map entry ({name!r}, {slot}) is invalid")
            continue
        contents[slot] = (t, FULL)
    death = ana.death
    buf_parts: dict = {}               # tid -> set of parts written
    buf_created: set = set()           # tids whose merge buffer exists

    for i, ins in enumerate(lowered.instrs):
        handles = _instr_handles(lowered, i)
        rs, ws = ana.reads[i], ana.writes[i]
        if len(ins.reads) != len(rs) or len(ins.writes) != len(ws):
            meta(i, f"{ins.label or 'instr'}: {len(ins.reads)} reads / "
                    f"{len(ins.writes)} writes vs analysis "
                    f"{len(rs)} / {len(ws)}")
            continue
        for (slot, sl), r in zip(ins.reads, rs):
            t, p, mode, key = r
            expect = ((t, key) if mode == "direct"
                      else (t, BUF) if mode == "assemble" else (t, FULL))
            if (mode == "slice") != (sl is not None):
                meta(i, f"{ins.label}: read of {_fmt_key(graph, (t, p))} "
                        f"slice spec disagrees with mode {mode!r}")
            if not _slot_ok(slot, n_slots):
                diags.append(Diagnostic(
                    ERROR, "VFY101", i, handles,
                    f"{ins.label} reads invalid slot {slot!r} "
                    f"(plan has {n_slots} slots)"))
                continue
            got = contents.get(slot)
            if got != expect:
                if got is None:
                    msg = (f"{ins.label} reads slot {slot} expecting "
                           f"{_fmt_key(graph, expect)}, but the slot is "
                           "dead (freed or never written) — "
                           "use-after-death")
                else:
                    msg = (f"{ins.label} reads slot {slot} expecting "
                           f"{_fmt_key(graph, expect)}, but it holds "
                           f"{_fmt_key(graph, got)}")
                diags.append(Diagnostic(
                    ERROR, "VFY101", i, handles, msg,
                    "the instruction stream disagrees with liveness; "
                    "re-lower the plan"))
            if mode == "assemble":
                have = buf_parts.get(t, set())
                if nmb and len(have) < nmb:
                    diags.append(Diagnostic(
                        ERROR, "VFY103", i, handles,
                        f"{ins.label} assembles merge buffer of "
                        f"{_fmt_key(graph, (t, FULL))} with only "
                        f"{sorted(have)} of {nmb} part(s) written",
                        "every producer part must run before the "
                        "merged read"))
        for (slot, buf), w in zip(ins.writes, ws):
            t, p = w
            key = (t, p)
            if slot == -1:
                if death.get(key, i) != i:
                    diags.append(Diagnostic(
                        ERROR, "VFY101", i, handles,
                        f"{ins.label} drops {_fmt_key(graph, key)} "
                        f"(slot -1) but it is read again at step "
                        f"{death[key]}"))
            elif not _slot_ok(slot, n_slots):
                diags.append(Diagnostic(
                    ERROR, "VFY101", i, handles,
                    f"{ins.label} writes invalid slot {slot!r}"))
            else:
                got = contents.get(slot)
                if got is not None and got != key \
                        and death.get(got, -1) > i:
                    diags.append(Diagnostic(
                        ERROR, "VFY102", i, handles,
                        f"{ins.label} writes {_fmt_key(graph, key)} into "
                        f"slot {slot}, clobbering live "
                        f"{_fmt_key(graph, got)} (still read at step "
                        f"{death[got]}) — aliasing hazard",
                        "slot reuse must wait for the holder's death "
                        "site"))
                contents[slot] = key
            in_prealloc = t in ana.prealloc and p != FULL
            if in_prealloc and buf is None:
                diags.append(Diagnostic(
                    ERROR, "VFY103", i, handles,
                    f"{ins.label} produces part {p} of merge tensor "
                    f"t{t}({graph.tensors[t].name}) but never writes "
                    "the prealloc buffer",
                    "the merged consumer would read a hole"))
            if buf is not None:
                if not in_prealloc:
                    meta(i, f"{ins.label}: buffer write for "
                            f"{_fmt_key(graph, key)} which the analysis "
                            "does not prealloc")
                    continue
                bslot, _start, pad_cfg, _axis = buf
                if pad_cfg is not None:
                    if t in buf_created:
                        diags.append(Diagnostic(
                            ERROR, "VFY103", i, handles,
                            f"{ins.label} re-creates the merge buffer of "
                            f"t{t}({graph.tensors[t].name}), discarding "
                            f"part(s) {sorted(buf_parts.get(t, ()))} "
                            "already written"))
                    buf_created.add(t)
                elif t not in buf_created:
                    diags.append(Diagnostic(
                        ERROR, "VFY103", i, handles,
                        f"{ins.label} updates the merge buffer of "
                        f"t{t}({graph.tensors[t].name}) before any "
                        "producer created it"))
                seen = buf_parts.setdefault(t, set())
                if p in seen:
                    diags.append(Diagnostic(
                        ERROR, "VFY103", i, handles,
                        f"{ins.label} writes part {p} of merge tensor "
                        f"t{t}({graph.tensors[t].name}) twice"))
                seen.add(p)
                if _slot_ok(bslot, n_slots):
                    got = contents.get(bslot)
                    if got is not None and got != (t, BUF) \
                            and death.get(got, -1) > i:
                        diags.append(Diagnostic(
                            ERROR, "VFY102", i, handles,
                            f"{ins.label} merge-buffer write into slot "
                            f"{bslot} clobbers live "
                            f"{_fmt_key(graph, got)}"))
                    contents[bslot] = (t, BUF)
                else:
                    meta(i, f"{ins.label}: invalid merge-buffer slot "
                            f"{bslot!r}")
        for s in ins.frees:
            if not _slot_ok(s, n_slots):
                meta(i, f"{ins.label}: frees invalid slot {s!r}")
                continue
            got = contents.get(s)
            if got is not None and death.get(got, -1) > i:
                diags.append(Diagnostic(
                    ERROR, "VFY104", i, handles,
                    f"{ins.label} frees slot {s} holding "
                    f"{_fmt_key(graph, got)}, which is still read at "
                    f"step {death[got]} — premature free",
                    "frees belong at the key's death site"))
            contents.pop(s, None)

    # the virtual final step: graph outputs must sit in their slots
    for (name, slot), r in zip(lowered.output_slots, ana.reads[-1]):
        t, _p, mode, key = r
        expect = ((t, key) if mode == "direct"
                  else (t, BUF) if mode == "assemble" else (t, FULL))
        if not _slot_ok(slot, n_slots):
            meta(n, f"output slot map entry ({name!r}, {slot}) is invalid")
            continue
        got = contents.get(slot)
        if got != expect:
            diags.append(Diagnostic(
                ERROR, "VFY101", n, (),
                f"graph output {name!r} reads slot {slot} expecting "
                f"{_fmt_key(graph, expect)}, but it holds "
                + ("nothing (dead slot)" if got is None
                   else _fmt_key(graph, got))))
    return diags


def _slot_ok(slot, n_slots) -> bool:
    return isinstance(slot, int) and 0 <= slot < n_slots


def _instr_handles(lowered, i) -> tuple:
    if not (0 <= i < len(lowered.instrs)):
        return ()
    ins = lowered.instrs[i]
    step = getattr(ins, "step", None)
    if step is not None and getattr(step, "handles", None):
        return tuple(step.handles)
    label = getattr(ins, "label", "") or f"instr {i}"
    return (OpHandle(-1, FULL, label),)


# ---------------------------------------------------------------------------
# layer 3: lint-severity schedule smells
# ---------------------------------------------------------------------------


def lint_plan(graph: OpGraph, plan: ExecutionPlan) -> list:
    """Warnings only: the plan is correct but leaves overlap on the
    table.  A collective overlaps the following transitively independent
    steps until its first consumer (the JAX package's overlap model)."""
    diags = []
    sizes = tuple(plan.split_sizes)
    if len(sizes) >= 2 and max(sizes) / max(sum(sizes), 1) >= 0.9:
        diags.append(Diagnostic(
            WARNING, "VFY203", -1, (),
            f"split sizes {sizes} put "
            f"{100 * max(sizes) // sum(sizes)}% of the batch in one "
            "micro-batch; overlap cannot pay",
            "balance the ctx.split() sizes"))
    nparts = len(sizes)
    steps = plan.steps
    reads = [set(t for t, _ in step_reads(graph, s, nparts))
             if all(h.oid in graph.nodes for h in s.handles) else set()
             for s in steps]
    writes = [set(t for t, _ in step_writes(graph, s, nparts))
              if all(h.oid in graph.nodes for h in s.handles) else set()
              for s in steps]
    res = [_step_resource(graph, s) for s in steps]
    for i, step in enumerate(steps):
        if res[i] != "network":
            continue
        tainted = set(writes[i])
        window, contended, exposed_alt = [], [], None
        for j in range(i + 1, len(steps)):
            if reads[j] & tainted:
                tainted |= writes[j]
                if j == i + 1 and exposed_alt is None:
                    # first consumer is immediate: collective exposed
                    exposed_alt = False
                continue
            if not window and j > i + 1 and exposed_alt is False:
                exposed_alt = steps[j]
            window.append(j)
            if res[j] == "network":
                contended.append(j)
            tainted |= writes[j] & tainted  # independent: taint unchanged
        if contended:
            other = steps[contended[0]]
            diags.append(Diagnostic(
                WARNING, "VFY201", i, tuple(step.handles),
                f"collective {step.handles[0].name!r} overlaps "
                f"collective {other.handles[0].name!r} (step "
                f"{contended[0]}) on the same interconnect — they "
                "serialize",
                "interleave compute between the two collectives"))
        if exposed_alt not in (None, False):
            diags.append(Diagnostic(
                WARNING, "VFY202", i, tuple(step.handles),
                f"collective {step.handles[0].name!r} is immediately "
                f"followed by its consumer while independent work "
                f"({exposed_alt.handles[0].name!r}) is available later "
                "in the plan",
                "reorder the independent step into the overlap window"))
    return diags


def _step_resource(graph, step) -> str:
    rs = {graph.nodes[h.oid].resource for h in step.handles
          if h.oid in graph.nodes}
    if "network" in rs:
        return "network"
    return next(iter(rs), "compute")


# ---------------------------------------------------------------------------
# umbrella
# ---------------------------------------------------------------------------


def verify(graph: OpGraph, plan: ExecutionPlan, lowered=None,
           lint: bool = False, mode: str = "report") -> VerifyReport:
    """Run every applicable layer and return one :class:`VerifyReport`.

    ``lowered`` adds the IR memory-safety layer, ``lint=True`` adds the
    warning-severity smells.  ``mode="strict"`` raises
    :class:`PlanVerificationError` when error diagnostics exist;
    ``"report"`` (default) always returns."""
    diags = list(verify_plan(graph, plan))
    if lowered is not None:
        diags.extend(verify_lowered(lowered))
    if lint:
        diags.extend(lint_plan(graph, plan))
    report = VerifyReport(tuple(diags))
    if mode == "strict":
        report.raise_if_errors()
    return report


def enforce(report: VerifyReport, mode: str, what: str = "plan"):
    """Apply a ``verify=`` mode to a report: ``"strict"`` raises on
    errors, ``"warn"`` emits a Python warning, ``"off"``/``"report"`` do
    nothing.  Warnings-severity diagnostics never raise or warn."""
    if mode not in ("off", "report", "warn", "strict"):
        raise ValueError(
            f"unknown verify mode {mode!r}; use 'off', 'warn' or 'strict'")
    if report.ok or mode in ("off", "report"):
        return
    if mode == "strict":
        report.raise_if_errors(what=what)
    else:
        import warnings
        warnings.warn(
            f"{what} failed verification with {len(report.errors)} "
            f"error(s); first: {report.errors[0]}",
            RuntimeWarning, stacklevel=3)


def lint_table(rows: Iterable[tuple], include_clean: bool = False) -> str:
    """Render ``(label, VerifyReport)`` rows as the CLI's diagnostic
    table."""
    out = []
    for label, report in rows:
        if not report.diagnostics and not include_clean:
            continue
        if not report.diagnostics:
            out.append(f"{label:<48} clean")
            continue
        for d in report.diagnostics:
            out.append(f"{label:<48} {d}")
    return "\n".join(out) if out else "all plans clean"


__all__ = [
    "CODES", "Diagnostic", "VerifyReport", "PlanVerificationError",
    "verify", "verify_plan", "verify_lowered", "lint_plan", "enforce",
    "format_missing", "lint_table",
]
