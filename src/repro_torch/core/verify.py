"""Lowered-IR memory safety — the semantic check behind a restored plan.

A persisted ``plan_serde`` artifact whose checksum and fingerprint both
pass can still carry a stale or tampered instruction stream.
:func:`verify_lowered` symbolically replays a ``LoweredPlan``'s slot
machine against the plan's Alg.-1 analysis and reports every problem it
finds as a typed :class:`Diagnostic`: use-after-death under
liveness-driven slot reuse, writes that clobber live values, premature
frees, and prealloc merge-buffer hazards (a part written twice, the
buffer re-created after parts landed, or assembled before every part is
written).  ``PlanStore`` runs it on every rehydrated plan
(``core/plan_store.py:_verify_restored_plan``).

This is the second layer of the JAX package's ``core/verify.py``; the
plan-level data-flow checks (``verify_plan``), the schedule linter
(``lint_plan``) and ``verify`` / ``enforce`` are not ported yet
(ROADMAP queue 1 item 8).  Diagnostic codes are the JAX package's.
"""
from __future__ import annotations

import dataclasses

from .analysis import BUF
from .graph import FULL, OpGraph
from .plan import OpHandle

ERROR = "error"
WARNING = "warning"

#: code -> (severity, one-line description), for the codes this layer
#: emits.  Stable: tests key on them.
CODES = {
    "VFY101": (ERROR, "slot read invalid / use-after-death"),
    "VFY102": (ERROR, "write clobbers a live slot (donation aliasing)"),
    "VFY103": (ERROR, "prealloc merge-buffer hazard"),
    "VFY104": (ERROR, "premature free: slot has reads owed"),
    "VFY105": (ERROR, "lowered plan / analysis metadata inconsistent"),
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


def _fmt_key(graph: OpGraph, key) -> str:
    t, p = key
    name = graph.tensors[t].name if t in graph.tensors else "?"
    part = "buf" if p == BUF else ("FULL" if p == FULL else f"mb{p}")
    return f"t{t}({name})/{part}"


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
