"""Per-resource CUDA streams — the GPU form of the plan's schedule knob.

In the JAX package the plan order is XLA's emission order, and the
strategies interleave the plan so that consecutive steps use different
``resource``s (compute / memory / network) and overlap.  On a GPU one
stream serialises every kernel, so the port gives each resource its own
stream and orders them only where the plan's data flow asks:

  * **compute** runs on the caller's current stream (stream 0), so a
    capture or a timing event around the call sees it as before;
    **memory** (stream 1) and **network** (stream 2) run on side
    streams, one fixed ``torch.cuda.Stream`` per device and index
    (:func:`side_stream`), created once, so a warm-up and the capture
    after it use the same handles (and the kernel workspaces cached per
    stream);
  * a fused step or a coalesced unit runs on its dominant resource's
    stream, by the rule partitioning uses
    (``core/partition.py:_dominant_resource``);
  * every read of a value produced on another stream waits for its
    producer's event: a ``slice`` read of a FULL value (a ``narrow``
    view), an ``assemble`` read of a merge buffer (every slice's
    producer), and a merge-buffer write by a later producer (the
    instruction that created the buffer).  A wait the stream's earlier
    waits already imply is dropped (vector clocks);
  * the side streams fork from the caller's stream when the call starts
    and join back before it returns: the caller's stream waits for the
    last instruction of every side stream, which covers the graph
    outputs.

Memory across streams: the caching allocator gives a freed block back to
the stream that allocated it at once, while a kernel on another stream
may still read it.  Without autograd, every value a side-stream
instruction reads or writes (its arguments, its outputs, the merge
buffers it writes) is **held** until the join, so no storage a side
stream touches is reused before the caller's stream has waited for it;
values only the caller's stream touches free at their death sites as
before.  Holding, not ``Tensor.record_stream``: under a CUDA Graph
capture PyTorch defers the reuse of any block with stream uses to the
capture's end, which across a layer stack's calls would keep every
cross-stream activation of the step in the graph pool.  When autograd
records the call (grad enabled and an input or a param requires grad),
saved tensors outlive the call and the backward runs each op on its
forward op's stream, so there every tensor an instruction touches gets
``record_stream`` of the instruction's stream instead: the allocator
then frees it only behind the last stream that used it, backward
included.

The stream program (:class:`StreamProgram`) is derived from the
structure alone — ``(graph, plan, analysis, instrs)`` — by ``lower``,
``specialize`` and ``plan_serde.rehydrate``, never stored: ``resource``
is part of the structural key, so every shape bucket of one structure
has the same program.  ``derive(..., assign=)`` and :func:`assigned`
take another stream assignment (a function from an instruction's index
to a stream index): the tests and ``chip_smoke.py`` use them for the
one-stream program and random assignments, which must give the same
bits.  No entry point of the package reaches them.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import torch

from .graph import FULL
from .partition import _dominant_resource

#: stream index of each resource; 0 is the caller's current stream
RESOURCE_STREAM = {"compute": 0, "memory": 1, "network": 2}


@dataclasses.dataclass(frozen=True)
class StreamProgram:
    """Where each instruction of a lowered plan runs and what it waits
    for.  ``deps[i]``: the instructions whose results instruction ``i``
    reads (or whose merge buffer it writes); ``waits[i]``: those of them
    on other streams that no earlier wait implies, each waited for
    through the event its instruction records (``events[j]``, an index
    into the call's events, -1 when nothing waits for ``j``); ``joins``:
    the instructions the caller's stream waits for before the call
    returns; ``held[i]``: keep what instruction ``i`` touches alive until
    the join; ``side``: the side stream indices the program uses."""

    streams: tuple
    deps: tuple
    waits: tuple
    events: tuple
    joins: tuple
    held: tuple
    side: tuple
    n_events: int

    def reassigned(self, assign: Callable[[int], int]) -> "StreamProgram":
        """The same data flow under another assignment (tests only)."""
        return schedule(self.deps,
                        tuple(int(assign(i)) for i in range(len(self.deps))))


def step_resource(graph, step) -> str:
    """A plan step's resource: its node's, or for a fused step the
    dominant one of its distinct nodes."""
    if step.kind != "fused":
        return graph.nodes[step.handles[0].oid].resource
    seen, members = set(), []
    for h in step.handles:
        if h.oid not in seen:
            seen.add(h.oid)
            members.append(graph.nodes[h.oid])
    return _dominant_resource(members)


def dependencies(analysis) -> tuple:
    """Per instruction, the earlier instructions it must run after: the
    producer of each value it reads (every slice's producer for an
    assembled merge buffer) and, for a merge-buffer write by a later
    producer, the instruction that created the buffer."""
    prod: dict = {}                    # env key -> producing instruction
    parts: dict = {}                   # tid -> merge-buffer writers
    out = []
    for i in range(analysis.n_steps):
        d = set()
        for (t, _p, mode, key) in analysis.reads[i]:
            if mode == "assemble":
                d.update(parts.get(t, ()))
                continue
            j = prod.get((t, key) if mode == "direct" else (t, FULL))
            if j is not None:
                d.add(j)
        for (t, p) in analysis.writes[i]:
            if t in analysis.prealloc and p != FULL:
                w = parts.setdefault(t, [])
                if w:
                    d.add(w[0])
                w.append(i)
            prod[(t, p)] = i
        out.append(tuple(sorted(d)))
    return tuple(out)


def schedule(deps: tuple, streams: tuple) -> StreamProgram:
    """The waits, events and joins of ``streams`` (one index per
    instruction) under ``deps``: each stream keeps a vector clock of the
    position it is known to follow on every stream, and a dependency it
    already follows costs no wait."""
    n = len(streams)
    pos = [0] * n
    clock: list = [None] * n
    count: dict = {}
    known: dict = {}
    waits = []
    for i in range(n):
        s = streams[i]
        k = known.setdefault(s, {})
        w = []
        # latest first: an earlier instruction never implies a later one
        for j in sorted(deps[i], reverse=True):
            t = streams[j]
            if t == s or k.get(t, -1) >= pos[j]:
                continue
            w.append(j)
            for u, q in clock[j].items():
                if k.get(u, -1) < q:
                    k[u] = q
        pos[i] = count.get(s, 0)
        count[s] = pos[i] + 1
        k[s] = pos[i]
        clock[i] = dict(k)
        waits.append(tuple(sorted(w)))
    last = {s: i for i, s in enumerate(streams)}
    k0 = known.setdefault(0, {})
    joins = []
    for s in sorted(last, key=lambda s: -last[s]):
        j = last[s]
        if s == 0 or k0.get(s, -1) >= pos[j]:
            continue
        joins.append(j)
        for u, q in clock[j].items():
            if k0.get(u, -1) < q:
                k0[u] = q
    recorded = sorted({j for w in waits for j in w} | set(joins))
    events = [-1] * n
    for e, j in enumerate(recorded):
        events[j] = e
    return StreamProgram(
        streams=tuple(streams), deps=tuple(deps), waits=tuple(waits),
        events=tuple(events), joins=tuple(sorted(joins)),
        held=tuple(s != 0 for s in streams),
        side=tuple(sorted(s for s in count if s != 0)),
        n_events=len(recorded))


def derive(graph, plan, analysis, instrs,
           assign: Optional[Callable[[int], int]] = None) -> StreamProgram:
    """The stream program of a lowered plan: each instruction on its
    step's resource stream, or on ``assign(i)`` (tests only)."""
    if len(instrs) != len(plan.steps):
        raise ValueError(f"{len(instrs)} instructions for "
                         f"{len(plan.steps)} plan steps")
    if assign is None:
        streams = tuple(RESOURCE_STREAM.get(step_resource(graph, s), 0)
                        for s in plan.steps)
    else:
        streams = tuple(int(assign(i)) for i in range(len(instrs)))
    return schedule(dependencies(analysis), streams)


# -- running on the card ------------------------------------------------------

_SIDE: dict = {}                       # (device index, stream index) -> stream
_ASSIGN: list = [None]                 # the test-only override, if any


def side_stream(device: torch.device, k: int) -> torch.cuda.Stream:
    """Side stream ``k`` of ``device``: one fixed object per process."""
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), k)
    s = _SIDE.get(key)
    if s is None:
        s = _SIDE[key] = torch.cuda.Stream(torch.device("cuda", key[0]))
    return s


def _zero(i: int) -> int:
    return 0


@contextlib.contextmanager
def assigned(assign: Callable[[int], int]):
    """Within the block, every lowered plan called on the card runs
    under ``assign`` instead of its resources' streams (tests and
    ``chip_smoke.py`` only: the one-stream program they compare with)."""
    prev = _ASSIGN[0]
    _ASSIGN[0] = assign
    try:
        yield
    finally:
        _ASSIGN[0] = prev


def one_stream():
    """:func:`assigned` with every instruction on the caller's stream."""
    return assigned(_zero)


def program_of(lowered) -> StreamProgram:
    """The program a call of ``lowered`` runs: its own, or its program
    under the :func:`assigned` override."""
    assign = _ASSIGN[0]
    if assign is None:
        return lowered.streams
    key = ("streams", assign)
    prog = lowered._spec_cache.get(key)
    if prog is None:
        prog = lowered._spec_cache[key] = lowered.streams.reassigned(assign)
    return prog


def _records(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.requires_grad
    if isinstance(x, dict):
        return any(_records(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return any(_records(v) for v in x)
    return False


def records_grad(lowered, pvals: list, env: list) -> bool:
    """True iff autograd records this call of ``lowered``: then what a
    side stream touches is marked with ``record_stream``, not held."""
    return torch.is_grad_enabled() and (
        _records(pvals) or _records([env[s] for _n, s in
                                     lowered.input_slots]))


def _record_stream(xs, stream):
    for x in xs:
        if isinstance(x, torch.Tensor):
            x.record_stream(stream)


def run(lowered, prog: StreamProgram, pvals: list, env: list,
        device: torch.device) -> dict:
    """Replay ``lowered`` on ``device`` under ``prog`` (see the module
    docstring); ``env`` holds the inputs in their slots."""
    cur = torch.cuda.current_stream(device)
    sides = {k: side_stream(device, k) for k in prog.side}
    if sides:
        fork = torch.cuda.Event()
        fork.record(cur)
        for s in sides.values():
            s.wait_event(fork)
    events = [torch.cuda.Event() for _ in range(prog.n_events)]
    grad = records_grad(lowered, pvals, env)
    held = []
    active = cur
    try:
        for i, ins in enumerate(lowered.instrs):
            k = prog.streams[i]
            st = cur if k == 0 else sides[k]
            if st is not active:
                torch.cuda.set_stream(st)
                active = st
            for j in prog.waits[i]:
                st.wait_event(events[prog.events[j]])
            args = lowered._args(ins, env)
            if grad and sides:
                _record_stream(args, st)
            outs = lowered._exec(ins, pvals, args)
            bufs = lowered._land(ins, env, outs)
            if grad and sides:
                _record_stream(bufs, st)
            elif prog.held[i]:
                held.append((args, outs, bufs))
            e = prog.events[i]
            if e >= 0:
                events[e].record(st)
            for s in ins.frees:
                env[s] = None
    finally:
        if active is not cur:
            torch.cuda.set_stream(cur)
    for j in prog.joins:
        cur.wait_event(events[prog.events[j]])
    out = {name: env[slot] for name, slot in lowered.output_slots}
    del held
    return out


__all__ = ["RESOURCE_STREAM", "StreamProgram", "assigned", "dependencies",
           "derive", "one_stream", "program_of", "records_grad", "run",
           "schedule", "side_stream", "step_resource"]
