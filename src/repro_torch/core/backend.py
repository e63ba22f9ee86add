"""Plan realization — paper Alg. 1 ``RuntimeExecute`` + backend engine.

``Realizer`` executes an ``ExecutionPlan`` against real tensors, step by
step, in plan order.  Data-flow follows the static analysis verbatim, and
the paper's copy-free memory management becomes PyTorch views and
in-place writes:

  * micro-batch reads of a FULL value  -> ``narrow`` views (zero-copy:
    a micro-batch shares the full tensor's storage)
  * merged reads of per-part values    -> a preallocated ``torch.empty``
    buffer; each producer writes its slice in place through
    ``narrow(...).copy_()`` when it runs (no ``cat`` on the merge path)
  * env references are dropped at the precomputed death site, returning
    memory to the caching allocator (the GC analogue of Alg. 1
    ref_count).

No op writes into a tensor another step still reads: ops return new
tensors or views they never write, except the decode attention op, which
updates the KV cache it alone reads (models/layers.py).

By default a ``Realizer`` lowers its plan once to the slot IR of
``core/lowering.py`` and replays that; ``lowered=False`` keeps this
module's step-by-step interpreter, the reference semantics the lowered
path is held to bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .analysis import BUF, AnalysisResult, static_analysis, step_writes
from .graph import FULL, OpGraph
from .lowering import lower
from .plan import ExecutionPlan, PlanStep


def _resolve_path(tree, path):
    for k in path:
        if tree is None or k not in tree:
            return None
        tree = tree[k]
    return tree


@dataclasses.dataclass
class FusedCallInfo:
    """Handed to ``replace_func`` so fused kernels know what they replace."""

    step: PlanStep
    graph: OpGraph
    ext_inputs: list          # [(tid, part)]
    ext_outputs: list         # [(tid, part)]
    split_sizes: tuple
    params: dict              # {param_path: subtree}

    def node(self, i: int = 0):
        return self.graph.nodes[self.step.handles[i].oid]

    def params_of(self, i: int = 0):
        n = self.node(i)
        return self.params.get(n.param_paths[0]) if n.param_paths else {}


class Realizer:
    """Executes one plan.  One instance per (graph, plan, analysis).

    By default the plan is lowered once to a slot-based instruction
    stream (``core.lowering``) and ``__call__`` replays that; pass
    ``lowered=False`` to run the step-by-step interpreter (kept as the
    reference semantics for differential testing).  With a
    ``plan_cache`` (a ``PlanStore``) the lowering comes from its
    ``get_or_lower`` under ``plan_salt`` and ``op_config``, so a
    structure it already holds is shared or restored, not re-lowered;
    ``capture`` says whether the step running the plan is captured as a
    CUDA Graph (a key of the store's shape bucket).
    """

    def __init__(self, graph: OpGraph, plan: ExecutionPlan,
                 analysis: Optional[AnalysisResult] = None,
                 lowered: bool = True, plan_cache=None, plan_salt: str = "",
                 capture: bool = False, op_config=()):
        self.graph = graph
        self.plan = plan
        self.lowered = None
        if lowered:
            if plan_cache is not None:
                self.lowered = plan_cache.get_or_lower(
                    graph, plan, analysis, salt=plan_salt, capture=capture,
                    op_config=op_config)
            else:
                self.lowered = lower(graph, plan, analysis, capture=capture)
            self.analysis = self.lowered.analysis
        else:
            self.analysis = analysis or static_analysis(graph, plan)
        self.offsets = []
        acc = 0
        for s in plan.split_sizes:
            self.offsets.append(acc)
            acc += s
        self._deaths_by_step: dict[int, list] = {}
        for key, d in self.analysis.death.items():
            self._deaths_by_step.setdefault(d, []).append(key)

    # -- value plumbing ----------------------------------------------------
    def _read(self, env, t, part, mode, key):
        if mode == "direct":
            return env[(t, key)]
        if mode == "slice":
            full = env[(t, FULL)]
            bd = self.graph.tensors[t].batch_dim
            return full.narrow(bd, self.offsets[part],
                               self.plan.split_sizes[part])
        if mode == "assemble":
            return env[(t, BUF)]
        raise AssertionError(mode)

    def _write(self, env, t, part, val):
        env[(t, part)] = val
        if t in self.analysis.prealloc and part != FULL:
            ref = self.graph.tensors[t]
            bkey = (t, BUF)
            if bkey not in env:
                env[bkey] = torch.empty(ref.shape, dtype=val.dtype,
                                        device=val.device)
            bd = ref.batch_dim
            env[bkey].narrow(bd, self.offsets[part],
                             self.plan.split_sizes[part]).copy_(val)

    def _node_params(self, node, params):
        if not node.param_paths:
            return {}
        resolved = {p: _resolve_path(params, p) for p in node.param_paths}
        if node.members:
            # coalesced units take {param_path: subtree}, keyed per member
            return resolved
        return resolved[node.param_paths[0]] or {}

    # -- execution -----------------------------------------------------------
    def __call__(self, params, inputs: dict[str, Any]) -> dict[str, Any]:
        if self.lowered is not None:
            return self.lowered(params, inputs)
        g, plan, ana = self.graph, self.plan, self.analysis
        env: dict = {}
        for name, t in g.inputs.items():
            if name not in inputs:
                raise KeyError(f"missing graph input {name!r}")
            env[(t, FULL)] = inputs[name]
        for i, step in enumerate(plan.steps):
            reads = ana.reads[i]
            vals = [self._read(env, t, p, m, k) for (t, p, m, k) in reads]
            byref = {(t, p): v for (t, p, m, k), v in zip(reads, vals)}
            if step.kind == "fused":
                self._run_fused(env, step, byref, params)
            else:
                h = step.handles[0]
                node = g.nodes[h.oid]
                part = FULL if step.kind == "merged" else h.mb
                args = []
                for t in node.inputs:
                    p = part if g.tensors[t].batch_dim is not None else FULL
                    args.append(byref[(t, p)])
                outs = node.fn(self._node_params(node, params), *args)
                if not isinstance(outs, tuple):
                    outs = (outs,)
                for t, v in zip(node.outputs, outs):
                    p = part if g.tensors[t].batch_dim is not None else FULL
                    self._write(env, t, p, v)
            del vals, byref
            # GC at the death site (Alg. 1 ref_count reaching zero)
            for key in self._deaths_by_step.get(i, ()):
                env.pop(key, None)
        # final outputs, merged to FULL
        out = {}
        for (t, _p, m, k), name in zip(ana.reads[-1], g.outputs.keys()):
            out[name] = self._read(env, t, FULL, m, k)
        return out

    def _run_fused(self, env, step: PlanStep, byref, params):
        g = self.graph
        internal = {t for h in step.handles for t in g.nodes[h.oid].outputs}
        ext_in, seen = [], set()
        for h in step.handles:
            for t in g.nodes[h.oid].inputs:
                if t in internal:
                    continue
                p = h.mb if g.tensors[t].batch_dim is not None else FULL
                if (t, p) not in seen:
                    seen.add((t, p))
                    ext_in.append((t, p))
        ext_out = step_writes(g, step, len(self.plan.split_sizes))
        pdict = {}
        for h in step.handles:
            for pp in g.nodes[h.oid].param_paths:
                pdict[pp] = _resolve_path(params, pp)
        info = FusedCallInfo(step, g, ext_in, ext_out,
                             self.plan.split_sizes, pdict)
        outs = step.replace_fn(info, *[byref[key] for key in ext_in])
        if not isinstance(outs, tuple):
            outs = (outs,)
        if len(outs) != len(ext_out):
            raise ValueError(
                f"fused kernel {step.replace_name} returned {len(outs)} "
                f"outputs; expected {len(ext_out)} ({ext_out})")
        for (t, p), v in zip(ext_out, outs):
            self._write(env, t, p, v)


def realize(graph: OpGraph, plan: ExecutionPlan, params, inputs,
            analysis: Optional[AnalysisResult] = None,
            lowered: bool = True) -> dict:
    """One-shot helper (tests / small models)."""
    return Realizer(graph, plan, analysis, lowered=lowered)(params, inputs)


def sequential_plan(graph: OpGraph) -> ExecutionPlan:
    """Reference plan: topo order, no split (the paper's fallback mode)."""
    from .plan import OpHandle, graph_fingerprint
    steps = [PlanStep("exec", (OpHandle(oid, FULL, graph.nodes[oid].name),))
             for oid in graph.topo_order()]
    return ExecutionPlan(steps, (), graph_fingerprint(graph))
