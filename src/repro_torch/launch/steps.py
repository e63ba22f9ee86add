"""Step builders of ``api.Program``, on one device or rank-local on a mesh
— the counterparts of the JAX package's ``shard_map``'d steps
(``src/repro/launch/steps.py`` ``_build_global_*``).

``shard_map`` runs one function per device on its shards; here each rank
runs the step the single-device path builds — lowered through the
program's PlanStore, over per-resource streams, the train step one CUDA
Graph on the card — at the local batch ``B_loc``, with the JAX package's
``ScheduleContext`` (``mesh_shape`` from the mesh), on the local shards
``launch/sharding.py`` cuts.  Collectives inside run over the process
groups ``launch/mesh.py:make_mesh`` bound.  With no mesh ``B_loc`` is the
global batch and the step is the single-device one.  On a mesh the
returned ``api.CompiledStep`` also carries the global ``in_specs`` and
the ``in_placements`` / ``out_placements`` of what goes in and comes
out.  The deprecated ``build_global_*`` wrappers of the JAX package are
not ported.
"""
from __future__ import annotations

from ..api import CompiledStep
from ..core.scheduler import ScheduleContext
from ..models.base import build_forward
from ..train.step import _build_train_step
from ..tree import tree_map
from .mesh import mesh_shape_dict
from .sharding import global_batch_specs, global_param_specs


class RankForward:
    """The rank-local prefill/decode step: the segments' ``Forward`` with
    only the outputs the step hands back (``keys``)."""

    def __init__(self, fwd, keys):
        self.fwd, self.keys = fwd, tuple(keys)

    @property
    def strategies(self) -> dict:
        return self.fwd.strategies

    def __call__(self, params, batch: dict) -> dict:
        out = self.fwd(params, batch)
        return {k: out[k] for k in self.keys}


def _local(model, phase: str, seq_len: int, global_batch: int, mesh,
           s_max: int = 0):
    """(batch specs, batch placements, B_loc, replicated, context) of a
    step; the specs and placements are ``None`` with no mesh."""
    specs, place, B_loc, repl = (None, None, global_batch, False)
    if mesh is not None:
        specs, place, B_loc, repl = global_batch_specs(
            model, phase, seq_len, global_batch, mesh, s_max=s_max)
    info = ScheduleContext(
        local_batch=B_loc, global_batch=global_batch, seq_len=seq_len,
        phase=phase, arch=model.cfg.name,
        mesh_shape=mesh_shape_dict(mesh) if mesh is not None else {})
    return specs, place, B_loc, repl, info


def build_train_step(model, policy, global_batch: int, seq_len: int, mesh,
                     tcfg, *, plan_store, verify: str, verify_sink):
    """``fn(params, opt, batch, step) -> (params, opt, metrics)`` on this
    rank's shards; AdamW's m and v take their params' placements, the
    count and the metrics are replicated."""
    b_specs, b_place, B_loc, _, info = _local(model, "train", seq_len,
                                              global_batch, mesh)
    step, segs, binputs, init_opt = _build_train_step(
        model, policy, B_loc, seq_len, tcfg, info, plan_store=plan_store,
        verify=verify, verify_sink=verify_sink)
    out = CompiledStep(fn=step, segments=segs, batch_inputs=binputs,
                       init_opt=init_opt)
    if mesh is None:
        return out
    p_specs, p_place = global_param_specs(model, segs, mesh)
    opt_place = {"state": tree_map(lambda p: {"m": p, "v": p}, p_place),
                 "count": ()}
    metric_place = {"loss": (), "grad_norm": (), "lr": (), "tokens": ()}
    out.in_specs = (p_specs, None, b_specs, None)
    out.in_placements = (p_place, opt_place, b_place, ())
    out.out_placements = (p_place, opt_place, metric_place)
    return out


def _forward_step(model, policy, phase: str, global_batch: int,
                  seq_len: int, mesh, s_max: int, *, plan_store,
                  verify: str, verify_sink):
    """(the built step, B_loc, replicated, batch placements); the step's
    ``fn`` is the ``Forward`` itself with no mesh."""
    b_specs, b_place, B_loc, repl, info = _local(
        model, phase, seq_len, global_batch, mesh, s_max=s_max)
    width = 1 if phase == "decode" else seq_len
    segs, binputs = model.build_segments(phase, B_loc, width, s_max=s_max)
    fwd = build_forward(segs, policy, info, plan_cache=plan_store,
                        op_config=model.op_closure_config(),
                        verify=verify, verify_sink=verify_sink)
    out = CompiledStep(fn=fwd, segments=segs, batch_inputs=binputs)
    if mesh is not None:
        p_specs, p_place = global_param_specs(model, segs, mesh)
        out.in_specs = (p_specs, b_specs)
        out.in_placements = (p_place, b_place)
    return out, B_loc, repl, b_place


def build_prefill_step(model, policy, global_batch: int, seq_len: int,
                       mesh, s_max: int, *, plan_store, verify: str,
                       verify_sink):
    """``fn(params, batch) -> {"logits", <collected k/v>}`` (on a mesh:
    on this rank's shards, and only those outputs)."""
    out, _, repl, _ = _forward_step(
        model, policy, "prefill", global_batch, seq_len, mesh, s_max,
        plan_store=plan_store, verify=verify, verify_sink=verify_sink)
    if mesh is None:
        return out
    b = () if repl else model.mesh.dp_axes
    out_place = {"logits": (b, (), ("model",))}
    for seg in out.segments:
        for k in seg.scan_outputs:
            # the collected k/v, stacked by layer (5-d) or not
            ref = seg.graph.tensors[seg.graph.outputs[k]]
            nd = len(ref.shape) + (seg.count > 1)
            out_place[seg.collect_key(k)] = (
                ((), b, (), ("model",), ()) if nd == 5
                else (b, (), ("model",), ()))
    out.fn = RankForward(out.fn, out_place)
    out.out_placements = out_place
    return out


def build_decode_step(model, policy, global_batch: int, s_max: int, mesh,
                      *, plan_store, verify: str, verify_sink):
    """``fn(params, batch) -> {"logits", <updated caches>}`` (on a mesh:
    on this rank's shards, and only those outputs); ``s_max`` is the
    cache depth."""
    out, B_loc, repl, b_place = _forward_step(
        model, policy, "decode", global_batch, s_max, mesh, s_max,
        plan_store=plan_store, verify=verify, verify_sink=verify_sink)
    if mesh is None:
        return out
    b = () if repl else model.mesh.dp_axes
    out_place = {"logits": (b, (), ("model",)),
                 **{k: b_place[k]
                    for k in sorted(model.decode_cache_env(B_loc, s_max))}}
    out.fn = RankForward(out.fn, out_place)
    out.out_placements = out_place
    return out


def build_decode_tiers(model, policy, max_batch: int, s_max: int, mesh,
                       tiers=None, *, plan_store, verify: str,
                       verify_sink) -> dict:
    """Decode steps at every batch tier against one shared PlanStore —
    the launch-layer analogue of the serve engine's tiered captures.

    ``tiers`` are *global* decode batch sizes (default: powers of two up
    to ``max_batch``).  Decode graphs are structurally identical across
    batch sizes, so the first tier pays the lowering and every further
    tier derives from it (PlanStore shares).  Returns
    ``{tier: CompiledStep}``."""
    from ..serve.engine import pow2_tiers
    return {tier: build_decode_step(model, policy, tier, s_max, mesh,
                                    plan_store=plan_store, verify=verify,
                                    verify_sink=verify_sink)
            for tier in tuple(tiers or pow2_tiers(max_batch))}
