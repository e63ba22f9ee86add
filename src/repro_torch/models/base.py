"""Model assembly: segments, the layer loop, and the LM base.

A model is a list of *segments* (embed → layer stack → head).  Each
segment is one traced OpGraph, scheduled once; a layer stack runs its one
plan once per layer over per-layer slices (views) of the same stacked
``(n_layers, ...)`` parameter tensors — per-layer schedules are periodic,
which is the paper's per-subgraph CUDA-graph reuse.

Conventions
  * layer graphs:  inputs {x, positions, ...}, outputs {x, ...}
  * decode graphs: extra inputs {cache_len, <name>_cache...} taken per
    layer from stacked caches; matching outputs are the updated caches
    (written in place, so the stacked cache is the collected output).
  * prefill:       extra outputs (k, v) collected into a stacked
    ``(n_layers, B, S, kv, hd)`` buffer.
  * train:         inputs {ids, labels, positions}; the head's outputs are
    per-sample (loss_sum, token_count), which the train step
    differentiates (``train/step.py``).  The layer loop takes each
    layer's views of the stacked params once a call (``unbind``, whose
    backward stacks the layers' gradients once) and, under ``remat``,
    recomputes a layer's forward in the backward
    (``torch.utils.checkpoint``).
  * streams:       on the card each segment call (each layer of a stack)
    forks the plan's side streams from the current stream and joins them
    back before it returns (``core/streams.py``), so the overlap the plan
    sets up stays within one call and the next layer starts from one
    stream; under autograd the backward runs each op on its forward
    op's stream, and ``remat``'s recomputation forks and joins again.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Optional, Sequence

import torch

from ..configs.base import ArchConfig
from ..core import ScheduleContext, partition, record_plan, trace
from ..core.backend import Realizer
from ..core.graph import OpGraph
from ..core.module import Module, TensorSpec, fold_seed
from ..core.verify import VerifyReport, enforce, verify_lowered
from ..core.verify import verify as run_verify
from ..device import resolve_device
from ..tree import leaves, tree_map
from .layers import (AddOp, AllGatherOp, AttentionOp, DecodeAttentionOp,
                     EmbedOp, HeadLayout, HeadLossOp, LmHeadOp, MeshInfo,
                     MLPBlock, OProj, PsumOp, QKVProj, ReduceScatterOp,
                     RMSNormOp, RopeOp, TakeLastOp)


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Segment:
    name: str                      # key into the params tree
    module: Module
    graph: OpGraph
    count: int = 1                 # layer count (stacked params when > 1)
    scan_inputs: tuple = ()        # graph inputs stacked per layer (caches)
    scan_outputs: tuple = ()       # graph outputs collected per layer
    carry: tuple = ("x",)          # outputs fed to the next segment
    input_map: dict = dataclasses.field(default_factory=dict)   # graph->env
    output_map: dict = dataclasses.field(default_factory=dict)  # graph->env
    uid: str = ""                  # unique id when name repeats (shared wts)

    @property
    def key(self):
        return self.uid or self.name

    def collect_key(self, k: str) -> str:
        """env key a collected layer output lands on.  Outputs that are
        also per-layer *inputs* (decode caches) land on the input's key
        so the updated cache replaces the stale one."""
        if k in self.output_map:
            return self.output_map[k]
        if self.count > 1 and k in self.scan_inputs:
            return self.input_map.get(k, k)
        return f"{self.key}.{k}" if self.count > 1 else k


def _layer_slice(tree, i):
    """Layer ``i``'s views of a stacked param tree."""
    if isinstance(tree, dict):
        return {k: _layer_slice(v, i) for k, v in tree.items()}
    return None if tree is None else tree[i]


def _layer_views(tree, count: int) -> list:
    """Each of the first ``count`` layers' views of a stacked param tree,
    taken with one ``unbind`` a tensor: its backward stacks the layers'
    gradients once, where indexing each layer would build a zero tensor
    the size of the whole stack for every layer."""
    if isinstance(tree, dict):
        subs = {k: _layer_views(v, count) for k, v in tree.items()}
        return [{k: v[i] for k, v in subs.items()} for i in range(count)]
    if tree is None:
        return [None] * count
    return list(tree.unbind(0)[:count])


REMAT_POLICIES = ("full", "dots")
# the products "dots" keeps for the backward (the JAX package's
# ``checkpoint_dots``); every other op of a layer is recomputed
_DOTS = ("mm", "bmm", "addmm", "baddbmm")


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    name = getattr(op, "__name__", "").split(".")[0]
    return (CheckpointPolicy.MUST_SAVE if name in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_call(fn, policy: str, *args):
    """``fn(*args)`` whose activations the backward recomputes:
    ``"full"`` keeps none, ``"dots"`` keeps the matmul outputs.

    On the card the recompute runs on the stream the forward ran on
    (``_on_stream``), and runs to its end (no early stop): the backward
    starts it from whichever node first needs a saved tensor of the
    layer, and that node may sit on a side stream (a MoE layer's memory
    ops do), where a plan forked from it would give the recomputed
    tensors another stream than the one their backward nodes run on."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts,
                                        set_checkpoint_early_stop)
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    dev = next((t.device for a in args for t in leaves(a)
                if isinstance(t, torch.Tensor) and t.is_cuda), None)
    if dev is not None:
        fn = functools.partial(_on_stream, fn, torch.cuda.current_stream(dev))
    # the forward draws no random numbers, so the generator's state need
    # not be saved: reading it is refused while a CUDA Graph captures;
    # without an early stop the plan's side streams join before the
    # recompute returns
    with set_checkpoint_early_stop(False):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)


def _on_stream(fn, stream, *args):
    """``fn(*args)`` with ``stream`` current.  Called from another stream
    (a recompute started by a side-stream backward node), ``stream`` first
    waits for the caller's stream and the caller's stream then waits for
    ``stream``: the node reads what the recompute wrote."""
    caller = torch.cuda.current_stream(stream.device)
    if caller == stream:
        return fn(*args)
    stream.wait_stream(caller)
    try:
        with torch.cuda.stream(stream):
            return fn(*args)
    finally:
        caller.wait_stream(stream)


@dataclasses.dataclass
class Forward:
    """A realized forward pass over segments with per-segment plans.

    ``remat`` recomputes each layer of a layer stack in the backward
    (``torch.utils.checkpoint`` over the layer's realized plan; the JAX
    package's ``jax.checkpoint`` of its scan body) under
    ``remat_policy`` "full" (keep nothing) or "dots" (keep the matmul
    outputs); it acts only where a gradient is being recorded."""

    segments: list
    realizers: dict                # key -> Realizer
    strategies: dict = dataclasses.field(default_factory=dict)  # key -> name
    remat: bool = False
    remat_policy: str = "full"

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                             f"got {self.remat_policy!r}")

    def __call__(self, params, batch: dict,
                 depth: Optional[int] = None) -> dict:
        """Run the segments on ``batch``.  ``depth`` runs only the first
        ``depth`` layers of each layer stack, over the same per-layer
        plan (the self-speculative draft's truncated stack): the
        counterpart of the JAX package's slicing of the stacked params
        and caches, whose layer scan takes its length from them."""
        env = dict(batch)
        collected = {}
        for seg in self.segments:
            rz = self.realizers[seg.key]
            g = seg.graph
            imap = seg.input_map

            def _env(k):
                return env[imap.get(k, k)]

            if seg.count == 1:
                ins = {k: _env(k) for k in g.inputs}
                # merge the global tree under the segment's own subtree so
                # cross-segment share paths (tied embeddings) resolve
                seg_params = dict(params.get(seg.name) or {})
                merged = {**{k: v for k, v in params.items()
                             if k not in seg_params}, **seg_params}
                out = rz(merged, ins)
                env.update({seg.output_map.get(k, k): v
                            for k, v in out.items()})
                continue
            # loop over layers: per-layer views of the stacked params and
            # of the stacked per-layer inputs (decode caches)
            static_ins = {k: _env(k) for k in g.inputs
                          if k not in seg.carry and k not in seg.scan_inputs}
            stacked_in = {k: _env(k) for k in seg.scan_inputs}
            carry = {k: _env(k) for k in seg.carry}
            ys: dict = {}
            count = seg.count if depth is None else min(seg.count, depth)
            layer_params = _layer_views(params.get(seg.name), count)
            remat = self.remat and torch.is_grad_enabled()
            for i in range(count):
                ins = dict(static_ins)
                ins.update(carry)
                ins.update({k: v[i] for k, v in stacked_in.items()})
                out = (_remat_call(rz, self.remat_policy, layer_params[i],
                                   ins) if remat
                       else rz(layer_params[i], ins))
                carry = {k: out[k] for k in seg.carry}
                for k in seg.scan_outputs:
                    _collect(ys, k, i, out[k], count, stacked_in.get(k))
            env.update({seg.output_map.get(k, k): v for k, v in carry.items()})
            for k, v in ys.items():
                collected[seg.collect_key(k)] = v
        env.update(collected)
        return env


def _collect(ys: dict, k: str, i: int, val, count: int, stacked_input=None):
    """Land layer ``i``'s output ``val`` in the stacked output ``ys[k]``.
    An output that is the layer's own slice of a stacked input (a decode
    cache updated in place) is already there; anything else is copied
    into a ``(count, ...)`` buffer allocated at the first layer."""
    if stacked_input is not None:
        own = stacked_input[i]
        if val.data_ptr() == own.data_ptr() and val.shape == own.shape \
                and val.stride() == own.stride():
            ys[k] = stacked_input
            return
    if k not in ys:
        ys[k] = torch.empty((count,) + tuple(val.shape), dtype=val.dtype,
                            device=val.device)
    ys[k][i].copy_(val)


def build_forward(segments: Sequence[Segment],
                  scheduler,
                  info: ScheduleContext,
                  lowered: bool = True,
                  verify: str = "off",
                  plan_cache=None,
                  op_config=(),
                  capture: bool = False,
                  verify_sink: Optional[list] = None,
                  remat: bool = False,
                  remat_policy: str = "full") -> Forward:
    """Partition + schedule every segment graph, returning the Forward.

    ``scheduler`` may be an ``OpSchedulerBase``, a ``StrategyPolicy``, or
    a strategy name: a policy is resolved per segment against the
    ScheduleContext (enriched with the segment's traced graph under
    ``extra['graph']`` so graph-conditional predicates can see op names).
    Partitioning uses the policy's rule *union*, never the resolved
    branch's rules, so every context of one program sees one graph.
    ``lowered`` realizes each plan through the slot IR (the default) or,
    when False, the step-by-step interpreter.

    ``verify`` runs the static verifier and linter (``core.verify``) on
    every segment's recorded plan and its lowered IR (a plan the store
    specialized or restored included): ``"off"`` skips, ``"warn"`` emits
    a Python warning on error-severity diagnostics, ``"strict"`` raises
    ``PlanVerificationError``.  ``verify_sink`` (a list) collects every
    ``(phase/segment_key, VerifyReport)`` pair whatever the mode — what
    ``api.Program.verify()`` reads.

    ``plan_cache`` (a ``PlanStore``) lowers every segment through the
    store under the salt ``arch|phase|strategy_salt(policy)|segment``:
    a segment whose structure the store holds at another shape is
    specialized from it (a share), one it holds persisted is restored.
    ``op_config`` (``LMBase.op_closure_config()``) enters the store's
    outer key: what the op callables close over that the graph cannot
    show.  ``capture`` marks the plans of a step that is captured as a
    CUDA Graph (``core.plan_store.bucket_key``).  ``remat`` /
    ``remat_policy``: see ``Forward``.
    """
    from ..core.plan import strategy_salt
    from ..core.policy import as_policy, resolve_strategy
    policy = as_policy(scheduler)
    salt = f"{info.arch}|{info.phase}|{strategy_salt(policy)}"
    # partition with the policy's rule union, never the resolved branch's
    # rules: two shape buckets of one program must see the same graph,
    # or their structural keys diverge and the store cannot share
    rules = policy.partition_rules()
    check = verify != "off" or verify_sink is not None
    mode = verify if verify != "off" else "report"
    realizers, strategies = {}, {}
    segs = []
    for seg in segments:
        g = seg.graph
        sched = resolve_strategy(policy, info, graph=g)
        if rules:
            g = partition(g, rules, default_depth=2)
        plan = record_plan(g, sched, info)
        seg = dataclasses.replace(seg, graph=g)
        if check:
            # the plan first: a plan that cannot be realized stops here
            # with its diagnostics under "strict", not in the lowering
            report = run_verify(g, plan, lint=True)
            enforce(report, mode, what=f"segment {seg.key!r} plan")
        rz = realizers[seg.key] = Realizer(
            g, plan, lowered=lowered, plan_cache=plan_cache,
            plan_salt=f"{salt}|{seg.key}", capture=capture,
            op_config=op_config)
        if check:
            if rz.lowered is not None:
                ir = VerifyReport(tuple(verify_lowered(rz.lowered)))
                enforce(ir, mode, what=f"segment {seg.key!r} lowered plan")
                report = report.merged(ir)
            if verify_sink is not None:
                verify_sink.append((f"{info.phase}/{seg.key}", report))
        strategies[seg.key] = getattr(sched, "name", type(sched).__name__)
        segs.append(seg)
    return Forward(segs, realizers, strategies, remat=remat,
                   remat_policy=remat_policy)


# ---------------------------------------------------------------------------
# dense-LM building blocks
# ---------------------------------------------------------------------------


class EmbedSegment(Module):
    def __init__(self, cfg: ArchConfig, mesh: MeshInfo, sp: bool):
        super().__init__()
        self.emb = EmbedOp(cfg.vocab, cfg.d_model, mesh)
        self.finish = (ReduceScatterOp(mesh, dim=1, name="embed_rs") if sp
                       else PsumOp(name="embed_ar"))
        self.named("embed")

    def forward(self, *, ids):
        return {"x": self.finish(self.emb(ids))}


class DenseDecoderLayer(Module):
    """Pre-norm decoder layer; SP collectives when ``sp`` else all-reduce."""

    def __init__(self, cfg: ArchConfig, mesh: MeshInfo, sp: bool,
                 collect_kv: bool = False):
        super().__init__()
        d = cfg.d_model
        lay = HeadLayout(cfg.n_heads, cfg.n_kv, mesh.tp, cfg.hd)
        self.lay = lay
        self.sp = sp
        self.collect_kv = collect_kv
        self.ln1 = RMSNormOp(d, "ln_attn")
        if sp:
            self.ag1 = AllGatherOp(mesh, dim=1, name="ag_attn")
            self.ag2 = AllGatherOp(mesh, dim=1, name="ag_mlp")
            self.fin1 = ReduceScatterOp(mesh, dim=1, name="rs_attn")
            self.fin2 = ReduceScatterOp(mesh, dim=1, name="rs_mlp")
        else:
            self.fin1 = PsumOp(name="ar_attn")
            self.fin2 = PsumOp(name="ar_mlp")
        self.qkv = QKVProj(d, lay, mesh)
        self.rope = RopeOp(cfg.rope, cfg.rope_kwargs())
        self.attn = AttentionOp(lay)
        self.oproj = OProj(d, lay, mesh)
        self.add1 = AddOp("add_attn")
        self.ln2 = RMSNormOp(d, "ln_mlp")
        self.mlp = MLPBlock(d, cfg.d_ff, mesh, act=cfg.act)
        self.add2 = AddOp("add_mlp")
        self.named("layer")

    def forward(self, *, x, positions):
        h = self.ln1(x)
        if self.sp:
            h = self.ag1(h)
        q, k, v = self.qkv(h)
        q, k = self.rope(q, k, positions)
        a = self.attn(q, k, v)
        a = self.oproj(a)
        a = self.fin1(a)
        x = self.add1(x, a)
        h = self.ln2(x)
        if self.sp:
            h = self.ag2(h)
        m = self.mlp(h)
        m = self.fin2(m)
        x = self.add2(x, m)
        out = {"x": x}
        if self.collect_kv:
            out["k"], out["v"] = k, v
        return out


class DenseDecodeLayer(Module):
    """Decode layer: replicated activations, KV-cache update, all-reduce."""

    def __init__(self, cfg: ArchConfig, mesh: MeshInfo):
        super().__init__()
        d = cfg.d_model
        lay = HeadLayout(cfg.n_heads, cfg.n_kv, mesh.tp, cfg.hd)
        self.lay = lay
        self.ln1 = RMSNormOp(d, "ln_attn")
        self.qkv = QKVProj(d, lay, mesh)
        self.rope = RopeOp(cfg.rope, cfg.rope_kwargs())
        self.attn = DecodeAttentionOp(lay)
        self.oproj = OProj(d, lay, mesh)
        self.fin1 = PsumOp(name="ar_attn")
        self.add1 = AddOp("add_attn")
        self.ln2 = RMSNormOp(d, "ln_mlp")
        self.mlp = MLPBlock(d, cfg.d_ff, mesh, act=cfg.act)
        self.fin2 = PsumOp(name="ar_mlp")
        self.add2 = AddOp("add_mlp")
        self.named("layer")

    def forward(self, *, x, positions, cache_len, k_cache, v_cache):
        h = self.ln1(x)
        q, k, v = self.qkv(h)
        q, k = self.rope(q, k, positions)
        a, kc, vc = self.attn(q, k, v, k_cache, v_cache, cache_len)
        a = self.oproj(a)
        a = self.fin1(a)
        x = self.add1(x, a)
        h = self.ln2(x)
        m = self.mlp(h)
        m = self.fin2(m)
        x = self.add2(x, m)
        return {"x": x, "k_cache": kc, "v_cache": vc}


class TrainHead(Module):
    """Train head: final norm, then the chunked LM head + cross entropy
    (``HeadLossOp``): per-sample (loss_sum, token_count)."""

    def __init__(self, cfg: ArchConfig, mesh: MeshInfo, sp: bool):
        super().__init__()
        d = cfg.d_model
        self.sp = sp
        self.ln = RMSNormOp(d, "ln_f")
        if sp:
            self.ag = AllGatherOp(mesh, dim=1, name="ag_head")
        tie = ("embed", "emb") if cfg.tie_embeddings else None
        self.out = HeadLossOp(d, cfg.vocab, mesh, tie_path=tie)
        self.named("head")

    def forward(self, *, x, labels):
        h = self.ln(x)
        if self.sp:
            h = self.ag(h)
        ls, cnt = self.out(h, labels)
        return {"loss_sum": ls, "token_count": cnt}


class LogitsHead(Module):
    """Prefill/decode head: vocab-sharded logits.

    ``keep_last=True`` (prefill) slices to the final position before the
    head matmul; ``keep_last=False`` (decode) keeps every position.
    """

    def __init__(self, cfg: ArchConfig, mesh: MeshInfo, sp: bool,
                 keep_last: bool = True):
        super().__init__()
        d = cfg.d_model
        self.sp = sp
        self.ln = RMSNormOp(d, "ln_f")
        if sp:
            self.ag = AllGatherOp(mesh, dim=1, name="ag_head")
        self.last = TakeLastOp() if keep_last else None
        tie = ("embed", "emb") if cfg.tie_embeddings else None
        self.out = LmHeadOp(d, cfg.vocab, mesh, tie_path=tie)
        self.named("head")

    def forward(self, *, x):
        h = self.ln(x)
        if self.sp:
            h = self.ag(h)
        if self.last is not None:
            h = self.last(h)
        return {"logits": self.out(h)}


# ---------------------------------------------------------------------------
# LM base class
# ---------------------------------------------------------------------------


I32 = torch.int32
# the hand-written kernels the ops dispatch to (``kernels/ops.py``)
KERNEL_SET = ("decode_attention", "flash_attention", "fused_add_rmsnorm",
              "grouped_ffn", "rmsnorm", "ssd_scan")


class LMBase:
    """Shared machinery: build segments per phase, init params."""

    def __init__(self, cfg: ArchConfig, mesh: MeshInfo):
        self.cfg = cfg
        self.mesh = mesh

    def op_closure_config(self) -> tuple:
        """Canonical (name, value) pairs for the PlanStore's outer key:
        what this model's op callables close over that graph structure
        and shapes cannot show — the shard layout, the dtype policy, the
        rope and activation, and the kernels the ops dispatch to.  Two
        models whose graphs trace to one structure but differ in any of
        these must not share lowerings."""
        m, c = self.mesh, self.cfg
        return (("arch", c.name),
                ("tp", m.tp), ("dp", m.dp), ("pods", m.pods),
                ("fsdp", m.fsdp), ("fsdp_resident", m.fsdp_resident),
                ("seq_parallel", bool(c.seq_parallel)),
                ("act_dtype", "bfloat16"),
                ("rope", c.rope), ("act", c.act),
                ("tie_embeddings", bool(c.tie_embeddings)),
                ("kernels", KERNEL_SET))

    # subclasses define these ------------------------------------------------
    def make_embed(self, phase: str) -> Module:
        raise NotImplementedError

    def layer_stacks(self, phase: str) -> list:
        """[(name, module, count, scan_inputs, scan_outputs)]"""
        raise NotImplementedError

    def make_head(self, phase: str) -> Module:
        raise NotImplementedError

    def batch_inputs(self, phase: str, B_loc: int, S: int,
                     s_max: int = 0) -> dict:
        """name -> (TensorSpec, batch_dim) for non-cache inputs.  M-RoPE's
        positions are three streams (t, h, w), ``(3, B, S)`` with the
        batch at dim 1, in every phase."""
        spec = TensorSpec((B_loc, S), I32)
        pos = (TensorSpec((3, B_loc, S), I32), 1) \
            if self.cfg.rope == "mrope" else (spec, 0)
        if phase == "train":
            return {"ids": (spec, 0), "labels": (spec, 0), "positions": pos}
        if phase == "prefill":
            return {"ids": (spec, 0), "positions": pos}
        if phase == "decode":
            # S == 1 is the classic single-token decode; S > 1 runs the
            # same cached-attention graph over a chunk of S positions
            return {"ids": (spec, 0), "positions": pos,
                    "cache_len": (TensorSpec((B_loc,), I32), 0)}
        raise NotImplementedError(f"phase {phase!r} is not ported yet")

    def cache_specs(self, stack_name: str, B_loc: int, s_max: int) -> dict:
        """Per-layer cache TensorSpecs for decode (unstacked)."""
        return {}

    # shared ------------------------------------------------------------------
    def seq_local(self, phase: str, S: int) -> int:
        sp = self.cfg.seq_parallel and phase != "decode"
        return S // self.mesh.tp if sp else S

    def build_segments(self, phase: str, B_loc: int, S: int,
                       s_max: int = 0) -> tuple[list[Segment], dict]:
        """Trace all segment graphs.  Returns (segments, batch_input_specs)."""
        cfg = self.cfg
        binputs = self.batch_inputs(phase, B_loc, S, s_max)
        segs = []
        emb = self.make_embed(phase)
        esig = inspect.signature(emb.forward)
        emb_in = {k: v[0] for k, v in binputs.items()
                  if k in esig.parameters}
        g = trace(emb, emb_in, batch_dims={k: binputs[k][1] for k in emb_in})
        segs.append(Segment("embed", emb, g))
        x_spec = TensorSpec((B_loc, self.seq_local(phase, S), cfg.d_model),
                            torch.bfloat16)
        for stack in self.layer_stacks(phase):
            name, mod, count, sc_in, sc_out = stack[:5]
            opts = stack[5] if len(stack) > 5 else {}
            lay_in = {"x": x_spec, "x0": x_spec}
            bd = {"x": 0, "x0": 0}
            for k, (spec, b) in binputs.items():
                if k in ("ids", "labels"):
                    continue
                lay_in[k] = spec
                bd[k] = b
            if phase == "decode":
                for cname, cspec in self.cache_specs(name, B_loc, s_max).items():
                    lay_in[cname] = cspec
                    bd[cname] = 0
            sig = inspect.signature(mod.forward)
            lay_in = {k: v for k, v in lay_in.items() if k in sig.parameters}
            bd = {k: v for k, v in bd.items() if k in lay_in}
            g = trace(mod, lay_in, batch_dims=bd)
            segs.append(Segment(name, mod, g, count=count,
                                scan_inputs=sc_in, scan_outputs=sc_out,
                                **opts))
        head = self.make_head(phase)
        head_in, hbd = {"x": x_spec}, {"x": 0}
        if phase == "train":
            head_in["labels"] = binputs["labels"][0]
            hbd["labels"] = 0
        g = trace(head, head_in, batch_dims=hbd)
        segs.append(Segment("head", head, g))
        return segs, binputs

    def decode_cache_env(self, B_loc: int, s_max: int) -> dict:
        """env-key -> TensorSpec for all decode caches; stacked
        ``(count,) + shape`` for layer stacks."""
        out = {}
        for stack in self.layer_stacks("decode"):
            name, mod, count, sc_in = stack[0], stack[1], stack[2], stack[3]
            opts = stack[5] if len(stack) > 5 else {}
            imap = opts.get("input_map", {})
            for cn, spec in self.cache_specs(name, B_loc, s_max).items():
                if cn not in sc_in:
                    continue
                shape = (count,) + spec.shape if count > 1 else spec.shape
                out[imap.get(cn, cn)] = TensorSpec(shape, spec.dtype)
        return out

    CACHE_MODEL_DIMS = {"k_cache": -2, "v_cache": -2,
                        "conv_state": -1, "ssm_state": -3}

    def decode_cache_layout(self) -> dict:
        """env-key -> (batch_dim, model_dim) for every decode cache."""
        out = {}
        for stack in self.layer_stacks("decode"):
            name, _, count, sc_in = stack[0], stack[1], stack[2], stack[3]
            opts = stack[5] if len(stack) > 5 else {}
            imap = opts.get("input_map", {})
            for cn in self.cache_specs(name, 1, 2):
                if cn not in sc_in:
                    continue
                base = next(k for k in self.CACHE_MODEL_DIMS if cn.endswith(k))
                out[imap.get(cn, cn)] = (1 if count > 1 else 0,
                                         self.CACHE_MODEL_DIMS[base])
        return out

    def decode_cache_page_env(self, num_pages: int, page_size: int) -> dict:
        """Paged decode-cache pool specs: ``decode_cache_env`` with the
        request-batch dim read as a physical-page dim and the sequence
        dim shrunk to one page — ``(P, page, kv, hd)`` per layer,
        ``(L, P, page, kv, hd)`` stacked.  The serve engine gathers the
        pages back into the contiguous ``(B, s_max, ...)`` view each
        step, so the decode forward never sees the paging.

        Raises ``UnpageableCache`` for decode state with no sequence axis
        to page over (SSM conv/ssm states are one fixed size a request):
        every cache's ``batch_dim + 1`` axis must scale with ``s_max``."""
        a = self.decode_cache_env(1, page_size)
        b = self.decode_cache_env(1, 2 * page_size)
        layout = self.decode_cache_layout()
        for key, sa in a.items():
            bd = layout[key][0]
            want = list(sa.shape)
            want[bd + 1] *= 2
            if sa.shape[bd + 1] != page_size \
                    or tuple(want) != tuple(b[key].shape):
                from ..serve.kv_cache import UnpageableCache
                raise UnpageableCache(
                    f"decode cache {key!r} has no s_max-proportional "
                    f"sequence axis at dim {bd + 1} "
                    f"(shape {tuple(sa.shape)} at s_max={page_size} vs "
                    f"{tuple(b[key].shape)} at s_max={2 * page_size}); "
                    "serve this model with DenseCache")
        return self.decode_cache_env(num_pages, page_size)

    # params -------------------------------------------------------------------
    def param_pspecs(self, segs) -> dict:
        """Partition-spec tuples of the param tree (stacked layers get a
        leading ``None``): which mesh axes each leaf is sharded over."""
        out = {}
        for seg in segs:
            if seg.name in out:
                continue
            ps = seg.module.param_pspecs()
            if not ps:
                continue
            if seg.count > 1:
                ps = tree_map(lambda spec: (None,) + tuple(spec), ps)
            out[seg.name] = ps
        return out

    def param_shapes(self, segs, global_: bool = True) -> dict:
        """TensorSpec tree of the params (stacked for layer segments):
        the global (unsharded) shapes, or with ``global_=False`` this
        rank's local ones."""
        out = {}
        for seg in segs:
            if seg.name in out:
                continue
            shapes = (seg.module.global_param_shapes() if global_
                      else seg.module.param_shapes())
            if not shapes:
                continue
            if seg.count > 1:
                shapes = tree_map(
                    lambda t, n=seg.count: TensorSpec((n,) + tuple(t.shape),
                                                      t.dtype), shapes)
            out[seg.name] = shapes
        return out

    def init_params(self, seed: int = 0, device=None,
                    phase: str = "prefill", shard=None) -> dict:
        """Random parameter tree from ``seed``, drawn on ``device`` (default:
        the GPU).  Layer stacks are ``(n_layers, ...)`` tensors filled layer
        by layer (one layer's worth of temporaries at a time).
        ``shard(tree, pspecs) -> local tree`` (a mesh's rank): each
        segment, and each layer of a stack, is drawn global (unsharded),
        whose values do not depend on the mesh, and cut to this rank's
        shard at once (``api.Program.init_params``), so no more than one
        global layer is ever held."""
        device = resolve_device(device)
        segs, _ = self.build_segments(phase, 2, 2 * self.mesh.tp
                                      if self.cfg.seq_parallel else 2,
                                      s_max=4)
        global_ = shard is not None

        def draw(module, s):
            p = module.init(s, device=device, global_=global_)
            return shard(p, module.param_pspecs()) if p and global_ else p

        out = {}
        for seg in segs:
            s = fold_seed(seed, seg.name)
            if seg.name in out:  # shared-weight segment (same params reused)
                continue
            if seg.count == 1:
                p = draw(seg.module, s)
                if p:
                    out[seg.name] = p
                continue
            stacked = None
            for i in range(seg.count):
                layer = draw(seg.module, fold_seed(s, str(i)))
                if stacked is None:
                    stacked = tree_map(
                        lambda t: torch.empty((seg.count,) + tuple(t.shape),
                                              dtype=t.dtype, device=t.device),
                        layer)
                _tree_zip(lambda dst, src, i=i: dst[i].copy_(src),
                          stacked, layer)
                del layer
            if stacked:
                out[seg.name] = stacked
        return out


def _tree_zip(fn, a, b):
    if isinstance(a, dict):
        for k in a:
            _tree_zip(fn, a[k], b[k])
        return
    fn(a, b)
