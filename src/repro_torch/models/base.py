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
"""
from __future__ import annotations

import dataclasses
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
from .layers import (AddOp, AllGatherOp, AttentionOp, DecodeAttentionOp,
                     EmbedOp, HeadLayout, LmHeadOp, MeshInfo, MLPBlock, OProj,
                     PsumOp, QKVProj, ReduceScatterOp, RMSNormOp, RopeOp,
                     TakeLastOp)


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
    if isinstance(tree, dict):
        return {k: _layer_slice(v, i) for k, v in tree.items()}
    return None if tree is None else tree[i]


@dataclasses.dataclass
class Forward:
    """A realized forward pass over segments with per-segment plans."""

    segments: list
    realizers: dict                # key -> Realizer
    strategies: dict = dataclasses.field(default_factory=dict)  # key -> name

    def __call__(self, params, batch: dict) -> dict:
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
            stacked_params = params.get(seg.name)
            carry = {k: _env(k) for k in seg.carry}
            ys: dict = {}
            for i in range(seg.count):
                ins = dict(static_ins)
                ins.update(carry)
                ins.update({k: v[i] for k, v in stacked_in.items()})
                out = rz(_layer_slice(stacked_params, i), ins)
                carry = {k: out[k] for k in seg.carry}
                for k in seg.scan_outputs:
                    _collect(ys, k, i, out[k], seg.count,
                             stacked_in.get(k))
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
                  verify_sink: Optional[list] = None) -> Forward:
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
    CUDA Graph (``core.plan_store.bucket_key``).
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
    return Forward(segs, realizers, strategies)


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
                ("fsdp", m.fsdp),
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
        """name -> (TensorSpec, batch_dim) for non-cache inputs."""
        if self.cfg.rope == "mrope":
            raise NotImplementedError("M-RoPE is not ported yet")
        spec = TensorSpec((B_loc, S), I32)
        if phase == "prefill":
            return {"ids": (spec, 0), "positions": (spec, 0)}
        if phase == "decode":
            # S == 1 is the classic single-token decode; S > 1 runs the
            # same cached-attention graph over a chunk of S positions
            return {"ids": (spec, 0), "positions": (spec, 0),
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
        g = trace(head, {"x": x_spec}, batch_dims={"x": 0})
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

    # params -------------------------------------------------------------------
    def init_params(self, seed: int = 0, device=None,
                    phase: str = "prefill") -> dict:
        """Random parameter tree from ``seed``, drawn on ``device`` (default:
        the GPU).  Layer stacks are ``(n_layers, ...)`` tensors filled layer
        by layer (one layer's worth of temporaries at a time)."""
        device = resolve_device(device)
        segs, _ = self.build_segments(phase, 2, 2 * self.mesh.tp
                                      if self.cfg.seq_parallel else 2,
                                      s_max=4)
        out = {}
        for seg in segs:
            s = fold_seed(seed, seg.name)
            if seg.name in out:  # shared-weight segment (same params reused)
                continue
            if seg.count == 1:
                p = seg.module.init(s, device=device)
                if p:
                    out[seg.name] = p
                continue
            stacked = None
            for i in range(seg.count):
                layer = seg.module.init(fold_seed(s, str(i)), device=device)
                if stacked is None:
                    stacked = _tree_map(
                        lambda t: torch.empty((seg.count,) + tuple(t.shape),
                                              dtype=t.dtype, device=t.device),
                        layer)
                _tree_zip(lambda dst, src, i=i: dst[i].copy_(src),
                          stacked, layer)
                del layer
            if stacked:
                out[seg.name] = stacked
        return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_zip(fn, a, b):
    if isinstance(a, dict):
        for k in a:
            _tree_zip(fn, a[k], b[k])
        return
    fn(a, b)
