"""Mixture-of-Experts layers (deepseek-moe-16b, grok-1-314b).

Expert parallelism over the 'model' mesh axis with explicit, *schedulable*
all-to-all dispatch/combine ops — the DBO / shared-expert-overlap targets
from the paper (Fig. 1a, §3.2.2 Example 1).

Virtual experts: when n_experts < TP, each expert is sharded across
``es = TP // n_experts`` ranks (intra-expert FFN tensor parallelism); a
token is dispatched to all ``es`` shards of each selected expert and the
partial outputs sum in the combine.  When n_experts >= TP, each rank
hosts ``e_loc = V // TP`` whole experts.  Capacity-based static shapes
(C = max(4, ceil(cf·n·k / E))); overflow tokens drop (standard).

Dispatch buffers scale with the micro-batch token count, so they are
VBATCH tensors: produced/consumed per micro-batch, never sliced/merged —
which statically enforces that a scheduler splitting the MoE section keeps
its whole dispatch→combine chain per-micro-batch (what DBO wants).

The expert GEMM goes through ``kernels.ops.grouped_ffn`` — the Hopper
kernel on a CUDA tensor, its plain version on the CPU — and trains through
its autograd Function (``kernels/grouped_matmul.py`` ``GroupedFFN``: the
gate's backward a kernel too).  Under ``mesh.fsdp`` the experts take
the JAX package's two other storage modes: zero3 weight gathers
(``ParamGatherOp``, token-sharded train and prefill) and ff-sharded
resident weights (``FFShardedExpertGEMM``, the replicated decode layout,
completed by a psum over 'data'); both run the grouped-FFN kernel.
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ArchConfig, MoEConfig
from ..core.graph import VBATCH
from ..core.module import Module, Op, TensorSpec, mark
from ..dist import collectives as col
from .base import (DenseDecodeLayer, DenseDecoderLayer, EmbedSegment, LMBase,
                   LogitsHead, TrainHead)
from .layers import (AddOp, AllGatherOp, AttentionOp, DecodeAttentionOp,
                     HeadLayout, make_param, MeshInfo, MLPBlock, OProj,
                     PsumOp, QKVProj, ReduceScatterOp, RMSNormOp, RopeOp)


def moe_dims(m: MoEConfig, tp: int):
    """(virtual experts V, local experts e_loc, expert shards es, ff shard)."""
    if m.n_experts >= tp:
        assert m.n_experts % tp == 0, (m.n_experts, tp)
        return m.n_experts, m.n_experts // tp, 1, m.d_ff_expert
    assert tp % m.n_experts == 0, (m.n_experts, tp)
    es = tp // m.n_experts
    assert m.d_ff_expert % es == 0
    return tp, 1, es, m.d_ff_expert // es


class RouterOp(Op):
    """Top-k router.  Outputs combine weights + *virtual* expert ids."""

    resource = "compute"

    def __init__(self, d, m: MoEConfig, mesh: MeshInfo, name="router"):
        super().__init__()
        self.m = m
        V, e_loc, es, ffs = moe_dims(m, mesh.tp)
        self.es = es
        self.wr = make_param((d, m.n_experts), torch.float32, ((), ()), mesh)
        self.out_batch_dims = (0, 0)
        self.named(name)

    def kernel(self, p, x):
        m = self.m
        logits = torch.matmul(x.float(), p["wr"])
        probs = torch.softmax(logits, dim=-1)
        # a stable descending sort keeps equal probabilities in expert
        # order: ties go to the lower expert index, as lax.top_k does
        w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        w, idx = w[..., :m.top_k], idx[..., :m.top_k].to(torch.int32)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        # expand to virtual experts: each selected expert -> its es shards
        r = torch.arange(self.es, dtype=idx.dtype, device=idx.device)
        ve = (idx[..., None] * self.es + r).reshape(*idx.shape[:-1], -1)
        wv = torch.repeat_interleave(w, self.es, dim=-1).float()
        return wv, ve                                 # (B,S,k*es) each


class DispatchBuildOp(Op):
    """Pack tokens into per-virtual-expert capacity slots.

    Outputs: buf (V, C, d) [VBATCH], slot (B,S,kv) int32 (-1 = dropped)."""

    resource = "memory"

    def __init__(self, m: MoEConfig, mesh: MeshInfo, name="moe_dispatch_build"):
        super().__init__()
        self.m = m
        self.V, self.e_loc, self.es, _ = moe_dims(m, mesh.tp)
        self.out_batch_dims = (VBATCH, 0)
        self.named(name)

    def _capacity(self, n_tokens: int) -> int:
        m = self.m
        per = n_tokens * m.top_k / m.n_experts
        return max(4, int(math.ceil(m.capacity_factor * per)))

    def kernel(self, p, x, ve):
        B, S, d = x.shape
        kv = ve.shape[-1]
        n, nk = B * S, B * S * kv
        C = self._capacity(n)
        vef = ve.reshape(nk).long()
        # slot = how many earlier (token, k) positions, in row-major order,
        # chose the same expert: the rank within its expert's group of a
        # stable sort by expert (the JAX package's cumsum over a one-hot
        # (nk, V) matrix, whose scan along the long axis is slow on a GPU)
        order = torch.argsort(vef, stable=True)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(nk, device=x.device)
        # (bincount would read the largest id back to the host)
        counts = torch.zeros(self.V, dtype=vef.dtype, device=x.device) \
            .index_add_(0, vef, torch.ones_like(vef))
        slot = rank - (torch.cumsum(counts, 0) - counts)[vef]
        keep = slot < C
        # dropped rows land in one scratch row past the end, sliced off
        flat_idx = torch.where(keep, vef * C + slot, self.V * C)
        tok = torch.arange(n, device=x.device).repeat_interleave(kv)
        buf = torch.zeros((self.V * C + 1, d), dtype=x.dtype, device=x.device)
        buf.index_copy_(0, flat_idx, x.reshape(n, d)[tok])
        slot_out = torch.where(keep, slot, -1).reshape(B, S, kv).to(torch.int32)
        return buf[:self.V * C].view(self.V, C, d), slot_out

    def infer_out(self, in_shapes):
        x, ve = in_shapes
        B, S, d = x.shape
        C = self._capacity(B * S)
        return (TensorSpec((self.V, C, d), x.dtype),
                TensorSpec((B, S, ve.shape[-1]), torch.int32))


class MoEAllToAllOp(Op):
    """Expert-parallel all-to-all (network).  direction='dispatch' sends
    (V,C,d) -> (e_loc, T*C, d); 'combine' is the inverse."""

    resource = "network"
    out_batch_dim = VBATCH

    def __init__(self, mesh: MeshInfo, direction: str, name=None):
        super().__init__()
        self.mesh = mesh
        self.direction = direction
        self.named(name or f"moe_a2a_{direction}")

    def kernel(self, p, buf):
        if self.direction == "dispatch":
            return col.all_to_all(buf, "model", split_dim=0, concat_dim=1)
        return col.all_to_all(buf, "model", split_dim=1, concat_dim=0)

    def infer_out(self, in_shapes):
        s = list(in_shapes[0].shape)
        t = self.mesh.tp
        if self.direction == "dispatch":
            s[0] //= t
            s[1] *= t
        else:
            s[1] //= t
            s[0] *= t
        return TensorSpec(tuple(s), in_shapes[0].dtype)


class ParamGatherOp(Op):
    """FSDP/ZeRO-3: all-gather a data-axis-sharded param along ``gdim``
    before use — a schedulable *network* op (the paper's §2.1 weight-shard
    prefetch made first-class; the SBO scheduler overlaps it)."""

    resource = "network"
    out_batch_dim = None

    def __init__(self, local_shape, gdim: int, name, mesh: MeshInfo,
                 pspec, dtype=torch.bfloat16):
        super().__init__()
        self.gdim = gdim
        self.mesh = mesh
        shape = list(local_shape)
        assert shape[gdim] % mesh.dp == 0, (name, local_shape, gdim, mesh.dp)
        shape[gdim] //= mesh.dp
        spec = list(tuple(pspec) + ((),) * (len(shape) - len(pspec)))
        spec[gdim] = tuple(spec[gdim]) + ("data",)
        self.w = make_param(tuple(shape), dtype, tuple(spec), mesh)
        self._full = tuple(local_shape)
        self.named(name)

    def kernel(self, p):
        return col.all_gather(p["w"], "data", dim=self.gdim)

    def infer_out(self, in_shapes):
        return TensorSpec(self._full, self.w.dtype)


class ExpertGEMMOp(Op):
    """Grouped expert FFN: (e_loc, n, d) -> (e_loc, n, d), through the
    grouped-FFN kernel (Comet's ``replace_func`` calls the same kernel on
    chunks of the buffer).  With ``owns_weight=False`` the three weights
    arrive as inputs (produced by ``ParamGatherOp``s under FSDP), so their
    gradient flows back through the gathers."""

    resource = "compute"
    out_batch_dim = VBATCH

    def __init__(self, d, m: MoEConfig, mesh: MeshInfo, name="expert_ffn",
                 dtype=torch.bfloat16, owns_weight=True):
        super().__init__()
        V, e_loc, es, ffs = moe_dims(m, mesh.tp)
        self._dims = (e_loc, d, ffs)
        if owns_weight:
            spec = (("model",), (), ())
            self.w1 = make_param((e_loc, d, ffs), dtype, spec, mesh)
            self.w3 = make_param((e_loc, d, ffs), dtype, spec, mesh)
            self.w2 = make_param((e_loc, ffs, d), dtype, spec, mesh)
        self.named(name)

    def kernel(self, p, buf, *ws):
        from ..kernels import ops as kops
        w1, w3, w2 = ws if ws else (p["w1"], p["w3"], p["w2"])
        return kops.grouped_ffn(buf, w1, w3, w2)

    def flops_estimate(self, in_shapes):
        e, n, d = in_shapes[0].shape
        _, _, ffs = self._dims
        return 6.0 * e * n * d * ffs

    def infer_out(self, in_shapes):
        return in_shapes[0]


class FFShardedExpertGEMM(Op):
    """Expert FFN with the hidden (ff) dim sharded over 'data': weights
    stay RESIDENT (no per-step ZeRO gather); each rank computes its ff
    slice's partial output through the grouped-FFN kernel, completed by
    the tiny activation psum after the combine.  SwiGLU is elementwise in
    ff, so the decomposition is exact.  This is the decode-path
    alternative to gather-based ZeRO: it trades 2·3·d·ff/layer of weight
    gather for B·d of activation psum."""

    resource = "compute"
    out_batch_dim = VBATCH

    def __init__(self, d, m: MoEConfig, mesh: MeshInfo,
                 name="expert_ffn_ffshard", dtype=torch.bfloat16):
        super().__init__()
        V, e_loc, es, ffs = moe_dims(m, mesh.tp)
        assert ffs % mesh.dp == 0, (ffs, mesh.dp)
        ff_loc = ffs // mesh.dp
        self._dims = (e_loc, d, ff_loc)
        self.w1 = make_param((e_loc, d, ff_loc), dtype,
                             (("model",), (), ("data",)), mesh)
        self.w3 = make_param((e_loc, d, ff_loc), dtype,
                             (("model",), (), ("data",)), mesh)
        self.w2 = make_param((e_loc, ff_loc, d), dtype,
                             (("model",), ("data",), ()), mesh)
        self.named(name)

    def kernel(self, p, buf):
        from ..kernels import ops as kops
        return kops.grouped_ffn(buf, p["w1"], p["w3"], p["w2"])

    def flops_estimate(self, in_shapes):
        e, n, d = in_shapes[0].shape
        _, _, ff_loc = self._dims
        return 6.0 * e * n * d * ff_loc

    def infer_out(self, in_shapes):
        return in_shapes[0]


class ExpertFFN(Module):
    """Expert GEMM, three storage modes (``mode``):
      resident        — weights sharded over 'model' only
      zero3 (gather)  — data-sharded + per-use all-gather (train/prefill
                        under FSDP; the gathers are schedulable network
                        ops)
      ff-sharded      — hidden dim sharded over 'data', partial outputs
                        (replicated/decode path; no gather at all)
    """

    def __init__(self, d, m: MoEConfig, mesh: MeshInfo, dtype=torch.bfloat16,
                 ff_shard: bool = False):
        super().__init__()
        V, e_loc, es, ffs = moe_dims(m, mesh.tp)
        if mesh.fsdp and ff_shard:
            self.mode = "ff_sharded"
            self.gemm = FFShardedExpertGEMM(d, m, mesh, dtype=dtype)
        elif mesh.fsdp:
            self.mode = "zero3"
            spec_df = (("model",), (), ())
            self.g1 = ParamGatherOp((e_loc, d, ffs), 2, "w1_gather", mesh,
                                    spec_df, dtype)
            self.g3 = ParamGatherOp((e_loc, d, ffs), 2, "w3_gather", mesh,
                                    spec_df, dtype)
            self.g2 = ParamGatherOp((e_loc, ffs, d), 1, "w2_gather", mesh,
                                    spec_df, dtype)
            self.gemm = ExpertGEMMOp(d, m, mesh, dtype=dtype,
                                     owns_weight=False)
        else:
            self.mode = "resident"
            self.gemm = ExpertGEMMOp(d, m, mesh, dtype=dtype)
        self.named("expert_ffn")

    def forward(self, buf):
        if self.mode == "zero3":
            return self.gemm(buf, self.g1(), self.g3(), self.g2())
        return self.gemm(buf)


class CombineOp(Op):
    """Un-permute expert outputs back to tokens and weighted-sum top-k."""

    resource = "memory"

    def __init__(self, name="moe_combine"):
        super().__init__()
        self.named(name)

    def kernel(self, p, buf, ve, slot, w):
        # buf (V,C,d); ve/slot/w (B,S,kv)
        V, C, d = buf.shape
        B, S, kv = ve.shape
        keep = slot >= 0
        flat = torch.where(keep, ve * C + torch.clamp(slot, min=0), 0)
        rows = buf.reshape(V * C, d).index_select(0, flat.reshape(-1).long())
        rows = rows.reshape(B, S, kv, d)
        wgt = (w * keep.to(w.dtype))[..., None].to(rows.dtype)
        return torch.sum(rows * wgt, dim=2)

    def infer_out(self, in_shapes):
        buf, ve, slot, w = in_shapes
        B, S, kv = ve.shape
        return TensorSpec((B, S, buf.shape[-1]), buf.dtype)


class ExpertSliceOp(Op):
    """Replicated mode: take this rank's local-expert rows of the
    (replicated) dispatch buffer — the zero-communication 'dispatch'."""

    resource = "memory"
    out_batch_dim = VBATCH

    def __init__(self, m: MoEConfig, mesh: MeshInfo, name="expert_slice"):
        super().__init__()
        self.V, self.e_loc, _, _ = moe_dims(m, mesh.tp)
        self.named(name)

    def kernel(self, p, buf):
        start = col.axis_index("model") * self.e_loc
        return buf.narrow(0, start, self.e_loc)

    def infer_out(self, in_shapes):
        s = list(in_shapes[0].shape)
        s[0] = self.e_loc
        return TensorSpec(tuple(s), in_shapes[0].dtype)


class CombinePartialOp(Op):
    """Replicated mode: weighted-sum only this rank's local experts'
    outputs; the trailing psum (network op) completes the token sum."""

    resource = "memory"

    def __init__(self, m: MoEConfig, mesh: MeshInfo, name="moe_combine"):
        super().__init__()
        self.V, self.e_loc, _, _ = moe_dims(m, mesh.tp)
        self.named(name)

    def kernel(self, p, buf, ve, slot, w):
        # buf (e_loc,C,d) local experts; ve/slot/w (B,S,kv) with global ve
        e_loc, C, d = buf.shape
        B, S, kv = ve.shape
        start = col.axis_index("model") * e_loc
        local = ve - start
        mine = (local >= 0) & (local < e_loc) & (slot >= 0)
        flat = torch.where(mine, torch.clamp(local, 0, e_loc - 1) * C
                           + torch.clamp(slot, min=0), 0)
        rows = buf.reshape(e_loc * C, d).index_select(
            0, flat.reshape(-1).long())
        rows = rows.reshape(B, S, kv, d)
        wgt = (w * mine.to(w.dtype))[..., None].to(rows.dtype)
        return torch.sum(rows * wgt, dim=2)

    def infer_out(self, in_shapes):
        buf, ve, slot, w = in_shapes
        B, S, kv = ve.shape
        return TensorSpec((B, S, buf.shape[-1]), buf.dtype)


class MoEBlock(Module):
    """Expert-parallel MoE over the 'model' axis, two layouts:

    * token_sharded (SP prefill): the block consumes the sequence-sharded
      activations directly — each rank routes and packs its OWN S/tp
      tokens, the dispatch/combine all-to-alls move real (distinct)
      tokens, and no collective follows the combine.
    * replicated (decode / non-SP): activations are replicated; dispatch
      is a local expert-slice (zero communication), each rank computes its
      e_loc experts over all tokens' capacity slots, the partial combine
      sums local experts only, and the trailing psum (a schedulable
      network op) completes it.

    Shared experts hold replicated weights and run on the block's local
    tokens (standard DeepSeek practice) — independent of the dispatch
    chain, which is what the paper's Fig. 1a overlap targets.
    """

    def __init__(self, cfg: ArchConfig, mesh: MeshInfo,
                 token_sharded: bool, name="moe"):
        super().__init__()
        m = cfg.moe
        d = cfg.d_model
        self.token_sharded = token_sharded
        self.router = RouterOp(d, m, mesh)
        self.build = DispatchBuildOp(m, mesh)
        if token_sharded:
            self.a2a_in = MoEAllToAllOp(mesh, "dispatch")
            self.a2a_out = MoEAllToAllOp(mesh, "combine")
            self.combine = CombineOp()
        else:
            self.slice_local = ExpertSliceOp(m, mesh)
            self.combine = CombinePartialOp(m, mesh)
            self.ar = PsumOp(name="ar_moe")
            if mesh.fsdp:
                # resident ff-sharded experts: the partial-ff outputs
                # complete in the (tiny) activation psum below
                self.ar_dp = PsumOp(axis="data", name="ar_moe_dp")
        self.experts = ExpertFFN(d, m, mesh, ff_shard=not token_sharded)
        self.has_shared = m.n_shared > 0
        if self.has_shared:
            # replicated weights, local tokens: no collective, overlappable
            self.shared = MLPBlock(d, m.d_ff_expert * m.n_shared,
                                   MeshInfo(tp=1, dp=mesh.dp, pods=mesh.pods),
                                   name="shared_expert")
            self.add_shared = AddOp("add_shared")
        self.named(name)

    def forward(self, x):
        w, ve = self.router(x)
        if self.token_sharded:
            with mark("moe_dispatch"):
                buf, slot = self.build(x, ve)
                buf = self.a2a_in(buf)
            eout = self.experts(buf)
            with mark("moe_combine"):
                eout = self.a2a_out(eout)
                y = self.combine(eout, ve, slot, w)
        else:
            with mark("moe_dispatch"):
                buf, slot = self.build(x, ve)
                buf = self.slice_local(buf)
            eout = self.experts(buf)
            with mark("moe_combine"):
                y = self.combine(eout, ve, slot, w)
                y = self.ar(y)
                if hasattr(self, "ar_dp"):
                    y = self.ar_dp(y)
        if self.has_shared:
            with mark("moe_shared"):
                ys = self.shared(x)
            y = self.add_shared(y, ys)
        return y


class MoEDecoderLayer(Module):
    """Decoder layer with MoE FFN (prefill; SP collectives)."""

    def __init__(self, cfg: ArchConfig, mesh: MeshInfo, sp: bool,
                 collect_kv=False):
        super().__init__()
        d = cfg.d_model
        lay = HeadLayout(cfg.n_heads, cfg.n_kv, mesh.tp, cfg.hd)
        self.lay = lay
        self.sp = sp
        self.collect_kv = collect_kv
        self.ln1 = RMSNormOp(d, "ln_attn")
        if sp:
            self.ag1 = AllGatherOp(mesh, dim=1, name="ag_attn")
            self.fin1 = ReduceScatterOp(mesh, dim=1, name="rs_attn")
        else:
            self.fin1 = PsumOp(name="ar_attn")
        self.qkv = QKVProj(d, lay, mesh)
        self.rope = RopeOp(cfg.rope, cfg.rope_kwargs())
        self.attn = AttentionOp(lay)
        self.oproj = OProj(d, lay, mesh)
        self.add1 = AddOp("add_attn")
        self.ln2 = RMSNormOp(d, "ln_moe")
        # SP: the MoE consumes the sequence-sharded activations directly
        # (EP == DP over the model axis); no gather/reduce around the block.
        self.moe = MoEBlock(cfg, mesh, token_sharded=sp)
        self.add2 = AddOp("add_moe")
        self.named("moe_layer")

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
        m = self.moe(h)
        x = self.add2(x, m)
        out = {"x": x}
        if self.collect_kv:
            out["k"], out["v"] = k, v
        return out


class MoEDecodeLayer(Module):
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
        self.ln2 = RMSNormOp(d, "ln_moe")
        self.moe = MoEBlock(cfg, mesh, token_sharded=False)
        self.add2 = AddOp("add_moe")
        self.named("moe_layer")

    def forward(self, *, x, positions, cache_len, k_cache, v_cache):
        h = self.ln1(x)
        q, k, v = self.qkv(h)
        q, k = self.rope(q, k, positions)
        a, kc, vc = self.attn(q, k, v, k_cache, v_cache, cache_len)
        a = self.oproj(a)
        a = self.fin1(a)
        x = self.add1(x, a)
        h = self.ln2(x)
        m = self.moe(h)
        x = self.add2(x, m)
        return {"x": x, "k_cache": kc, "v_cache": vc}


class MoELM(LMBase):
    """MoE LM over the shared segment machinery: an optional dense first
    layer (its own stack, ``dense0``, with its own decode caches) and a
    stack of MoE layers."""

    family = "moe"

    def __init__(self, cfg: ArchConfig, mesh: MeshInfo):
        super().__init__(cfg, mesh)
        self.layout = HeadLayout(cfg.n_heads, cfg.n_kv, mesh.tp, cfg.hd)

    def make_embed(self, phase):
        sp = self.cfg.seq_parallel and phase != "decode"
        return EmbedSegment(self.cfg, self.mesh, sp)

    def layer_stacks(self, phase):
        cfg, mesh = self.cfg, self.mesh
        prefill = phase == "prefill"     # train keeps no K/V
        stacks = []
        n_moe = cfg.n_layers
        if cfg.moe.first_layer_dense:
            n_moe -= 1
            if phase == "decode":
                dmod = DenseDecodeLayer(cfg, mesh)
                cmap = {"k_cache": "dense0_k_cache",
                        "v_cache": "dense0_v_cache"}
                stacks.append(("dense0", dmod, 1,
                               ("k_cache", "v_cache"), ("k_cache", "v_cache"),
                               {"input_map": dict(cmap),
                                "output_map": dict(cmap)}))
            else:
                dmod = DenseDecoderLayer(cfg, mesh, cfg.seq_parallel,
                                         collect_kv=prefill)
                omap = ({"k": "dense0.k", "v": "dense0.v"} if prefill
                        else {})
                stacks.append(("dense0", dmod, 1, (),
                               ("k", "v") if prefill else (),
                               {"output_map": omap}))
        if phase == "decode":
            mod = MoEDecodeLayer(cfg, mesh)
            stacks.append(("layers", mod, n_moe,
                           ("k_cache", "v_cache"), ("k_cache", "v_cache")))
        else:
            mod = MoEDecoderLayer(cfg, mesh, cfg.seq_parallel,
                                  collect_kv=prefill)
            stacks.append(("layers", mod, n_moe, (),
                           ("k", "v") if prefill else ()))
        return stacks

    def make_head(self, phase):
        sp = self.cfg.seq_parallel and phase != "decode"
        if phase == "train":
            return TrainHead(self.cfg, self.mesh, sp)
        return LogitsHead(self.cfg, self.mesh, sp,
                          keep_last=(phase != "decode"))

    def cache_specs(self, stack_name, B_loc, s_max):
        lay = self.layout
        spec = TensorSpec((B_loc, s_max, lay.kv_local, lay.head_dim),
                          torch.bfloat16)
        return {"k_cache": spec, "v_cache": spec}
