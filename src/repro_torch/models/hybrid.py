"""Zamba2-style hybrid: Mamba2 backbone + one *shared* attention block
applied every ``attn_every`` SSM layers.

The shared block (per the Zamba2 paper) runs at width 2·d_model on
``concat(hidden, original_embedding)`` and its weights are re-used at every
application (LoRA per-invocation adapters omitted, as in the JAX
package).  Each invocation still keeps its own KV cache at decode time.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..core.module import Module, Op, TensorSpec
from .base import EmbedSegment, LMBase, LogitsHead, TrainHead
from .layers import (AddOp, AttentionOp, DecodeAttentionOp, HeadLayout,
                     MeshInfo, MLPBlock, OProj, PsumOp, QKVProj, RMSNormOp,
                     RopeOp, ShardedLinear)
from .mamba2 import Mamba2DecodeLayer, Mamba2Layer, mamba_cache_specs


class ConcatOp(Op):
    resource = "memory"

    def __init__(self, name="concat_h_x0"):
        super().__init__()
        self.named(name)

    def kernel(self, p, a, b):
        return torch.cat([a, b], dim=-1)


class SharedAttnBlock(Module):
    """Shared transformer block at width D2 = 2*d_model."""

    def __init__(self, cfg: ArchConfig, mesh: MeshInfo, decode: bool = False):
        super().__init__()
        d2 = 2 * cfg.d_model
        lay = HeadLayout(cfg.n_heads, cfg.n_kv, mesh.tp, cfg.hd)
        self.lay = lay
        self.decode = decode
        self.concat = ConcatOp()
        self.ln1 = RMSNormOp(d2, "ln_attn")
        self.qkv = QKVProj(d2, lay, mesh)
        self.rope = RopeOp(cfg.rope, cfg.rope_kwargs())
        self.attn = DecodeAttentionOp(lay) if decode else AttentionOp(lay)
        self.oproj = OProj(d2, lay, mesh)
        self.ar1 = PsumOp(name="ar_attn")
        self.add1 = AddOp("add_attn")
        self.ln2 = RMSNormOp(d2, "ln_mlp")
        self.mlp = MLPBlock(d2, cfg.d_ff, mesh, act=cfg.act)
        self.ar2 = PsumOp(name="ar_mlp")
        self.add2 = AddOp("add_mlp")
        self.down = ShardedLinear(d2, cfg.d_model, "down_proj", mesh,
                                  pspec=(("model",), ()))
        self.ar3 = PsumOp(name="ar_down")
        self.add3 = AddOp("add_shared")
        self.named("shared_attn")

    def forward(self, *, x, x0, positions, cache_len=None, k_cache=None,
                v_cache=None):
        h = self.concat(x, x0)
        a = self.ln1(h)
        q, k, v = self.qkv(a)
        q, k = self.rope(q, k, positions)
        out = {}
        if self.decode:
            a, kc, vc = self.attn(q, k, v, k_cache, v_cache, cache_len)
            out["k_cache"], out["v_cache"] = kc, vc
        else:
            a = self.attn(q, k, v)
        a = self.oproj(a)
        a = self.ar1(a)
        h = self.add1(h, a)
        m = self.ln2(h)
        m = self.mlp(m)
        m = self.ar2(m)
        h = self.add2(h, m)
        y = self.down(h)
        y = self.ar3(y)
        out["x"] = self.add3(x, y)
        return out


class HybridEmbed(EmbedSegment):
    def forward(self, *, ids):
        h = self.finish(self.emb(ids))
        return {"x": h, "x0": h}


class HybridLM(LMBase):
    """Groups of ``attn_every`` Mamba2 layers, each followed by the shared
    attention block (one set of weights, segment ``uid`` shared_attn@i),
    then the trailing Mamba2 layers.  Prefill collects no state, so
    decode starts from the cache rows as they are (no prefill -> decode
    handoff, as in the JAX package).

    Training builds the prefill's segments: the Mamba2 stacks (their scan
    differentiated by ``SSDScan``, ``models/mamba2.py``) and the shared
    block at every use, its attention through ``FlashAttention`` and its
    norms through the norm Functions (TokenWeave's fused add+RMSNorm where
    the strategy fuses).  The shared block is one params subtree that
    every use reads, so autograd sums its uses' gradients, as the
    reference's autodiff does."""

    family = "hybrid"

    def __init__(self, cfg: ArchConfig, mesh: MeshInfo):
        super().__init__(cfg, mesh)
        self.layout = HeadLayout(cfg.n_heads, cfg.n_kv, mesh.tp, cfg.hd)
        k = cfg.ssm.attn_every
        self.n_groups = cfg.n_layers // k if k else 0
        self.per_group = k
        self.trailing = cfg.n_layers - self.n_groups * k

    def make_embed(self, phase):
        return HybridEmbed(self.cfg, self.mesh, sp=False)

    def layer_stacks(self, phase):
        cfg, mesh = self.cfg, self.mesh
        decode = phase == "decode"
        mcaches = (("conv_state", "ssm_state") if decode else ())
        stacks = []
        for gi in range(self.n_groups):
            mmod = (Mamba2DecodeLayer(cfg, mesh) if decode
                    else Mamba2Layer(cfg, mesh))
            mopts = {}
            if decode:
                mopts["input_map"] = {
                    "conv_state": f"mamba_g{gi}.conv_state",
                    "ssm_state": f"mamba_g{gi}.ssm_state"}
            stacks.append((f"mamba_g{gi}", mmod, self.per_group,
                           mcaches, mcaches, mopts))
            amod = SharedAttnBlock(cfg, mesh, decode=decode)
            opts = {"uid": f"shared_attn@{gi}"}
            if decode:
                opts["input_map"] = {"k_cache": f"attn{gi}_k_cache",
                                     "v_cache": f"attn{gi}_v_cache"}
                opts["output_map"] = {"k_cache": f"attn{gi}_k_cache",
                                      "v_cache": f"attn{gi}_v_cache"}
            stacks.append(("shared_attn", amod, 1, (), (), opts))
        if self.trailing:
            mmod = (Mamba2DecodeLayer(cfg, mesh) if decode
                    else Mamba2Layer(cfg, mesh))
            mopts = {}
            if decode:
                mopts["input_map"] = {"conv_state": "mamba_tail.conv_state",
                                      "ssm_state": "mamba_tail.ssm_state"}
            stacks.append(("mamba_tail", mmod, self.trailing,
                           mcaches, mcaches, mopts))
        return stacks

    def make_head(self, phase):
        if phase == "train":
            return TrainHead(self.cfg, self.mesh, sp=False)
        return LogitsHead(self.cfg, self.mesh, sp=False,
                          keep_last=(phase != "decode"))

    def cache_specs(self, stack_name, B_loc, s_max):
        if stack_name.startswith("mamba"):
            return mamba_cache_specs(self.cfg, self.mesh, B_loc)
        lay = self.layout
        spec = TensorSpec((B_loc, s_max, lay.kv_local, lay.head_dim),
                          torch.bfloat16)
        return {"k_cache": spec, "v_cache": spec}

    def seq_local(self, phase, S):
        return S  # sequence replicated (SSD scan)

    def decode_cache_layout(self):
        out = {}
        for gi in range(self.n_groups):
            out[f"mamba_g{gi}.conv_state"] = (1, -1)
            out[f"mamba_g{gi}.ssm_state"] = (1, -3)
            out[f"attn{gi}_k_cache"] = (0, -2)
            out[f"attn{gi}_v_cache"] = (0, -2)
        if self.trailing:
            out["mamba_tail.conv_state"] = (1, -1)
            out["mamba_tail.ssm_state"] = (1, -3)
        return out

    def decode_cache_env(self, B_loc, s_max):
        """env-key -> TensorSpec for all decode caches."""
        out = {}
        m = self.cache_specs("mamba_g0", B_loc, s_max)
        for gi in range(self.n_groups):
            for k, v in m.items():
                out[f"mamba_g{gi}.{k}"] = TensorSpec(
                    (self.per_group,) + v.shape, v.dtype)
            a = self.cache_specs("shared_attn", B_loc, s_max)
            out[f"attn{gi}_k_cache"] = a["k_cache"]
            out[f"attn{gi}_v_cache"] = a["v_cache"]
        if self.trailing:
            for k, v in m.items():
                out[f"mamba_tail.{k}"] = TensorSpec(
                    (self.trailing,) + v.shape, v.dtype)
        return out
