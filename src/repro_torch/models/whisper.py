"""Whisper-tiny backbone: encoder-decoder transformer (the port of the JAX
package's ``models/whisper.py``).

The conv/audio frontend is a stub, as in the JAX package: ``frames``
arrive as precomputed (B, S, d_model) frame embeddings.  Encoder = a
bidirectional self-attention stack; decoder = causal self-attention +
cross-attention over the encoder states + a GELU MLP.  Positions are
sinusoidal in both stacks (the JAX package's choice: it keeps the params
independent of the sequence length).

Decode: self-attention reads a KV cache; cross-attention recomputes K/V
from the (static) encoder states ``enc`` at every step and attends to
all of its ``s_max`` rows, with no length mask — both as the JAX package
does.  ``enc`` is a step input of shape (B, s_max, d_model).
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ArchConfig
from ..core import trace
from ..core.module import Module, Op, TensorSpec
from .base import LMBase, LogitsHead, Segment, TrainHead
from .layers import (AddOp, AttentionOp, DecodeAttentionOp, EmbedOp,
                     HeadLayout, MeshInfo, MLPBlock, OProj, PsumOp, QKVProj,
                     RMSNormOp, ShardedLinear)

I32, BF16 = torch.int32, torch.bfloat16


def _sinusoid(positions, d):
    """Sinusoidal absolute position encoding: positions (B,S) -> (B,S,d)
    f32, ``[sin, cos]`` halves."""
    half = d // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                     / max(half - 1, 1))
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


class SinPosOp(Op):
    """x + sinusoidal(position) (memory-bound)."""

    resource = "memory"

    def __init__(self, name="sinpos"):
        super().__init__()
        self.named(name)

    def kernel(self, p, x, positions):
        return x + _sinusoid(positions, x.shape[-1]).to(x.dtype)


class EncPosOp(Op):
    """x + sinusoidal(arange(S)) for the encoder (no positions input)."""

    resource = "memory"

    def __init__(self, name="enc_pos"):
        super().__init__()
        self.named(name)

    def kernel(self, p, x):
        B, S, d = x.shape
        pos = torch.arange(S, dtype=I32, device=x.device)[None, :]
        return x + _sinusoid(pos, d).to(x.dtype)


class CrossKVProj(Module):
    """K/V projection of the encoder states for cross-attention."""

    def __init__(self, d, layout: HeadLayout, mesh: MeshInfo, name="cross_kv",
                 dtype=BF16):
        super().__init__()
        out = 2 * layout.kv_local * layout.head_dim
        self.proj = ShardedLinear(d, out, "kv_proj", mesh, dtype=dtype)
        self.split = _KVSplit(layout).named("kv_split")
        self.named(name)

    def forward(self, enc):
        return self.split(self.proj(enc))


class _KVSplit(Op):
    """Views of k and v inside the projection's output (no copy)."""

    resource = "memory"

    def __init__(self, lay: HeadLayout):
        super().__init__()
        self.lay = lay

    def kernel(self, p, kv):
        lay = self.lay
        hd = lay.head_dim
        B, S, _ = kv.shape
        nk = lay.kv_local * hd
        k = kv[..., :nk].reshape(B, S, lay.kv_local, hd)
        v = kv[..., nk:].reshape(B, S, lay.kv_local, hd)
        return k, v


class QOnlyProj(Module):
    """Q projection for cross-attention (decoder side)."""

    def __init__(self, d, layout: HeadLayout, mesh: MeshInfo, name="cross_q",
                 dtype=BF16):
        super().__init__()
        self.lay = layout
        self.proj = ShardedLinear(d, layout.q_local * layout.head_dim,
                                  "q_proj", mesh, dtype=dtype)
        self.split = _QReshape(layout).named("q_reshape")
        self.named(name)

    def forward(self, x):
        return self.split(self.proj(x))


class _QReshape(Op):
    resource = "memory"

    def __init__(self, lay: HeadLayout):
        super().__init__()
        self.lay = lay

    def kernel(self, p, q):
        B, S, _ = q.shape
        return q.reshape(B, S, self.lay.q_local, self.lay.head_dim)


def _layout(cfg: ArchConfig, mesh: MeshInfo) -> HeadLayout:
    return HeadLayout(cfg.n_heads, cfg.n_kv, mesh.tp, cfg.hd)


class WhisperEncoderLayer(Module):
    """Bidirectional self-attention + GELU MLP (pre-norm)."""

    def __init__(self, cfg: ArchConfig, mesh: MeshInfo):
        super().__init__()
        d = cfg.d_model
        lay = _layout(cfg, mesh)
        self.ln1 = RMSNormOp(d, "ln_attn")
        self.qkv = QKVProj(d, lay, mesh)
        self.attn = AttentionOp(lay, causal=False)
        self.oproj = OProj(d, lay, mesh)
        self.ar1 = PsumOp(name="ar_attn")
        self.add1 = AddOp("add_attn")
        self.ln2 = RMSNormOp(d, "ln_mlp")
        self.mlp = MLPBlock(d, cfg.d_ff, mesh, act="gelu")
        self.ar2 = PsumOp(name="ar_mlp")
        self.add2 = AddOp("add_mlp")
        self.named("enc_layer")

    def forward(self, *, x):
        h = self.ln1(x)
        q, k, v = self.qkv(h)
        a = self.oproj(self.attn(q, k, v))
        x = self.add1(x, self.ar1(a))
        m = self.mlp(self.ln2(x))
        x = self.add2(x, self.ar2(m))
        return {"x": x}


class _CrossBlock(Module):
    """The decoder layer's cross-attention and MLP halves, shared by the
    prefill/train and decode layers (attributes on the layer itself, so
    the op names and the param tree are the JAX package's)."""

    def _build_cross(self, cfg: ArchConfig, mesh: MeshInfo, lay: HeadLayout):
        d = cfg.d_model
        self.ln2 = RMSNormOp(d, "ln_cross")
        self.q_proj = QOnlyProj(d, lay, mesh)
        self.kv_proj = CrossKVProj(d, lay, mesh)
        self.xattn = AttentionOp(lay, causal=False, name="cross_attention")
        self.xoproj = OProj(d, lay, mesh, name="x_o_proj")
        self.ar2 = PsumOp(name="ar_cross")
        self.add2 = AddOp("add_cross")
        self.ln3 = RMSNormOp(d, "ln_mlp")
        self.mlp = MLPBlock(d, cfg.d_ff, mesh, act="gelu")
        self.ar3 = PsumOp(name="ar_mlp")
        self.add3 = AddOp("add_mlp")

    def _cross(self, x, enc):
        qx = self.q_proj(self.ln2(x))
        kx, vx = self.kv_proj(enc)
        a = self.xoproj(self.xattn(qx, kx, vx))
        x = self.add2(x, self.ar2(a))
        m = self.mlp(self.ln3(x))
        return self.add3(x, self.ar3(m))


class WhisperDecoderLayer(_CrossBlock):
    """Causal self-attn + cross-attn(enc) + GELU MLP (train/prefill)."""

    def __init__(self, cfg: ArchConfig, mesh: MeshInfo, collect_kv=False):
        super().__init__()
        d = cfg.d_model
        lay = _layout(cfg, mesh)
        self.collect_kv = collect_kv
        self.ln1 = RMSNormOp(d, "ln_self")
        self.qkv = QKVProj(d, lay, mesh)
        self.attn = AttentionOp(lay, causal=True, name="self_attention")
        self.oproj = OProj(d, lay, mesh)
        self.ar1 = PsumOp(name="ar_self")
        self.add1 = AddOp("add_self")
        self._build_cross(cfg, mesh, lay)
        self.named("dec_layer")

    def forward(self, *, x, enc):
        q, k, v = self.qkv(self.ln1(x))
        a = self.oproj(self.attn(q, k, v))
        x = self.add1(x, self.ar1(a))
        out = {"x": self._cross(x, enc)}
        if self.collect_kv:
            out["k"], out["v"] = k, v
        return out


class WhisperDecodeLayer(_CrossBlock):
    """Decode: self-attn against the KV cache + cross-attn over ``enc``."""

    def __init__(self, cfg: ArchConfig, mesh: MeshInfo):
        super().__init__()
        d = cfg.d_model
        lay = _layout(cfg, mesh)
        self.ln1 = RMSNormOp(d, "ln_self")
        self.qkv = QKVProj(d, lay, mesh)
        self.attn = DecodeAttentionOp(lay)
        self.oproj = OProj(d, lay, mesh)
        self.ar1 = PsumOp(name="ar_self")
        self.add1 = AddOp("add_self")
        self._build_cross(cfg, mesh, lay)
        self.named("dec_layer")

    def forward(self, *, x, enc, cache_len, k_cache, v_cache):
        q, k, v = self.qkv(self.ln1(x))
        a, kc, vc = self.attn(q, k, v, k_cache, v_cache, cache_len)
        x = self.add1(x, self.ar1(self.oproj(a)))
        return {"x": self._cross(x, enc), "k_cache": kc, "v_cache": vc}


class WhisperEncEmbed(Module):
    """Stub frontend output -> encoder input (adds sinusoidal positions)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.pos = EncPosOp()
        self.named("enc_embed")

    def forward(self, *, frames):
        return {"x": self.pos(frames)}


class WhisperDecEmbed(Module):
    def __init__(self, cfg: ArchConfig, mesh: MeshInfo):
        super().__init__()
        self.emb = EmbedOp(cfg.vocab, cfg.d_model, mesh)
        self.finish = PsumOp(name="embed_ar")
        self.pos = SinPosOp()
        self.named("embed")

    def forward(self, *, ids, positions):
        return {"x": self.pos(self.finish(self.emb(ids)), positions)}


class WhisperLM(LMBase):
    """Segments: ``enc_embed`` -> ``encoder`` (x ``enc_layers``) ->
    ``embed`` -> ``decoder`` (x ``n_layers``) -> ``head``; decode has no
    encoder segments and takes ``enc`` as an input.  Prefill's encoder
    runs at the decoder's length (``S_enc = S``)."""

    family = "encdec"

    def __init__(self, cfg: ArchConfig, mesh: MeshInfo):
        super().__init__(cfg, mesh)
        self.layout = _layout(cfg, mesh)

    # -- inputs ---------------------------------------------------------------
    def batch_inputs(self, phase, B_loc, S, s_max=0):
        d = self.cfg.d_model
        tok = (TensorSpec((B_loc, S), I32), 0)
        frames = (TensorSpec((B_loc, S, d), BF16), 0)
        if phase == "train":
            return {"frames": frames, "ids": tok, "labels": tok,
                    "positions": tok}
        if phase == "prefill":
            return {"frames": frames, "ids": tok, "positions": tok}
        if phase != "decode":
            raise NotImplementedError(f"phase {phase!r} is not ported yet")
        one = (TensorSpec((B_loc, 1), I32), 0)
        return {"ids": one, "positions": one,
                "cache_len": (TensorSpec((B_loc,), I32), 0),
                "enc": (TensorSpec((B_loc, s_max, d), BF16), 0)}

    def cache_specs(self, stack_name, B_loc, s_max):
        lay = self.layout
        spec = TensorSpec((B_loc, s_max, lay.kv_local, lay.head_dim), BF16)
        return {"k_cache": spec, "v_cache": spec}

    def decode_cache_env(self, B_loc, s_max):
        n = self.cfg.n_layers
        return {k: TensorSpec((n,) + tuple(v.shape), v.dtype)
                for k, v in self.cache_specs("decoder", B_loc, s_max).items()}

    def decode_cache_layout(self):
        return {"k_cache": (1, -2), "v_cache": (1, -2)}

    # -- segments (the encoder stack precedes the decoder) -----------------
    def build_segments(self, phase, B_loc, S, s_max=0):
        cfg, mesh = self.cfg, self.mesh
        binputs = self.batch_inputs(phase, B_loc, S, s_max)
        segs = []
        if phase != "decode":
            ee = WhisperEncEmbed(cfg)
            g = trace(ee, {"frames": binputs["frames"][0]},
                      batch_dims={"frames": 0})
            segs.append(Segment("enc_embed", ee, g, output_map={"x": "enc"}))
            enc_mod = WhisperEncoderLayer(cfg, mesh)
            x_enc = TensorSpec((B_loc, S, cfg.d_model), BF16)
            g = trace(enc_mod, {"x": x_enc}, batch_dims={"x": 0})
            segs.append(Segment("encoder", enc_mod, g, count=cfg.enc_layers,
                                input_map={"x": "enc"},
                                output_map={"x": "enc"}))
        de = WhisperDecEmbed(cfg, mesh)
        g = trace(de, {"ids": binputs["ids"][0],
                       "positions": binputs["positions"][0]},
                  batch_dims={"ids": 0, "positions": 0})
        segs.append(Segment("embed", de, g))
        S_dec = 1 if phase == "decode" else S
        S_enc = s_max if phase == "decode" else S
        x_spec = TensorSpec((B_loc, S_dec, cfg.d_model), BF16)
        enc_spec = TensorSpec((B_loc, S_enc, cfg.d_model), BF16)
        if phase == "decode":
            dmod = WhisperDecodeLayer(cfg, mesh)
            lay_in = {"x": x_spec, "enc": enc_spec,
                      "cache_len": binputs["cache_len"][0]}
            lay_in.update(self.cache_specs("decoder", B_loc, s_max))
            g = trace(dmod, lay_in, batch_dims={k: 0 for k in lay_in})
            segs.append(Segment("decoder", dmod, g, count=cfg.n_layers,
                                scan_inputs=("k_cache", "v_cache"),
                                scan_outputs=("k_cache", "v_cache")))
        else:
            prefill = phase == "prefill"
            dmod = WhisperDecoderLayer(cfg, mesh, collect_kv=prefill)
            g = trace(dmod, {"x": x_spec, "enc": enc_spec},
                      batch_dims={"x": 0, "enc": 0})
            segs.append(Segment("decoder", dmod, g, count=cfg.n_layers,
                                scan_outputs=("k", "v") if prefill else ()))
        head = (TrainHead(cfg, mesh, sp=False) if phase == "train"
                else LogitsHead(cfg, mesh, sp=False,
                                keep_last=(phase != "decode")))
        head_in, hbd = {"x": x_spec}, {"x": 0}
        if phase == "train":
            head_in["labels"] = binputs["labels"][0]
            hbd["labels"] = 0
        g = trace(head, head_in, batch_dims=hbd)
        segs.append(Segment("head", head, g))
        return segs, binputs
