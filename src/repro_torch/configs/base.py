"""Architecture + shape configuration dataclasses."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int          # routed experts
    top_k: int
    d_ff_expert: int        # per-expert FFN width
    n_shared: int = 0       # shared experts (always-on)
    capacity_factor: float = 1.25
    first_layer_dense: bool = False   # deepseek-moe style


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state: int = 128        # N, SSM state size
    head_dim: int = 64      # P
    expand: int = 2         # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 128        # SSD chunk length
    n_groups: int = 1
    attn_every: int = 0     # hybrid: shared attn block every k ssm layers


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str             # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None     # default d_model // n_heads
    rope: str = "full"                 # full | partial2d | mrope | none
    rope_kw: tuple = ()                # frozen kv pairs
    act: str = "swiglu"
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    tie_embeddings: bool = False
    seq_parallel: bool = True          # SP for train/prefill sections
    fsdp_train: bool = False           # ZeRO-3 sharding for train
    fsdp_serve: bool = False           # ZeRO-3 weight sharding for serving
    enc_layers: int = 0                # encdec: encoder layer count
    source: str = ""
    subquadratic: bool = False         # supports long_500k decode

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def rope_kwargs(self) -> dict:
        return dict(self.rope_kw)

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        moe = None
        if self.moe:
            moe = MoEConfig(n_experts=4, top_k=2, d_ff_expert=32,
                            n_shared=min(self.moe.n_shared, 1),
                            capacity_factor=2.0,
                            first_layer_dense=self.moe.first_layer_dense)
        ssm = None
        if self.ssm:
            ssm = SSMConfig(state=16, head_dim=8, expand=2, conv_width=4,
                            chunk=8,
                            attn_every=2 if self.ssm.attn_every else 0)
        rope_kw = self.rope_kw
        if self.rope == "mrope":
            rope_kw = (("sections", (2, 1, 1)),)   # sums to head_dim//2 = 4
        return dataclasses.replace(
            self, name=self.name + "-smoke",
            n_layers=2 if not self.ssm else 4,
            d_model=32, n_heads=4, n_kv=min(self.n_kv, 2), d_ff=64,
            vocab=128, head_dim=8, moe=moe, ssm=ssm, rope_kw=rope_kw,
            enc_layers=min(self.enc_layers, 2), fsdp_train=False)

    # -- parameter count (for MODEL_FLOPS = 6 N D roofline term) -----------
    def param_count(self) -> tuple[int, int]:
        """(total, active) parameter counts (embedding included)."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        hd = self.hd
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family in ("ssm", "hybrid"):
            s = self.ssm
            d_in = s.expand * d
            conv_ch = d_in + 2 * s.n_groups * s.state
            nheads = d_in // s.head_dim
            per = (d * (2 * d_in + 2 * s.n_groups * s.state + nheads)  # in_proj
                   + conv_ch * s.conv_width
                   + d_in * d                                          # out_proj
                   + 2 * nheads + d)                                   # A, D, norm
            tot = L * per + emb
            if s.attn_every:
                attn_blk = (2 * d) * d * 4 + (2 * d) * self.d_ff * 3 + 2 * d
                tot += attn_blk  # shared (reused) block counted once
            return tot, tot
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv * hd) \
            + (self.n_heads * hd) * d
        if self.moe:
            m = self.moe
            expert = 3 * d * m.d_ff_expert
            shared = 3 * d * (m.d_ff_expert * m.n_shared)
            router = d * m.n_experts
            per_total = attn + m.n_experts * expert + shared + router + 2 * d
            per_active = attn + m.top_k * expert + shared + router + 2 * d
            n_moe = L - (1 if m.first_layer_dense else 0)
            n_dense = L - n_moe
            dense_l = attn + 3 * d * self.d_ff + 2 * d if n_dense else 0
            return (n_moe * per_total + n_dense * dense_l + emb,
                    n_moe * per_active + n_dense * dense_l + emb)
        ff_mult = 3 if self.act == "swiglu" else 2
        per = attn + ff_mult * d * self.d_ff + 2 * d
        tot = (L + self.enc_layers) * per + emb
        if self.enc_layers:  # cross-attn adds another attn block per dec layer
            tot += L * attn
        return tot, tot


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # train | prefill | decode

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
