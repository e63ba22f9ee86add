"""qwen2-vl-7b — VLM; transformer BACKBONE only (ViT frontend stubbed:
input_specs provides precomputed patch embeddings).  28L d_model=3584 28H
(GQA kv=4) d_ff=18944 vocab=152064; M-RoPE.  [arXiv:2409.12191; hf]"""
from . import register
from .base import ArchConfig


@register
def qwen2_vl_7b() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-7b",
        family="vlm",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv=4,
        d_ff=18944,
        vocab=152064,
        rope="mrope",
        rope_kw=(("sections", (16, 24, 24)),),
        act="swiglu",
        fsdp_train=True,   # 7.6B: AdamW state > HBM at TP-only sharding
        source="arXiv:2409.12191; hf:Qwen/Qwen2-VL-7B-Instruct",
    )
