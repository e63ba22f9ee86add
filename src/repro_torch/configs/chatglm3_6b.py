"""chatglm3-6b — dense, 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024, RoPE 2d (partial rotation), GQA.  [arXiv:2406.12793; hf]"""
from . import register
from .base import ArchConfig


@register
def chatglm3_6b() -> ArchConfig:
    return ArchConfig(
        name="chatglm3-6b",
        family="dense",
        n_layers=28,
        d_model=4096,
        n_heads=32,
        n_kv=2,
        d_ff=13696,
        vocab=65024,
        rope="partial2d",
        rope_kw=(("fraction", 0.5),),
        act="swiglu",
        fsdp_train=True,   # AdamW state > HBM at TP-only sharding
        source="arXiv:2406.12793; hf:THUDM/chatglm3-6b",
    )
