"""minitron-8b — pruned nemotron dense, 32L d_model=4096 32H (GQA kv=8)
d_ff=16384 vocab=256000.  [arXiv:2407.14679; hf]"""
from . import register
from .base import ArchConfig


@register
def minitron_8b() -> ArchConfig:
    return ArchConfig(
        name="minitron-8b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv=8,
        d_ff=16384,
        vocab=256000,
        rope="full",
        act="swiglu",   # published uses squared-relu; swiglu width matches d_ff
        fsdp_train=True,   # 8B + 256k vocab: AdamW state > HBM at TP-only
        source="arXiv:2407.14679; hf:nvidia/Minitron-8B-Base",
    )
