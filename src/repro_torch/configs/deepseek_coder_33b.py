"""deepseek-coder-33b — dense llama-arch, 62L d_model=7168 56H (GQA kv=8)
d_ff=19200 vocab=32256.  [arXiv:2401.14196; hf]"""
from . import register
from .base import ArchConfig


@register
def deepseek_coder_33b() -> ArchConfig:
    return ArchConfig(
        name="deepseek-coder-33b",
        family="dense",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv=8,
        d_ff=19200,
        vocab=32256,
        rope="full",
        act="swiglu",
        fsdp_train=True,   # 33B does not fit unsharded per-chip at TP=16
        source="arXiv:2401.14196; hf:deepseek-ai/deepseek-coder-33b-base",
    )
