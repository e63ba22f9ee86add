"""deepseek-moe-16b — fine-grained MoE, 28L d_model=2048 16H (kv=16)
d_ff_expert=1408 vocab=102400; 2 shared + 64 routed top-6; first layer
dense.  [arXiv:2401.06066; hf]"""
from . import register
from .base import ArchConfig, MoEConfig


@register
def deepseek_moe_16b() -> ArchConfig:
    return ArchConfig(
        name="deepseek-moe-16b",
        family="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv=16,
        d_ff=10944,                 # dense first-layer FFN width
        vocab=102400,
        rope="full",
        act="swiglu",
        moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                      capacity_factor=1.25, first_layer_dense=True),
        fsdp_train=True,   # 10 GiB/chip of AdamW state at TP-only sharding
        source="arXiv:2401.06066; hf:deepseek-ai/deepseek-moe-16b-base",
    )
