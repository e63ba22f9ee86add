"""grok-1-314b — MoE, 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072; 8 experts top-2.  [hf:xai-org/grok-1; unverified]"""
from . import register
from .base import ArchConfig, MoEConfig


@register
def grok1_314b() -> ArchConfig:
    return ArchConfig(
        name="grok-1-314b",
        family="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv=8,
        d_ff=32768,
        vocab=131072,
        rope="full",
        act="gelu",
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32768, n_shared=0,
                      capacity_factor=1.25),
        fsdp_train=True,   # 314B params require ZeRO-3 over data axis
        fsdp_serve=True,   # 628 GB of bf16 weights > 16 pod-row HBMs: gather per layer
        source="hf:xai-org/grok-1 (unverified)",
    )
