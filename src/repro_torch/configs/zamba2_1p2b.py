"""zamba2-1.2b — hybrid: Mamba2 backbone + shared attention block, 38L
d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64.
[arXiv:2411.15242; hf]"""
from . import register
from .base import ArchConfig, SSMConfig


@register
def zamba2_1p2b() -> ArchConfig:
    return ArchConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv=32,
        d_ff=8192,
        vocab=32000,
        head_dim=128,        # shared attn block runs at 2*d_model = 4096
        rope="full",
        ssm=SSMConfig(state=64, head_dim=64, expand=2, conv_width=4,
                      chunk=128, n_groups=1, attn_every=6),
        tie_embeddings=True,
        seq_parallel=False,
        subquadratic=True,   # SSM backbone; shared-attn KV grows but state O(1)
        source="arXiv:2411.15242; hf:Zyphra/Zamba2-1.2B",
    )
