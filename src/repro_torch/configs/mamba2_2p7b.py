"""mamba2-2.7b — attention-free SSM (SSD), 64L d_model=2560 vocab=50280,
ssm_state=128.  [arXiv:2405.21060; unverified]"""
from . import register
from .base import ArchConfig, SSMConfig


@register
def mamba2_2p7b() -> ArchConfig:
    return ArchConfig(
        name="mamba2-2.7b",
        family="ssm",
        n_layers=64,
        d_model=2560,
        n_heads=0,          # attention-free
        n_kv=0,
        d_ff=0,
        vocab=50280,
        head_dim=64,        # SSM head dim P
        rope="none",
        ssm=SSMConfig(state=128, head_dim=64, expand=2, conv_width=4,
                      chunk=128, n_groups=1),
        tie_embeddings=True,
        seq_parallel=False,
        subquadratic=True,   # O(1)-state decode => long_500k runs
        source="arXiv:2405.21060; hf:state-spaces/mamba2-2.7b (unverified)",
    )
