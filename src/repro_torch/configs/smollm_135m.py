"""smollm-135m — small dense llama-arch, 30L d_model=576 9H (GQA kv=3)
d_ff=1536 vocab=49152.  [hf:HuggingFaceTB/SmolLM-135M]"""
from . import register
from .base import ArchConfig


@register
def smollm_135m() -> ArchConfig:
    return ArchConfig(
        name="smollm-135m",
        family="dense",
        n_layers=30,
        d_model=576,
        n_heads=9,
        n_kv=3,
        d_ff=1536,
        vocab=49152,
        head_dim=64,
        rope="full",
        act="swiglu",
        tie_embeddings=True,
        seq_parallel=False,   # d_model=576 not divisible by TP*... keep simple
        source="hf:HuggingFaceTB/SmolLM-135M",
    )
