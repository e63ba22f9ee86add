"""whisper-tiny — encoder-decoder audio transformer backbone, 4L (enc+dec)
d_model=384 6H d_ff=1536 vocab=51865; conv frontend STUBBED (input_specs
provides precomputed frame embeddings).  [arXiv:2212.04356; unverified]"""
from . import register
from .base import ArchConfig


@register
def whisper_tiny() -> ArchConfig:
    return ArchConfig(
        name="whisper-tiny",
        family="encdec",
        n_layers=4,          # decoder layers
        enc_layers=4,        # encoder layers
        d_model=384,
        n_heads=6,
        n_kv=6,
        d_ff=1536,
        vocab=51865,
        rope="none",         # whisper uses learned/sinusoidal abs positions
        act="gelu",
        tie_embeddings=True,
        seq_parallel=False,  # d_model=384: TP=16 gives 24-wide shards; no SP
        source="arXiv:2212.04356; hf:openai/whisper-tiny (unverified)",
    )
