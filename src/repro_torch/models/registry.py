"""Model factory: ArchConfig.family -> LM implementation."""
from __future__ import annotations

from ..configs.base import ArchConfig
from .layers import MeshInfo


def build_model(cfg: ArchConfig, mesh: MeshInfo):
    from .hybrid import HybridLM
    from .mamba2 import Mamba2LM
    from .moe import MoELM
    from .transformer import DenseLM
    from .vlm import VLM
    from .whisper import WhisperLM

    fam = {"dense": DenseLM, "moe": MoELM, "ssm": Mamba2LM,
           "hybrid": HybridLM, "encdec": WhisperLM, "vlm": VLM}
    if cfg.family not in fam:
        raise KeyError(f"unknown family {cfg.family!r}")
    return fam[cfg.family](cfg, mesh)
