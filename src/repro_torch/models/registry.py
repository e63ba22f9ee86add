"""Model factory: ArchConfig.family -> LM implementation."""
from __future__ import annotations

from ..configs.base import ArchConfig
from .layers import MeshInfo


def build_model(cfg: ArchConfig, mesh: MeshInfo):
    from .hybrid import HybridLM
    from .mamba2 import Mamba2LM
    from .moe import MoELM
    from .transformer import DenseLM

    fam = {"dense": DenseLM, "moe": MoELM, "ssm": Mamba2LM,
           "hybrid": HybridLM}
    if cfg.family not in fam:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (have {sorted(fam)})")
    return fam[cfg.family](cfg, mesh)
