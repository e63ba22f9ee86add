"""Model factory: ArchConfig.family -> LM implementation."""
from __future__ import annotations

from ..configs.base import ArchConfig
from .layers import MeshInfo


def build_model(cfg: ArchConfig, mesh: MeshInfo):
    from .transformer import DenseLM

    fam = {"dense": DenseLM}
    if cfg.family not in fam:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (have {sorted(fam)})")
    return fam[cfg.family](cfg, mesh)
