"""Qwen2-VL backbone (M-RoPE dense LM).  The ViT frontend is a stub, as in
the JAX package: ``vis`` arrives as precomputed patch embeddings already
aligned to the token sequence (zero at pure-text positions) and is added
to the token embedding.  The M-RoPE position streams (3, B, S) are a
model input (the t/h/w positions the preprocessing computes)."""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..core.module import TensorSpec
from .base import EmbedSegment
from .layers import AddOp, MeshInfo
from .transformer import DenseLM


class VLMEmbedSegment(EmbedSegment):
    """Token embedding + precomputed patch embeddings (stub frontend).

    Under sequence parallelism the patch embeddings arrive
    sequence-sharded, matching the reduce-scattered token path."""

    def __init__(self, cfg: ArchConfig, mesh: MeshInfo, sp: bool):
        super().__init__(cfg, mesh, sp)
        self.add_vis = AddOp("add_vis")

    def forward(self, *, ids, vis):
        return {"x": self.add_vis(self.finish(self.emb(ids)), vis)}


class VLM(DenseLM):
    family = "vlm"

    def make_embed(self, phase):
        sp = self.cfg.seq_parallel and phase != "decode"
        if phase == "decode":
            return EmbedSegment(self.cfg, self.mesh, sp)
        return VLMEmbedSegment(self.cfg, self.mesh, sp)

    def batch_inputs(self, phase, B_loc, S, s_max=0):
        out = super().batch_inputs(phase, B_loc, S, s_max)
        if phase != "decode":
            out["vis"] = (TensorSpec((B_loc, self.seq_local(phase, S),
                                      self.cfg.d_model), torch.bfloat16), 0)
        return out
