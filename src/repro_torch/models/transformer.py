"""Dense decoder-only LM (chatglm3 / smollm backbone) over the DynaFlow
segment machinery."""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..core.module import TensorSpec
from .base import (DenseDecodeLayer, DenseDecoderLayer, EmbedSegment, LMBase,
                   LogitsHead, TrainHead)
from .layers import HeadLayout, MeshInfo


class DenseLM(LMBase):
    family = "dense"

    def __init__(self, cfg: ArchConfig, mesh: MeshInfo):
        super().__init__(cfg, mesh)
        self.layout = HeadLayout(cfg.n_heads, cfg.n_kv, mesh.tp, cfg.hd)

    def make_embed(self, phase):
        sp = self.cfg.seq_parallel and phase != "decode"
        return EmbedSegment(self.cfg, self.mesh, sp)

    def layer_stacks(self, phase):
        cfg, mesh = self.cfg, self.mesh
        if phase == "decode":
            mod = DenseDecodeLayer(cfg, mesh)
            return [("layers", mod, cfg.n_layers,
                     ("k_cache", "v_cache"), ("k_cache", "v_cache"))]
        if phase not in ("prefill", "train"):
            raise NotImplementedError(f"phase {phase!r} is not ported yet")
        prefill = phase == "prefill"
        mod = DenseDecoderLayer(cfg, mesh, cfg.seq_parallel,
                                collect_kv=prefill)
        return [("layers", mod, cfg.n_layers, (),
                 ("k", "v") if prefill else ())]

    def make_head(self, phase):
        sp = self.cfg.seq_parallel and phase != "decode"
        if phase == "train":
            return TrainHead(self.cfg, self.mesh, sp)
        return LogitsHead(self.cfg, self.mesh, sp,
                          keep_last=(phase != "decode"))

    def cache_specs(self, stack_name, B_loc, s_max):
        lay = self.layout
        spec = TensorSpec((B_loc, s_max, lay.kv_local, lay.head_dim),
                          torch.bfloat16)
        return {"k_cache": spec, "v_cache": spec}
