"""TokenWeave-style fused AllReduce + residual-add + RMSNorm.

GPU TokenWeave fuses a multimem AllReduce with RMSNorm inside one kernel,
reserving a few CTAs for communication.  Here the AllReduce is split into
its halves around the fused *memory-bound* middle:

    y_s = reduce_scatter(y)          # network, 1/tp payload per hop
    s_s, h_s = fused add+norm on the (B, S/tp, d) shard   # 1 pass
    s, h = all_gather([s_s, h_s])    # network

The middle is the Triton kernel of ``rmsnorm.py``; its rows per program
(``block_rows``) is the CTA-count knob, selected per batch bucket by the
TokenWeave strategy.  Without a bound ``model`` axis (one GPU, the tests)
the collective halves are the identity and this is the fused kernel.
"""
from __future__ import annotations

import torch

from ..dist import collectives as col


def fused_ar_add_rmsnorm(y_partial, x, g, *, axis: str = "model",
                         eps: float = 1e-5, block_rows: int = 256):
    """Fused psum(y) + (x + .) + rmsnorm over mesh axis ``axis``.

    y_partial, x: (B, S, d) with S divisible by the axis size.
    Returns (s, h) both (B, S, d), s = x + psum(y), h = rmsnorm(s) * g.
    """
    from . import ops as kops
    B, S, d = x.shape
    tp = col.axis_size(axis)
    y_s = col.reduce_scatter(y_partial, axis, dim=1)      # (B, S/tp, d)
    x_s = x.narrow(1, col.axis_index(axis) * (S // tp), S // tp)
    s_s, h_s = kops.fused_add_rmsnorm(x_s, y_s, g, eps=eps,
                                      block_rows=block_rows)
    if tp == 1:
        return s_s, h_s
    sh = col.all_gather(torch.stack([s_s, h_s]), axis, dim=2)   # (2,B,S,d)
    return sh[0], sh[1]
