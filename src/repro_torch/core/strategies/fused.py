"""Fused replacement kernels used via ``execute(..., replace_func=...)``.

Each takes the ``FusedCallInfo`` the backend hands to ``replace_func``
plus the group's external inputs, and returns the group's external
outputs.
"""
from __future__ import annotations

import torch

from ...dist import collectives as col


def tokenweave_fused(info, *vals, axis: str = "model", block_rows: int = 256):
    """Replace [psum, add, rmsnorm] with RS + fused add/norm + AG.

    Handles order: (ar, add, norm).  Returns (s, h) = (x + psum(y),
    rmsnorm(x + psum(y)) * g) matching the group's external outputs."""
    from ...kernels import ops as kops
    g_param = info.params_of(2)["g"]
    ar_node = info.node(0)
    y_tid = ar_node.inputs[0]
    idx = {t: i for i, (t, p) in enumerate(info.ext_inputs)}
    y_partial = vals[idx[y_tid]]
    add_node = info.node(1)
    x_tid = next(t for t in add_node.inputs if t != ar_node.outputs[0])
    x = vals[idx[x_tid]]
    tp = col.axis_size(axis)
    if x.shape[1] % max(tp, 1):   # sequence not divisible: plain fused path
        return kops.fused_add_rmsnorm(x, col.psum(y_partial, axis), g_param,
                                      block_rows=block_rows)
    return kops.fused_ar_add_rmsnorm(y_partial, x, g_param, axis=axis,
                                     block_rows=block_rows)


def comet_fused(info, *vals, axis: str = "model", n_chunks: int = 4):
    """Replace [a2a_dispatch, expert_ffn, a2a_combine] with a chunked
    pipeline over the capacity axis: chunk i's grouped expert FFN can
    overlap chunk i+1's dispatch all-to-all and chunk i-1's combine
    (one GPU: the all-to-alls are the identity and the chunks run in
    turn).  Each chunk is a view of the dispatch buffer, which the
    grouped-FFN kernel reads in place."""
    from ...kernels import ops as kops
    buf = vals[0]                       # (V, C, d) capacity-packed tokens
    p = info.params_of(1)
    w1, w3, w2 = p["w1"], p["w3"], p["w2"]
    V, C, d = buf.shape
    G = n_chunks
    while C % G:
        G //= 2
    G = max(G, 1)
    Cc = C // G
    outs = []
    for i in range(G):
        x_i = buf.narrow(1, i * Cc, Cc)
        y_i = col.all_to_all(x_i, axis, split_dim=0, concat_dim=1)
        z_i = kops.grouped_ffn(y_i, w1, w3, w2)
        outs.append(col.all_to_all(z_i, axis, split_dim=1, concat_dim=0))
    return torch.cat(outs, dim=1) if G > 1 else outs[0]


def flux_fused(info, *vals, axis: str = "model", n_chunks: int = 4):
    """Replace [linear, psum] with a row-chunked GEMM + all-reduce
    pipeline — the paper's §5.3.5 negative result: the chunked
    all-reduces multiply the per-collective latency term, which the
    roofline model surfaces.  At tp=1 each all-reduce is the identity."""
    x = vals[0]
    p = info.params_of(0)
    w = p["w"] if p else vals[1]        # FSDP variant: weight is an input
    B, S, _ = x.shape
    G = n_chunks
    while S % G:
        G //= 2
    G = max(G, 1)
    Sc = S // G
    outs = []
    for i in range(G):
        y_i = torch.matmul(x.narrow(1, i * Sc, Sc), w)
        outs.append(col.psum(y_i, axis))
    return torch.cat(outs, dim=1) if G > 1 else outs[0]
