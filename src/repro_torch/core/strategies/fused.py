"""Fused replacement kernels used via ``execute(..., replace_func=...)``.

Each takes the ``FusedCallInfo`` the backend hands to ``replace_func``
plus the group's external inputs, and returns the group's external
outputs.  ``comet_fused`` and ``flux_fused`` arrive with the slices that
port their kernels.
"""
from __future__ import annotations

from ...dist import collectives as col


def reduce_scatter_chain(node) -> bool:
    """Whether a TokenWeave chain starts at a reduce-scatter (``rs_*``,
    the sequence-parallel form) rather than an all-reduce (``ar_*``)."""
    return node.name.rsplit("/", 1)[-1].startswith("rs_")


def tokenweave_fused(info, *vals, axis: str = "model", block_rows: int = 256):
    """Replace [psum, add, rmsnorm] with RS + fused add/norm + AG, and
    [reduce-scatter, add, rmsnorm] with RS + fused add/norm on the shard.

    Handles order: (collective, add, norm).  Returns (s, h) = (x + c(y),
    rmsnorm(x + c(y)) * g) matching the group's external outputs, where
    c is the chain's collective."""
    from ...kernels import ops as kops
    g_param = info.params_of(2)["g"]
    ar_node = info.node(0)
    y_tid = ar_node.inputs[0]
    idx = {t: i for i, (t, p) in enumerate(info.ext_inputs)}
    y_partial = vals[idx[y_tid]]
    add_node = info.node(1)
    x_tid = next(t for t in add_node.inputs if t != ar_node.outputs[0])
    x = vals[idx[x_tid]]
    if reduce_scatter_chain(ar_node):
        # sequence parallel: the residual x is already this rank's shard
        # of the sequence axis, and the graph's own all-gather follows
        return kops.fused_add_rmsnorm(
            x, col.reduce_scatter(y_partial, axis, dim=1), g_param,
            block_rows=block_rows)
    tp = col.axis_size(axis)
    if x.shape[1] % max(tp, 1):   # sequence not divisible: plain fused path
        return kops.fused_add_rmsnorm(x, col.psum(y_partial, axis), g_param,
                                      block_rows=block_rows)
    return kops.fused_ar_add_rmsnorm(y_partial, x, g_param, axis=axis,
                                     block_rows=block_rows)
