"""Inter-stage pipeline driver (GPipe-style fill/drain over a mesh axis).

``pipeline_apply`` runs one stage function per rank along ``axis``:
microbatch ``j`` visits stage ``i`` at tick ``i + j``; activations move to
the next stage over a ring ``ppermute`` (point-to-point send/recv) each
tick.  Each rank returns its local buffer of stage outputs — the *last*
stage's buffer holds the fully-processed microbatches.  Stage functions
must be shape-preserving (uniform activation shape between stages), the
usual pipeline contract.  The port of ``src/repro/dist/pipeline.py``: the
tick loop is a Python loop, the JAX package's ``lax.fori_loop``.
"""
from __future__ import annotations

import torch

from . import collectives as col


def pipeline_apply(fn, stage_params, mbs, axis: str = "pod"):
    """Apply ``fn(stage_params, mb)`` pipelined over mesh axis ``axis``.

    ``mbs`` is a stacked ``(n_mb, ...)`` tensor of microbatches,
    replicated on every stage; ``stage_params`` are this rank's stage
    weights.  Returns an ``(n_mb, ...)`` buffer; on stage ``i`` row ``j``
    holds microbatch ``j`` after stages ``0..i``.  With one stage (an
    unbound axis) it is a map over the microbatches.
    """
    n_stages = col.axis_size(axis)
    n_mb = mbs.shape[0]
    if n_stages == 1:
        return torch.stack([fn(stage_params, mbs[j]) for j in range(n_mb)])
    idx = col.axis_index(axis)
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    outs = torch.zeros_like(mbs)
    state = torch.zeros_like(mbs[0])
    first = torch.tensor(idx == 0, device=mbs.device)
    # Both selects below are selects, not branches, as in the JAX
    # package: every tick's ring traffic stays in each stage's autograd
    # graph, so every stage enters every backward ppermute (a collective)
    # in the same order; a branch would leave it out on some stages.
    for t in range(n_mb + n_stages - 1):
        # stage 0 feeds fresh microbatches; later stages consume the ring
        x_in = torch.where(first, mbs[min(t, n_mb - 1)], state)
        y = fn(stage_params, x_in)
        slot = t - idx                      # microbatch this stage just ran
        c = min(max(slot, 0), n_mb - 1)
        upd = torch.cat([outs[:c], y[None], outs[c + 1:]])
        outs = torch.where(torch.tensor(0 <= slot < n_mb,
                                        device=mbs.device), upd, outs)
        state = col.ppermute(y, axis, perm)
    return outs
