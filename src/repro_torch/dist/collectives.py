"""Axis-optional collectives — identity without a process group, real
``torch.distributed`` collectives once a mesh axis is bound.

Model code calls these unconditionally.  A named axis is *bound* when the
launch layer registers a process group for it with ``bind_axis``; until
then (one GPU, the CPU tests, symbolic tracing) every collective
degenerates to its single-participant identity: ``psum`` -> x,
``all_gather`` -> x, ``axis_index`` -> 0, ``axis_size`` -> 1.  This keeps
the same model source runnable on one card and on a mesh without edits
(the paper's transparency requirement).
"""
from __future__ import annotations

import torch

_AXES: dict = {}     # axis name -> torch.distributed process group


def bind_axis(axis: str, group) -> None:
    """Route collectives over ``axis`` through ``group``."""
    _AXES[axis] = group


def _bound(axis: str) -> bool:
    """True iff ``axis`` has a process group with more than one rank."""
    group = _AXES.get(axis)
    if group is None:
        return False
    import torch.distributed as dist
    return dist.get_world_size(group) > 1


def _dist():
    import torch.distributed as dist
    return dist


def axis_size(axis: str) -> int:
    if not _bound(axis):
        return 1
    return _dist().get_world_size(_AXES[axis])


def axis_index(axis: str) -> int:
    if not _bound(axis):
        return 0
    return _dist().get_rank(_AXES[axis])


def psum(x, axis: str):
    if not _bound(axis):
        return x
    out = x.clone()
    _dist().all_reduce(out, group=_AXES[axis])
    return out


def pmax(x, axis: str):
    if not _bound(axis):
        return x
    dist = _dist()
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=_AXES[axis])
    return out


def all_gather(x, axis: str, dim: int = 0):
    if not _bound(axis):
        return x
    n = axis_size(axis)
    parts = [torch.empty_like(x) for _ in range(n)]
    _dist().all_gather(parts, x.contiguous(), group=_AXES[axis])
    return torch.cat(parts, dim=dim)


def reduce_scatter(x, axis: str, dim: int = 0):
    if not _bound(axis):
        return x
    dist, group = _dist(), _AXES[axis]
    n = axis_size(axis)
    if dist.get_backend(group) == "gloo":
        # gloo has no reduce-scatter: all-reduce, keep this rank's chunk
        return psum(x, axis).chunk(n, dim=dim)[axis_index(axis)].contiguous()
    parts = [p.contiguous() for p in x.chunk(n, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def all_to_all(x, axis: str, split_dim: int, concat_dim: int):
    if not _bound(axis):
        return x
    n = axis_size(axis)
    ins = [p.contiguous() for p in x.chunk(n, dim=split_dim)]
    outs = [torch.empty_like(p) for p in ins]
    _dist().all_to_all(outs, ins, group=_AXES[axis])
    return torch.cat(outs, dim=concat_dim)
