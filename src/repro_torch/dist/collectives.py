"""Axis-optional collectives — identity without a process group, real
``torch.distributed`` collectives once a mesh axis is bound.

Model code calls these unconditionally.  A named axis is *bound* when the
launch layer registers a process group of more than one rank for it with
``bind_axis`` (``launch/mesh.py:make_mesh``); until then (one GPU, the
CPU tests, symbolic tracing) every collective degenerates to its
single-participant identity: ``psum`` -> x, ``all_gather`` -> x,
``axis_index`` -> 0, ``axis_size`` -> 1.  This keeps the same model
source runnable on one card and on a mesh without edits (the paper's
transparency requirement).  Bound, every collective the model
differentiates through is an autograd Function (see below), and
``ppermute`` is point-to-point send/recv.

A dry run (``launch/dryrun.py``) binds an axis to a :class:`Recorder`
instead of a process group: each collective over it returns a result of
the right shape, computes nothing, and records its result's bytes on
this rank under its kind for the counter that counts
(``roofline/count.py``), forwards and backwards alike.
"""
from __future__ import annotations

import torch

_AXES: dict = {}     # axis name -> torch.distributed process group
_SIZES: dict = {}    # axis name -> its group's size, read once at binding


class Recorder:
    """The stand-in for an axis's process group in a dry run: the axis
    has ``size`` ranks and this rank sits at ``index``.  Each collective
    over it returns an empty tensor of its result's shape and records the
    result's bytes, the JAX package's rule for an HLO collective
    (``roofline/hlo.py``): ``psum``, ``pmax`` and ``compressed_psum``
    under ``all-reduce``, ``all_gather`` under ``all-gather``,
    ``reduce_scatter`` under ``reduce-scatter``, ``all_to_all`` under
    ``all-to-all``, ``ppermute`` under ``collective-permute``.  Over one
    rank the result is ``x`` itself, as an unbound axis's identity is on
    the card, so it holds no memory of its own."""

    def __init__(self, size: int, index: int = 0):
        self.size, self.index = int(size), int(index)

    def result(self, kind: str, x, shape):
        from ..roofline.count import Counter
        out = x if self.size == 1 else x.new_empty(shape)
        if Counter.current is not None:
            Counter.current.collective(kind, out.numel() * out.element_size())
        return out

    @staticmethod
    def resized(x, dim: int, mul: int = 1, div: int = 1) -> list:
        """``x``'s shape with dim ``dim`` times ``mul`` over ``div``."""
        shape = list(x.shape)
        shape[dim % x.ndim] = shape[dim % x.ndim] * mul // div
        return shape


def bind_axis(axis: str, group) -> None:
    """Route collectives over ``axis`` through ``group``, a process group
    or a :class:`Recorder` (``None`` unbinds it)."""
    if group is None:
        _AXES.pop(axis, None)
        _SIZES.pop(axis, None)
        return
    _AXES[axis] = group
    if isinstance(group, Recorder):
        _SIZES[axis] = group.size
        return
    import torch.distributed as dist
    _SIZES[axis] = dist.get_world_size(group)


def group_of(axis: str):
    """What ``axis`` is bound to: a process group, a ``Recorder``, or
    ``None``."""
    return _AXES.get(axis)


def _bound(axis: str) -> bool:
    """True iff ``axis`` has a process group with more than one rank, or
    a ``Recorder`` of any size: a dry run records a collective over one
    rank as the JAX package's SPMD module keeps it."""
    return _SIZES.get(axis, 1) > 1 or isinstance(_AXES.get(axis), Recorder)


def _dist():
    import torch.distributed as dist
    return dist


def axis_size(axis: str) -> int:
    return _SIZES.get(axis, 1)


def axis_index(axis: str) -> int:
    if not _bound(axis):
        return 0
    group = _AXES[axis]
    if isinstance(group, Recorder):
        return group.index
    return _dist().get_rank(group)


def _recorder(axis: str):
    group = _AXES[axis]
    return group if isinstance(group, Recorder) else None


def _all_reduce(x, axis: str, op=None):
    rec = _recorder(axis)
    if rec is not None:
        return rec.result("all-reduce", x, x.shape)
    dist = _dist()
    out = x.clone()
    if op is None:
        dist.all_reduce(out, group=_AXES[axis])
    else:
        dist.all_reduce(out, op=op, group=_AXES[axis])
    return out


def _all_gather(x, axis: str, dim: int):
    n = axis_size(axis)
    rec = _recorder(axis)
    if rec is not None:
        return rec.result("all-gather", x, rec.resized(x, dim, mul=n))
    parts = [torch.empty_like(x) for _ in range(n)]
    _dist().all_gather(parts, x.contiguous(), group=_AXES[axis])
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x, axis: str, dim: int):
    n = axis_size(axis)
    rec = _recorder(axis)
    if rec is not None:
        return rec.result("reduce-scatter", x, rec.resized(x, dim, div=n))
    dist, group = _dist(), _AXES[axis]
    if dist.get_backend(group) == "gloo":
        # gloo has no reduce-scatter: all-reduce, keep this rank's chunk
        return _all_reduce(x, axis).chunk(n, dim=dim)[
            axis_index(axis)].contiguous()
    parts = [p.contiguous() for p in x.chunk(n, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def _all_to_all(x, axis: str, split_dim: int, concat_dim: int):
    n = axis_size(axis)
    rec = _recorder(axis)
    if rec is not None:
        shape = rec.resized(x, split_dim, div=n)
        shape[concat_dim % x.ndim] *= n
        return rec.result("all-to-all", x, shape)
    ins = [p.contiguous() for p in x.chunk(n, dim=split_dim)]
    outs = [torch.empty_like(p) for p in ins]
    _dist().all_to_all(outs, ins, group=_AXES[axis])
    return torch.cat(outs, dim=concat_dim)


def _ppermute(x, axis: str, perm):
    """Point-to-point: this rank sends ``x`` to every ``dst`` of a pair
    ``(me, dst)`` and receives from the ``src`` of ``(src, me)``; a rank
    nobody sends to gets zeros (``lax.ppermute``'s rule)."""
    rec = _recorder(axis)
    if rec is not None:
        return rec.result("collective-permute", x, x.shape)
    dist, group = _dist(), _AXES[axis]
    me = axis_index(axis)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


# Each collective the model differentiates through is an autograd
# Function whose backward is the transpose the JAX package's step takes
# under ``shard_map(check_vma=False)``: psum -> psum, all_gather ->
# reduce_scatter, reduce_scatter -> all_gather, all_to_all -> the
# all_to_all with split and concat swapped, ppermute -> the inverse
# permutation.  (psum's transpose is psum there, not the identity: a
# replicated cotangent comes back multiplied by the axis size.)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.axis, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _reduce_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.axis, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.args = (axis, split_dim, concat_dim)
        return _all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        axis, split_dim, concat_dim = ctx.args
        return _all_to_all(g, axis, concat_dim, split_dim), None, None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm):
        ctx.axis, ctx.perm = axis, perm
        return _ppermute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inv = tuple((dst, src) for src, dst in ctx.perm)
        return _ppermute(g, ctx.axis, inv), None, None


def psum(x, axis: str):
    if not _bound(axis):
        return x
    return _Psum.apply(x, axis)


def pmax(x, axis: str):
    """Not differentiated (the callers pass a stability max or a scale
    with no gradient)."""
    if not _bound(axis):
        return x
    return _all_reduce(x.detach(), axis, _dist().ReduceOp.MAX)


def all_gather(x, axis: str, dim: int = 0):
    if not _bound(axis):
        return x
    return _AllGather.apply(x, axis, dim)


def reduce_scatter(x, axis: str, dim: int = 0):
    if not _bound(axis):
        return x
    return _ReduceScatter.apply(x, axis, dim)


def all_to_all(x, axis: str, split_dim: int, concat_dim: int):
    if not _bound(axis):
        return x
    return _AllToAll.apply(x, axis, split_dim, concat_dim)


def ppermute(x, axis: str, perm):
    """Send ``x`` along ``perm``, pairs ``(src, dst)`` of axis indices,
    by point-to-point send/recv (``batch_isend_irecv``); the identity
    when ``axis`` is unbound."""
    if not _bound(axis):
        return x
    return _Ppermute.apply(x, axis, tuple((int(s), int(d)) for s, d in perm))


def compressed_psum(x, axis: str, err=None):
    """int8 block-quantized psum with error feedback (the port of
    ``src/repro/dist/collectives.py:compressed_psum``).

    The quantization residual is carried in ``err`` and re-injected next
    step, so the *accumulated* compressed sum is unbiased (the standard
    EF-SGD guarantee).  Scales are pmax'd across the axis so every
    participant dequantizes identically.  Unbound, ``pmax`` and ``psum``
    are the identity but the quantization is not: the value still goes
    through its int8 codes.  Returns ``(reduced, new_err)``; types
    promote as the JAX package's do (a bf16 ``x`` plus an f32 ``err``
    sums in f32, and ``new_err`` takes ``x``'s dtype)."""
    val = x if err is None else x + err
    f32 = val.float()
    scale = pmax(f32.abs().max(), axis) / 127.0
    scale = torch.clamp_min(scale, torch.finfo(torch.float32).tiny)
    q = torch.clamp(torch.round(f32 / scale), -127, 127).to(torch.int8)
    deq_local = q.float() * scale
    new_err = (f32 - deq_local).to(x.dtype)
    reduced = psum(q.to(torch.int32), axis).float() * scale
    return reduced.to(x.dtype), new_err
