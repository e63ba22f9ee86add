"""Multi-tensor AdamW: one CUDA kernel (``csrc/adamw.cu``) that updates
every leaf whose moments are f32 in one launch, and its plain version,
the eager chain of ``optim/adamw.py`` (``adamw_chain``).

Replaces no TPU kernel: ``src/repro/optim/adamw.py:adamw_update`` has no
Pallas call, and XLA fuses its elementwise chain inside the reference's
jitted train step.  The kernel is the port's form of that fusion: the
eager chain runs ~21 f32 ops a leaf, each with a temporary the leaf's
size (~190 bytes a parameter), where the update needs 22 (a bf16 param
read and written, a bf16 grad read, f32 m and v read and written).

The kernel gives the chain's bits on the card (see the source), so a
step that runs it equals the eager one bit for bit.  ``lr``, ``scale``,
``c1`` and ``c2`` are 0-d f32 device tensors that the kernel reads
through pointers: a CUDA Graph that captured the launch reads each
replay's values.  The leaf table (pointers, sizes, dtypes) is built once
per set of storages and kept; the grads go by value in the launch's
parameters, which hold at most ``limits()["max_leaves"]`` of them (the
models' stacked layers give 8–9 leaves).
Nothing is built when this module is imported.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import LAUNCHES, cost, meta_route, sm_count

_FLAGS = {torch.bfloat16: 0, torch.float32: 1}
_TABLES: dict = {}      # (device, leaf key) -> (device table, tiles)


def adamw_chain(p, g, m, v, lr, scale, c1, c2, *, b1: float, b2: float,
                eps: float, weight_decay: float):
    """One leaf's update as the eager chain: (new param in f32, m, v)."""
    g = g.float() * scale
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    step = (m / c1) / (torch.sqrt(v / c2) + eps)
    pf = p.float()
    return pf - lr * (step + weight_decay * pf), m, v


def adamw_plain(ps, gs, ms, vs, lr, scale, c1, c2, **consts):
    """Plain version: the chain leaf by leaf, written in place."""
    for p, g, m, v in zip(ps, gs, ms, vs):
        pn, mn, vn = adamw_chain(p, g, m, v, lr,
                                 1.0 if scale is None else scale, c1, c2,
                                 **consts)
        p.copy_(pn)
        m.copy_(mn)
        v.copy_(vn)


@functools.lru_cache(maxsize=None)
def limits() -> dict:
    """The leaves one launch takes and the elements of a tile."""
    from ._build import check, library
    vals = [ctypes.c_int() for _ in range(2)]
    check(library().repro_adamw_limits(*[ctypes.byref(v) for v in vals]),
          "adamw limits")
    return dict(zip(("max_leaves", "tile"), (v.value for v in vals)))


@functools.lru_cache(maxsize=None)
def adamw_info() -> dict:
    """Registers a thread, local (spill) bytes and resident blocks an SM
    of the compiled kernel."""
    from ._build import check, library
    vals = [ctypes.c_int() for _ in range(3)]
    check(library().repro_adamw_info(*[ctypes.byref(v) for v in vals]),
          "adamw info")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))


def tile_starts(numels, tile: int):
    """Each leaf's first tile among the launch's tiles, and the tiles."""
    first, t = [], 0
    for n in numels:
        first.append(t)
        t += -(-n // tile)
    return first, t


def _table(ps, ms, vs, gdtypes, dev):
    """The launch's device table for this set of storages and its tiles,
    built once (a captured graph keeps reading it, so it is never
    dropped; a table is a function of its key, so storages at reused
    addresses share it rightly)."""
    key = (dev, tuple((p.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
                       p.dtype, gd) for p, m, v, gd in zip(ps, ms, vs,
                                                           gdtypes)))
    hit = _TABLES.get(key)
    if hit is None:
        first, ntiles = tile_starts([p.numel() for p in ps], limits()["tile"])
        rows = [[p.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(), t0,
                 _FLAGS[p.dtype] | _FLAGS[gd] << 1]
                for p, m, v, gd, t0 in zip(ps, ms, vs, gdtypes, first)]
        hit = _TABLES[key] = (torch.tensor(rows, dtype=torch.int64).to(dev),
                              ntiles)
    return hit


def _checked(ps, gs, ms, vs, scalars):
    dev = ps[0].device
    if len(ps) > limits()["max_leaves"]:
        raise ValueError(f"adamw kernel takes at most "
                         f"{limits()['max_leaves']} leaves a launch, got "
                         f"{len(ps)}")
    for p, g, m, v in zip(ps, gs, ms, vs):
        if not (p.device == g.device == m.device == v.device == dev):
            raise ValueError("adamw: every leaf, grad and moment must be on "
                             "one device")
        if p.dtype not in _FLAGS or g.dtype not in _FLAGS:
            raise TypeError(f"adamw kernel takes bf16 or f32 params and "
                            f"grads, got {p.dtype}/{g.dtype}")
        if m.dtype != torch.float32 or v.dtype != torch.float32:
            raise TypeError("adamw kernel takes f32 m and v")
        if not (g.shape == m.shape == v.shape == p.shape):
            raise ValueError("adamw: grad, m and v must have the param's "
                             "shape")
        if not all(t.is_contiguous() for t in (p, m, v)):
            raise ValueError("adamw kernel takes contiguous params and "
                             "moments")
    for t in scalars:
        if t is not None and (t.device != dev or t.dtype != torch.float32
                              or t.numel() != 1):
            raise ValueError("adamw: lr, scale, c1 and c2 must be f32 "
                             "one-element tensors on the leaves' device")
    return dev


def adamw(ps, gs, ms, vs, lr, scale: Optional[torch.Tensor], c1, c2, *,
          b1: float, b2: float, eps: float, weight_decay: float):
    """Update params ``ps`` and f32 moments ``ms``, ``vs`` in place from
    grads ``gs``: one launch of the kernel on CUDA tensors,
    ``adamw_plain`` on the CPU.  ``scale`` None means no clipping."""
    consts = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if not ps:
        return
    if ps[0].device.type == "meta":
        meta_route("adamw", cost.adamw([
            (p.numel(), p.element_size(), g.element_size())
            for p, g in zip(ps, gs)]), lambda: None)
        return
    if ps[0].device.type != "cuda":
        adamw_plain(ps, gs, ms, vs, lr, scale, c1, c2, **consts)
        return
    from ._build import check, library
    dev = _checked(ps, gs, ms, vs, (lr, scale, c1, c2))
    # autograd may hand a grad over in another layout: the kernel reads
    # it as the param's, so such a grad is copied first (stream-ordered,
    # so the copy lives until the launch has read it)
    gs = [g if g.is_contiguous() else g.contiguous() for g in gs]
    table, ntiles = _table(ps, ms, vs, [g.dtype for g in gs], dev)
    if ntiles == 0:
        return
    grid = min(ntiles, sm_count(dev.index or 0)
               * adamw_info()["blocks_per_sm"])
    f = ctypes.c_float
    rc = library().repro_adamw(
        table.data_ptr(), (ctypes.c_void_p * len(gs))(
            *[g.data_ptr() for g in gs]), len(gs), ntiles, lr.data_ptr(),
        None if scale is None else scale.data_ptr(), c1.data_ptr(),
        c2.data_ptr(), f(b1), f(1 - b1), f(b2), f(1 - b2), f(eps),
        f(weight_decay), grid, torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "adamw")
    LAUNCHES["adamw"] += 1
