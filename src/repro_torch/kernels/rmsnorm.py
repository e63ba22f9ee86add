"""RMSNorm and fused residual-add + RMSNorm: Triton kernels and their
plain PyTorch versions.

Replaces ``src/repro/kernels/rmsnorm.py:rmsnorm`` and
``:fused_add_rmsnorm``.  Over rows of x (n, d) with g (d,):

  rmsnorm            h = (x * rsqrt(mean(x^2) + eps)).to(x.dtype) * g
  fused_add_rmsnorm  s = x + y in f32; h as above on s; returns
                     (s.to(x.dtype), h) in one pass

What bounds them on the H100: bytes.  Each element costs a handful of
FLOPs against 2 (rmsnorm) or 4 (fused) bf16 reads and writes, so the
kernels must touch every byte once: one program reads a row tile once,
keeps it in registers for the f32 sum of squares and the scaled write,
and never re-reads it.  d need not be a power of two (576, 4096): the
column block is the next power of two, with masked loads and stores.
An rmsnorm program owns one tile of ``TILE`` rows.  A fused program
owns ``block_rows`` rows — TokenWeave's CTA-count knob
(``core/strategies/tokenweave.py``) — and walks them in such tiles.  ``triton`` is imported only when a kernel is
launched: the CPU tests import this module on machines without it.
"""
from __future__ import annotations

import torch

from . import LAUNCHES

EPS = 1e-5
_KERNELS: dict = {}


def rmsnorm_plain(x, g, *, eps: float = EPS):
    """Plain version (the port of ``kernels/ref.py:rmsnorm``)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * g


def fused_add_rmsnorm_plain(x, y, g, *, eps: float = EPS):
    """Plain version (the port of ``kernels/ref.py:fused_add_rmsnorm``)."""
    s = x.float() + y.float()
    var = torch.mean(s * s, dim=-1, keepdim=True)
    h = s * torch.rsqrt(var + eps)
    return s.to(x.dtype), h.to(x.dtype) * g


def _kernels():
    if _KERNELS:
        return _KERNELS
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_kernel(x_ptr, g_ptr, o_ptr, n_rows, d, stride_x, stride_o,
                       eps, ROWS_PER_PROG: tl.constexpr, TILE: tl.constexpr,
                       BLOCK_D: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK_D)
        cmask = cols < d
        g = tl.load(g_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        for r0 in range(0, ROWS_PER_PROG, TILE):
            rows = pid * ROWS_PER_PROG + r0 + tl.arange(0, TILE)
            rows64 = rows.to(tl.int64)[:, None]
            m = (rows < n_rows)[:, None] & cmask[None, :]
            x = tl.load(x_ptr + rows64 * stride_x + cols[None, :], mask=m,
                        other=0.0).to(tl.float32)
            r = tl.rsqrt(tl.sum(x * x, axis=1) / d + eps)
            hn = (x * r[:, None]).to(x_ptr.dtype.element_ty).to(tl.float32)
            tl.store(o_ptr + rows64 * stride_o + cols[None, :],
                     (hn * g[None, :]).to(o_ptr.dtype.element_ty), mask=m)

    @triton.jit
    def fused_add_rmsnorm_kernel(x_ptr, y_ptr, g_ptr, s_ptr, h_ptr, n_rows, d,
                                 stride_x, stride_y, stride_s, stride_h, eps,
                                 ROWS_PER_PROG: tl.constexpr,
                                 TILE: tl.constexpr, BLOCK_D: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK_D)
        cmask = cols < d
        g = tl.load(g_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        for r0 in range(0, ROWS_PER_PROG, TILE):
            rows = pid * ROWS_PER_PROG + r0 + tl.arange(0, TILE)
            rows64 = rows.to(tl.int64)[:, None]
            m = (rows < n_rows)[:, None] & cmask[None, :]
            x = tl.load(x_ptr + rows64 * stride_x + cols[None, :], mask=m,
                        other=0.0).to(tl.float32)
            y = tl.load(y_ptr + rows64 * stride_y + cols[None, :], mask=m,
                        other=0.0).to(tl.float32)
            s = x + y
            r = tl.rsqrt(tl.sum(s * s, axis=1) / d + eps)
            hn = (s * r[:, None]).to(x_ptr.dtype.element_ty).to(tl.float32)
            tl.store(s_ptr + rows64 * stride_s + cols[None, :],
                     s.to(s_ptr.dtype.element_ty), mask=m)
            tl.store(h_ptr + rows64 * stride_h + cols[None, :],
                     (hn * g[None, :]).to(h_ptr.dtype.element_ty), mask=m)

    _KERNELS.update(rmsnorm=rmsnorm_kernel, fused=fused_add_rmsnorm_kernel)
    return _KERNELS


_FLOATS = (torch.bfloat16, torch.float16, torch.float32)


def _geometry(n: int, d: int, block_rows: int):
    """(BLOCK_D, TILE, rows per program, num_warps): a tile holds at most
    8192 elements per tensor so the row stays in registers."""
    block_d = 1 << max(0, (d - 1).bit_length())
    tile = max(1, min(16, 8192 // block_d))
    rows = max(tile, -(-max(1, block_rows) // tile) * tile)
    warps = 4 if block_d * tile <= 2048 else 8
    return block_d, tile, rows, warps


def _check(name, x, g, *others):
    if x.ndim != 2 or x.stride(-1) != 1:
        raise ValueError(f"{name}: x must be (n, d) with contiguous rows")
    n, d = x.shape
    if g.shape != (d,) or not g.is_contiguous():
        raise ValueError(f"{name}: g must be contiguous ({d},)")
    for t in (x, g) + others:
        if t.device != x.device:
            raise ValueError(f"{name}: tensors must share a device")
        if t.dtype not in _FLOATS:
            raise TypeError(f"{name}: unsupported dtype {t.dtype}")
    for t in others:
        if t.shape != x.shape or t.stride(-1) != 1:
            raise ValueError(f"{name}: operands must be (n, d) row-major")


def rmsnorm(x, g, *, eps: float = EPS):
    """RMSNorm over the rows of ``x`` (n, d), one row tile per program."""
    if x.device.type != "cuda":
        return rmsnorm_plain(x, g, eps=eps)
    _check("rmsnorm", x, g)
    n, d = x.shape
    out = torch.empty((n, d), dtype=torch.promote_types(x.dtype, g.dtype),
                      device=x.device)
    block_d, tile, rows, warps = _geometry(n, d, 1)
    grid = (-(-n // rows),)
    _kernels()["rmsnorm"][grid](x, g, out, n, d, x.stride(0), out.stride(0),
                                eps, ROWS_PER_PROG=rows, TILE=tile,
                                BLOCK_D=block_d, num_warps=warps)
    LAUNCHES["rmsnorm"] += 1
    return out


def fused_add_rmsnorm(x, y, g, *, eps: float = EPS, block_rows: int = 256):
    """(x + y, rmsnorm(x + y) * g) over the rows of x, y (n, d)."""
    if x.device.type != "cuda":
        return fused_add_rmsnorm_plain(x, y, g, eps=eps)
    _check("fused_add_rmsnorm", x, g, y)
    n, d = x.shape
    s = torch.empty((n, d), dtype=x.dtype, device=x.device)
    h = torch.empty((n, d), dtype=torch.promote_types(x.dtype, g.dtype),
                    device=x.device)
    block_d, tile, rows, warps = _geometry(n, d, block_rows)
    grid = (-(-n // rows),)
    _kernels()["fused"][grid](x, y, g, s, h, n, d, x.stride(0), y.stride(0),
                              s.stride(0), h.stride(0), eps,
                              ROWS_PER_PROG=rows, TILE=tile, BLOCK_D=block_d,
                              num_warps=warps)
    LAUNCHES["fused_add_rmsnorm"] += 1
    return s, h
