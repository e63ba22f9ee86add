"""RMSNorm and fused residual-add + RMSNorm: two CUDA kernels
(``csrc/rmsnorm.cu``, ``csrc/fused_add_rmsnorm.cu``) and their plain
PyTorch versions.

Replaces ``src/repro/kernels/rmsnorm.py:rmsnorm`` and
``:fused_add_rmsnorm``.  Over rows of x (n, d) with g (d,):

  rmsnorm            h = (x * rsqrt(mean(x^2) + eps)).to(x.dtype) * g
  fused_add_rmsnorm  s = x + y in f32; h as above on s; returns
                     (s.to(x.dtype), h) in one pass

What bounds them on the H100: bytes.  Each element costs a handful of
FLOPs against 2 (rmsnorm) or 4 (fused) reads and writes, so the kernels
must touch every byte once and keep the row in registers between the
sum of squares and the scaled write.  ``rmsnorm`` holds a row in
registers: one or four warps a row at the row's exact width (16-byte
packs of 8 elements; see the source), as many blocks as rows need.
``fused_add_rmsnorm`` runs ceil(n / block_rows) blocks — ``block_rows``
is TokenWeave's CTA-count knob (``core/strategies/tokenweave.py``), 16 to
32 blocks at the models' prefills — so each block streams its rows
through a ring of shared-memory stages filled by bulk copies, with up to
20 consumer warps on several rows at once (``fused_geometry``).  Neither
kernel is built when this module is imported: the CPU tests import it on
machines without ``nvcc``.

Both are differentiable.  Where a gradient is to flow, ``rmsnorm`` and
``fused_add_rmsnorm`` run the autograd Functions ``RMSNorm`` and
``FusedAddRMSNorm``, whose backwards launch the two entry points of
``csrc/rmsnorm_bwd.cu`` on a CUDA tensor (``rmsnorm_bwd``,
``fused_add_rmsnorm_bwd``) and run their plain versions on the CPU:

  rmsnorm_bwd            dx along the unrounded chain, as JAX's autodiff
                         of ``RMSNormOp.kernel`` has it; dg = sum over
                         rows of dh * (x * r rounded to x's dtype)
  fused_add_rmsnorm_bwd  ``src/repro/kernels/ops.py:_farn_bwd``: on the
                         residual s, ds = ds_out + d(h)/ds, dg = sum of
                         dh * s * r (unrounded); returns (ds, ds, dg)

Both backwards are one kernel body (``norm_bwd_kernel<W, NP, FUSED>``)
on the forward's row geometry (``norm_bwd_geometry``): a lane owns the
same columns of every row of its block's run, so g and dg stay in
registers, each row is read once and the next row's loads go out before
this row's sums; each block writes one f32 partial row of dg, which a
second launch sums in a fixed order (the same bits on every call).
"""
from __future__ import annotations

import torch

from . import LAUNCHES, cost, kernel_ready, meta_route, sm_count

EPS = 1e-5


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


def rmsnorm_bwd_plain(x, g, dh, *, eps: float = EPS):
    """Plain backward of ``rmsnorm``: (dx, dg), f32 row math, dx in x's
    dtype and dg in g's."""
    xf, dhg = x.float(), dh.float() * g.float()
    d = x.shape[-1]
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    dx = r * dhg - (r ** 3 / d) * xf * torch.sum(dhg * xf, -1, keepdim=True)
    xr = (xf * r).to(x.dtype).float()
    dg = torch.sum((dh.float() * xr).reshape(-1, d), dim=0)
    return dx.to(x.dtype), dg.to(g.dtype)


def fused_add_rmsnorm_bwd_plain(s, g, dh, ds_out, *, eps: float = EPS):
    """Plain backward of ``fused_add_rmsnorm`` (the port of
    ``src/repro/kernels/ops.py:_farn_bwd``): from the forward's residual
    ``s`` and the cotangents of h (``dh``) and of s (``ds_out``), returns
    (ds, ds, dg) — the gradient of x and of y is the same — in s's and
    g's dtypes."""
    n = s.shape[-1]
    sf, dhf, gf = s.float(), dh.float(), g.float()
    var = torch.mean(sf * sf, dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    dg = torch.sum((dhf * sf * r).reshape(-1, n), dim=0).to(g.dtype)
    dhg = dhf * gf
    ds_h = r * dhg - (r ** 3 / n) * sf * torch.sum(dhg * sf, -1,
                                                   keepdim=True)
    ds = (ds_out.float() + ds_h).to(s.dtype)
    return ds, ds, dg


_FLOATS = (torch.bfloat16, torch.float16, torch.float32)
_CODES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
NORM_PACKS = (1, 2, 3, 4, 8)    # packs of 8 elements a lane can hold


def norm_geometry(d: int) -> tuple:
    """(warps a row, packs of 8 elements a lane) of the rmsnorm kernel for
    rows of width d: 4 warps from d = 2048 on (as fast as the Triton
    kernel it replaced at the models' widths; one warp was slower), else
    1; then the least of ``NORM_PACKS`` that covers the row (576 takes 1
    warp of 3 packs, 2048 4 of 2, 2560 4 of 3, 4096 4 of 4).  Raises
    ValueError for a width the kernel cannot vectorise (d % 8) or hold
    in registers (d > 8192); every model's width is a multiple of 8
    within it."""
    if d <= 0 or d % 8:
        raise ValueError(f"rmsnorm kernel: width {d} is not a multiple of 8")
    warps = 4 if d >= 2048 else 1
    for p in NORM_PACKS:
        if 256 * warps * p >= d:
            return warps, p
    raise ValueError(f"rmsnorm kernel: width {d} > {1024 * NORM_PACKS[-1]}")


SMEM_PER_BLOCK = 232448      # 227 KB: the most a block may take


def fused_geometry(n: int, d: int, block_rows: int, *, x_bytes: int = 2,
                   paired: bool = True) -> dict:
    """Launch geometry of the fused add+RMSNorm kernel for rows (n, d) of
    ``x_bytes``-byte elements (``paired``: g has x's type, which has 16
    bits): ``ctas`` = ceil(n / block_rows) blocks of ``threads``, a
    producer warp and ``consumer_warps`` (20, within the kernel's cap: 20
    at up to 4 packs a lane where paired, 16 at up to 4 otherwise, 8 at
    8), a row on ``norm_geometry``'s ``warps_per_row`` warps of ``packs``
    packs a lane, ``groups`` rows in the consumers at once, and a ring of
    ``stages`` rows of x and y (at most 64) in ``smem_bytes`` of shared
    memory.  The caps and the layout are the kernel's own
    (``repro_fused_add_rmsnorm_info`` reports them;
    tests/test_torch_kernels_cuda.py holds the two equal).

    A block's 9-21 warps at 52 or more registers a lane leave an SM no
    registers for a second block at the consumer counts the models run,
    so the ring takes up to the 227 KB a block may have, never more
    stages than a block has rows.  Row i goes to stage i % stages and
    group i % groups; where the ring wraps, stages is a multiple of
    groups, so that each stage serves one group, which waits for its
    uses in order (an mbarrier's parity tells one use from the next only
    then).  Raises ValueError for a width the kernel does not take or
    ``block_rows`` < 1."""
    warps, packs = norm_geometry(d)
    if block_rows < 1:
        raise ValueError(f"fused_add_rmsnorm: block_rows {block_rows} < 1")
    ctas = -(-n // block_rows)
    cap = 8 if packs == 8 else 20 if paired and x_bytes == 2 else 16
    cw = max(warps, min(20, cap) // warps * warps)
    stage = 2 * d * x_bytes + 16                  # x and y rows, 2 mbarriers
    while cw > warps and cw // warps * stage + 8 * cw > SMEM_PER_BLOCK:
        cw -= warps                               # a stage a group must fit
    groups = cw // warps
    fixed = 2 * cw * 4                            # partial sums
    rows = max(1, min(block_rows, n))             # the most a block has
    stages = min(64, (SMEM_PER_BLOCK - fixed) // stage)
    if stages < rows:                             # the ring wraps
        stages = max(stages // groups, 1) * groups
    stages = min(stages, rows)
    return dict(ctas=ctas, threads=32 * (1 + cw), consumer_warps=cw,
                warps_per_row=warps, packs=packs, groups=groups,
                stages=stages, smem_bytes=stages * stage + fixed)


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


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def rmsnorm(x, g, *, eps: float = EPS):
    """RMSNorm over the rows of ``x`` (n, d), one or four warps a row."""
    if _wants_grad(x, g):
        return RMSNorm.apply(x, g, eps)
    return _rmsnorm_fwd(x, g, eps)


def _rmsnorm_fwd(x, g, eps):
    if x.device.type == "meta":
        out = torch.promote_types(x.dtype, g.dtype)
        return meta_route(
            "rmsnorm",
            cost.rmsnorm(x.shape[0], x.shape[-1], x_esize=x.element_size(),
                         g_esize=g.element_size(),
                         out_esize=out.itemsize),
            lambda: x.new_empty(x.shape, dtype=out))
    if x.device.type != "cuda":
        return rmsnorm_plain(x, g, eps=eps)
    from ._build import check, library
    _check("rmsnorm", x, g)
    n, d = x.shape
    warps, packs = norm_geometry(d)
    x, g = kernel_ready(x), kernel_ready(g)
    out = torch.empty((n, d), dtype=torch.promote_types(x.dtype, g.dtype),
                      device=x.device)
    if n == 0:
        return out
    rc = library().repro_rmsnorm_fwd(
        x.data_ptr(), g.data_ptr(), out.data_ptr(), n, d, x.stride(0),
        out.stride(0), _CODES[x.dtype], _CODES[g.dtype], warps, packs, eps,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(rc, "rmsnorm")
    LAUNCHES["rmsnorm"] += 1
    return out


def fused_add_rmsnorm(x, y, g, *, eps: float = EPS, block_rows: int = 256):
    """(x + y, rmsnorm(x + y) * g) over the rows of x, y (n, d), in
    ceil(n / block_rows) blocks (TokenWeave's CTA count)."""
    if _wants_grad(x, y, g):
        return FusedAddRMSNorm.apply(x, y, g, eps, block_rows)
    return _fused_fwd(x, y, g, eps, block_rows)


def _fused_fwd(x, y, g, eps, block_rows):
    if x.device.type == "meta":
        h = torch.promote_types(x.dtype, g.dtype)
        return meta_route(
            "fused_add_rmsnorm",
            cost.fused_add_rmsnorm(x.shape[0], x.shape[-1],
                                   esize=x.element_size(),
                                   g_esize=g.element_size(),
                                   h_esize=h.itemsize),
            lambda: (x.new_empty(x.shape), x.new_empty(x.shape, dtype=h)))
    if x.device.type != "cuda":
        return fused_add_rmsnorm_plain(x, y, g, eps=eps)
    from ._build import check, library
    _check("fused_add_rmsnorm", x, g, y)
    if y.dtype != x.dtype:
        raise TypeError("fused_add_rmsnorm: x and y must share a dtype")
    n, d = x.shape
    geo = fused_geometry(n, d, block_rows, x_bytes=x.element_size(),
                         paired=g.dtype == x.dtype != torch.float32)
    x, y, g = kernel_ready(x), kernel_ready(y), kernel_ready(g)
    s = torch.empty((n, d), dtype=x.dtype, device=x.device)
    h = torch.empty((n, d), dtype=torch.promote_types(x.dtype, g.dtype),
                    device=x.device)
    if n == 0:
        return s, h
    rc = library().repro_fused_add_rmsnorm_fwd(
        x.data_ptr(), y.data_ptr(), g.data_ptr(), s.data_ptr(), h.data_ptr(),
        n, d, x.stride(0), y.stride(0), s.stride(0), h.stride(0),
        _CODES[x.dtype], _CODES[g.dtype], block_rows, geo["stages"],
        geo["warps_per_row"], geo["packs"], geo["consumer_warps"], eps,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(rc, "fused_add_rmsnorm")
    LAUNCHES["fused_add_rmsnorm"] += 1
    return s, h


def _bwd_operands(name, x, g, *others):
    """The backward kernels' checks: bf16 (n, d) rows, bf16 g (d,)."""
    _check(name, x, g, *others)
    for t in (x, g) + others:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} kernel takes bf16, got {t.dtype}")
    norm_geometry(x.shape[1])            # the widths the kernels take
    return [kernel_ready(t) for t in (x, g) + others]


def norm_bwd_geometry(n: int, d: int, sms: int) -> dict:
    """Launch geometry of the backward kernel (the rmsnorm and the fused
    add + RMSNorm backward alike) for rows (n, d) on a card of ``sms``
    SMs: a row on ``warps_per_row`` warps (1 up to d = 1024, 4 up to 4096,
    8 up to 8192), each lane holding ``packs`` <= 4 packs of 8 columns
    (the least that covers the row), so that a lane's x, dh, g, dg, the
    next row's x and dh and (fused) this row's ds_out stay in registers;
    blocks of ``threads`` (4 warps, 8 at 8 warps a row) taking
    ``rows_at_once`` rows at a time, ``blocks`` of them: ``blocks_per_sm``
    an SM, fewer where the rows run out.  Each instantiation is compiled to
    keep ``blocks_per_sm`` resident: 4 at one warp a row of up to 2 packs,
    3 at 3 or 4 packs (up to 168 registers), 2 at 4 warps a row (fewer,
    longer runs: faster at d = 4096 in ``tools/kernel_probes.py --probes
    norm_bwd``, where a block's partial row of dg is 16 KB), 1 of 8
    warps.  The workspace holds ``blocks`` f32 partial rows of dg.  Raises
    ValueError for a width the kernel does not take (d % 8, or d >
    8192)."""
    if d <= 0 or d % 8 or d > 8192:
        raise ValueError(f"rmsnorm_bwd kernel: width {d} is not a multiple "
                         f"of 8 in [8, 8192]")
    warps = 1 if d <= 1024 else 4 if d <= 4096 else 8
    packs = next(p for p in NORM_PACKS if 256 * warps * p >= d)
    threads = 256 if warps == 8 else 128
    at_once = threads // 32 // warps
    per_sm = {8: 1, 4: 2}.get(warps, 3 if packs >= 3 else 4)
    blocks = max(1, min(-(-n // at_once), sms * per_sm))
    return dict(warps_per_row=warps, packs=packs, threads=threads,
                rows_at_once=at_once, blocks_per_sm=per_sm, blocks=blocks)


def norm_bwd_info(warps: int, packs: int, fused: bool) -> dict:
    """Of the backward kernel's instantiation (``warps`` a row, ``packs`` a
    lane, ``fused``), from ``repro_norm_bwd_info``: registers a thread,
    local (spill) bytes, threads a block, the blocks an SM it is compiled
    to keep resident and the blocks an SM the card keeps resident."""
    import ctypes

    from ._build import check, library
    vals = [ctypes.c_int() for _ in range(5)]
    check(library().repro_norm_bwd_info(
        warps, packs, int(fused), *[ctypes.byref(v) for v in vals]),
        "norm_bwd info")
    return dict(zip(("registers", "local_bytes", "threads", "blocks_per_sm",
                     "resident_per_sm"), (v.value for v in vals)))


def rmsnorm_bwd(x, g, dh, *, eps: float = EPS):
    """(dx, dg) of ``rmsnorm`` at cotangent ``dh``: the kernel of
    ``csrc/rmsnorm_bwd.cu`` on CUDA tensors, the plain version on the
    CPU."""
    if x.device.type == "meta":
        return meta_route(
            "rmsnorm_bwd",
            cost.rmsnorm_bwd(x.shape[0], x.shape[-1],
                             esize=x.element_size()),
            lambda: (x.new_empty(x.shape), g.new_empty(g.shape)))
    if x.device.type != "cuda":
        return rmsnorm_bwd_plain(x, g, dh, eps=eps)
    from ._build import check, library
    x, g, dh = _bwd_operands("rmsnorm_bwd", x, g, dh)
    n, d = x.shape
    geo = norm_bwd_geometry(n, d, sm_count(x.device.index or 0))
    dx = torch.empty((n, d), dtype=x.dtype, device=x.device)
    dg = torch.empty((d,), dtype=g.dtype, device=x.device)
    if n == 0:
        return dx, dg.zero_()
    work = torch.empty((geo["blocks"], d), dtype=torch.float32,
                       device=x.device)
    rc = library().repro_rmsnorm_bwd(
        x.data_ptr(), g.data_ptr(), dh.data_ptr(), dx.data_ptr(),
        dg.data_ptr(), work.data_ptr(), n, d, x.stride(0), dh.stride(0),
        dx.stride(0), eps, geo["warps_per_row"], geo["packs"], geo["blocks"],
        torch.cuda.current_stream(x.device).cuda_stream)
    check(rc, "rmsnorm_bwd")
    LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dg


def fused_add_rmsnorm_bwd(s, g, dh, ds_out, *, eps: float = EPS):
    """(ds, ds, dg) of ``fused_add_rmsnorm`` from its residual ``s``: the
    kernel of ``csrc/rmsnorm_bwd.cu`` on CUDA tensors (one ds, handed out
    twice), the plain version on the CPU."""
    if s.device.type == "meta":
        def make():
            ds = s.new_empty(s.shape)
            return ds, ds, g.new_empty(g.shape)
        return meta_route(
            "fused_add_rmsnorm_bwd",
            cost.fused_add_rmsnorm_bwd(s.shape[0], s.shape[-1],
                                       esize=s.element_size()), make)
    if s.device.type != "cuda":
        return fused_add_rmsnorm_bwd_plain(s, g, dh, ds_out, eps=eps)
    from ._build import check, library
    s, g, dh, ds_out = _bwd_operands("fused_add_rmsnorm_bwd", s, g, dh,
                                     ds_out)
    n, d = s.shape
    geo = norm_bwd_geometry(n, d, sm_count(s.device.index or 0))
    ds = torch.empty((n, d), dtype=s.dtype, device=s.device)
    dg = torch.empty((d,), dtype=g.dtype, device=s.device)
    if n == 0:
        return ds, ds, dg.zero_()
    work = torch.empty((geo["blocks"], d), dtype=torch.float32,
                       device=s.device)
    rc = library().repro_fused_add_rmsnorm_bwd(
        s.data_ptr(), g.data_ptr(), dh.data_ptr(), ds_out.data_ptr(),
        ds.data_ptr(), dg.data_ptr(), work.data_ptr(), n, d, s.stride(0),
        dh.stride(0), ds_out.stride(0), ds.stride(0), eps,
        geo["warps_per_row"], geo["packs"], geo["blocks"],
        torch.cuda.current_stream(s.device).cuda_stream)
    check(rc, "fused_add_rmsnorm_bwd")
    LAUNCHES["fused_add_rmsnorm_bwd"] += 1
    return ds, ds, dg


class RMSNorm(torch.autograd.Function):
    """``rmsnorm`` with its gradient (``rmsnorm_bwd``)."""

    @staticmethod
    def forward(ctx, x, g, eps):
        ctx.save_for_backward(x, g)
        ctx.eps = eps
        return _rmsnorm_fwd(x, g, eps)

    @staticmethod
    def backward(ctx, dh):
        x, g = ctx.saved_tensors
        dx, dg = rmsnorm_bwd(x, g, dh, eps=ctx.eps)
        return dx, dg, None


class FusedAddRMSNorm(torch.autograd.Function):
    """``fused_add_rmsnorm`` with its gradient: the residual s is what the
    backward keeps, as ``_farn_fwd`` does."""

    @staticmethod
    def forward(ctx, x, y, g, eps, block_rows):
        s, h = _fused_fwd(x, y, g, eps, block_rows)
        ctx.save_for_backward(s, g)
        ctx.eps = eps
        return s, h

    @staticmethod
    def backward(ctx, ds_out, dh):
        s, g = ctx.saved_tensors
        if ds_out is None:
            ds_out = torch.zeros_like(s)
        if dh is None:
            dh = torch.zeros_like(s)
        dx, dy, dg = fused_add_rmsnorm_bwd(s, g, dh, ds_out, eps=ctx.eps)
        return dx, dy, dg, None, None
