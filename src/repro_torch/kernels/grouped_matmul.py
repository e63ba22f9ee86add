"""Grouped expert FFN: the CUDA kernel (``csrc/grouped_ffn.cu``) and its
plain PyTorch version.

Replaces ``src/repro/kernels/grouped_matmul.py:grouped_ffn``.  Per expert
e, ``y_e = (silu(x_e @ w1_e) * (x_e @ w3_e)) @ w2_e`` with x (E, N, D),
w1/w3 (E, D, F), w2 (E, F, D); products and the gate in f32, output in
x's dtype.  The kernel takes bf16, D a multiple of 128 and F a multiple
of 64, any N >= 1, and x as a view with a unit column stride (Comet's
chunks of the dispatch buffer); see the source for what bounds it and
how.

``grouped_ffn`` trains through ``GroupedFFN``: its forward is the kernel
(the plain version on the CPU) and keeps x and the weights only; its
backward recomputes h1 = x w1 and h3 = x w3, and runs the seven grouped
products as ``torch.bmm`` (the JAX package differentiates its expert FFN
as XLA einsums, outside any Pallas kernel) around the gate's backward,
the CUDA kernel ``csrc/grouped_ffn_bwd.cu`` (``grouped_ffn_gate_bwd``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import LAUNCHES, cost, kernel_ready, meta_route


def grouped_ffn_plain(x, w1, w3, w2):
    """Plain version (the port of ``kernels/ref.py:grouped_ffn``)."""
    xf = x.float()
    h = F.silu(torch.bmm(xf, w1.float())) * torch.bmm(xf, w3.float())
    return torch.bmm(h, w2.float()).to(x.dtype)


def grouped_ffn(x, w1, w3, w2):
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, w3, w2)):
        return GroupedFFN.apply(x, w1, w3, w2)
    if x.device.type == "meta":
        return _grouped_ffn_meta(x, w1, w2)
    if x.device.type != "cuda":
        return grouped_ffn_plain(x, w1, w3, w2)
    return _grouped_ffn_fwd(x, w1, w3, w2)


def _grouped_ffn_meta(x, w1, w2):
    E, N, D = x.shape
    return meta_route(
        "grouped_ffn",
        cost.grouped_ffn(E, N, D, w1.shape[-1], esize=x.element_size()),
        lambda: x.new_empty((E, N, w2.shape[-1])))


class GroupedFFN(torch.autograd.Function):
    """``grouped_ffn`` with its gradient: the forward saves x, w1, w3 and
    w2 (not the (E, N, F) intermediates), the backward is
    ``grouped_ffn_bwd``."""

    @staticmethod
    def forward(ctx, x, w1, w3, w2):
        if x.device.type == "cuda":
            y = _grouped_ffn_fwd(x, w1, w3, w2)
        elif x.device.type == "meta":
            y = _grouped_ffn_meta(x, w1, w2)
        else:
            y = grouped_ffn_plain(x, w1, w3, w2)
        ctx.save_for_backward(x, w1, w3, w2)
        return y

    @staticmethod
    def backward(ctx, dy):
        return grouped_ffn_bwd(*ctx.saved_tensors, dy)


def grouped_ffn_bwd(x, w1, w3, w2, dy):
    """(dx, dw1, dw3, dw2) of y = (silu(x w1) * (x w3)) w2 at ``dy``: the
    products in x's dtype (f32 sums), the gate by
    ``grouped_ffn_gate_bwd`` (its kernel on CUDA tensors)."""
    dy = dy.to(x.dtype)
    h1, h3 = torch.bmm(x, w1), torch.bmm(x, w3)
    dh = torch.bmm(dy, w2.transpose(1, 2))
    dh1, dh3, h = grouped_ffn_gate_bwd(h1, h3, dh)
    del h1, h3, dh
    dw2 = torch.bmm(h.transpose(1, 2), dy)
    # dh1 w1^T + dh3 w3^T with one rounding of the sum
    dx = torch.baddbmm(torch.bmm(dh3, w3.transpose(1, 2)), dh1,
                       w1.transpose(1, 2))
    xt = x.transpose(1, 2)
    return dx, torch.bmm(xt, dh1), torch.bmm(xt, dh3), dw2


def grouped_ffn_gate_bwd_plain(h1, h3, dh):
    """The gate's backward in f32, each output rounded to h1's dtype:
    (dh1, dh3, h) = (dh h3 silu'(h1), dh silu(h1), silu(h1) h3)."""
    a, b, g = h1.float(), h3.float(), dh.float()
    s = torch.sigmoid(a)
    silu = a * s
    dh1 = g * b * (s * (1.0 + a * (1.0 - s)))
    return dh1.to(h1.dtype), (g * silu).to(h1.dtype), \
        (silu * b).to(h1.dtype)


def grouped_ffn_gate_bwd(h1, h3, dh):
    """(dh1, dh3, h) of ``grouped_ffn_gate_bwd_plain`` by the CUDA kernel
    (``csrc/grouped_ffn_bwd.cu``) on CUDA tensors: bf16, one shape."""
    if h1.device.type == "meta":
        return meta_route(
            "grouped_ffn_gate_bwd",
            cost.grouped_ffn_gate_bwd(h1.numel(), esize=h1.element_size()),
            lambda: tuple(h1.new_empty(h1.shape) for _ in range(3)))
    if h1.device.type != "cuda":
        return grouped_ffn_gate_bwd_plain(h1, h3, dh)
    from ._build import check, library
    if not (h1.device == h3.device == dh.device):
        raise ValueError("grouped_ffn_gate_bwd: h1, h3 and dh must share a "
                         "device")
    if not (h1.dtype == h3.dtype == dh.dtype == torch.bfloat16):
        raise TypeError(f"grouped_ffn_gate_bwd kernel takes bf16, got "
                        f"{h1.dtype}/{h3.dtype}/{dh.dtype}")
    if not (h1.shape == h3.shape == dh.shape):
        raise ValueError(f"grouped_ffn_gate_bwd: shapes {tuple(h1.shape)} "
                         f"{tuple(h3.shape)} {tuple(dh.shape)} differ")
    # the kernel reads them flat: contiguous, 16-byte aligned
    h1, h3, dh = (kernel_ready(t.contiguous()) for t in (h1, h3, dh))
    dh1, dh3, h = (torch.empty_like(h1) for _ in range(3))
    n = h1.numel()
    if n == 0:
        return dh1, dh3, h
    rc = library().repro_grouped_ffn_gate_bwd(
        h1.data_ptr(), h3.data_ptr(), dh.data_ptr(), dh1.data_ptr(),
        dh3.data_ptr(), h.data_ptr(), n,
        torch.cuda.current_stream(h1.device).cuda_stream)
    check(rc, "grouped_ffn_gate_bwd")
    LAUNCHES["grouped_ffn_gate_bwd"] += 1
    return dh1, dh3, h


def _grouped_ffn_fwd(x, w1, w3, w2):
    """Launch the forward kernel."""
    from ._build import check, library
    E, N, D = x.shape
    Fd = w1.shape[-1]
    if not (x.device == w1.device == w3.device == w2.device):
        raise ValueError("grouped_ffn: x and the weights must share a device")
    if not (x.dtype == w1.dtype == w3.dtype == w2.dtype == torch.bfloat16):
        raise TypeError(f"grouped_ffn kernel takes bf16, got {x.dtype}/"
                        f"{w1.dtype}/{w3.dtype}/{w2.dtype}")
    if w1.shape != (E, D, Fd) or w3.shape != w1.shape \
            or w2.shape != (E, Fd, D) or D % 128 or Fd % 64:
        raise ValueError(
            f"grouped_ffn kernel: unsupported shapes x{tuple(x.shape)} "
            f"w1{tuple(w1.shape)} w3{tuple(w3.shape)} w2{tuple(w2.shape)} "
            "(D must be a multiple of 128, F of 64)")
    if N == 0:
        return torch.empty_like(x)
    # x is read in place where its TMA map allows (a Comet chunk); the
    # weights' maps take them contiguous
    x = kernel_ready(x)
    w1, w3, w2 = (kernel_ready(w.contiguous()) for w in (w1, w3, w2))
    h = torch.empty((E, N, Fd), dtype=x.dtype, device=x.device)
    y = torch.empty((E, N, D), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = library().repro_grouped_ffn_fwd(
        x.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
        h.data_ptr(), y.data_ptr(), E, N, D, Fd, x.stride(0), x.stride(1),
        stream)
    check(rc, "grouped_ffn")
    LAUNCHES["grouped_ffn"] += 1
    return y
