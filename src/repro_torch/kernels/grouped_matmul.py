"""Grouped expert FFN: the CUDA kernel (``csrc/grouped_ffn.cu``) and its
plain PyTorch version.

Replaces ``src/repro/kernels/grouped_matmul.py:grouped_ffn``.  Per expert
e, ``y_e = (silu(x_e @ w1_e) * (x_e @ w3_e)) @ w2_e`` with x (E, N, D),
w1/w3 (E, D, F), w2 (E, F, D); products and the gate in f32, output in
x's dtype.  The kernel takes bf16, D a multiple of 128 and F a multiple
of 64, any N >= 1, and x as a view with a unit column stride (Comet's
chunks of the dispatch buffer); see the source for what bounds it and
how.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import LAUNCHES, kernel_ready


def grouped_ffn_plain(x, w1, w3, w2):
    """Plain version (the port of ``kernels/ref.py:grouped_ffn``)."""
    xf = x.float()
    h = F.silu(torch.bmm(xf, w1.float())) * torch.bmm(xf, w3.float())
    return torch.bmm(h, w2.float()).to(x.dtype)


def grouped_ffn(x, w1, w3, w2):
    if x.device.type != "cuda":
        return grouped_ffn_plain(x, w1, w3, w2)
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
