"""The kernel dispatch model code calls: the attention wrappers as they
are, and the row plumbing the norm kernels need (they take (n, d) rows).

Each function takes the kernel on a CUDA tensor and the plain version on
a CPU or ``meta`` tensor (the wrappers decide; see ``__init__``).
"""
from __future__ import annotations

from . import rmsnorm as _rn
from .decode_attention import decode_attention  # noqa: F401
from .flash_attention import flash_attention  # noqa: F401
from .grouped_matmul import grouped_ffn  # noqa: F401
from .ssd_scan import ssd_scan  # noqa: F401
from .tokenweave import fused_ar_add_rmsnorm  # noqa: F401


def rmsnorm(x, g, *, eps: float = 1e-5):
    shape = x.shape
    out = _rn.rmsnorm(x.reshape(-1, shape[-1]), g, eps=eps)
    return out.reshape(shape)


def fused_add_rmsnorm(x, y, g, *, eps: float = 1e-5, block_rows: int = 256):
    shape = x.shape
    s, h = _rn.fused_add_rmsnorm(x.reshape(-1, shape[-1]),
                                 y.reshape(-1, shape[-1]), g, eps=eps,
                                 block_rows=block_rows)
    return s.reshape(shape), h.reshape(shape)
