"""Flash attention: the CUDA kernel (``csrc/flash_attention.cu``) and its
plain PyTorch version.

Replaces ``src/repro/kernels/flash_attention.py:flash_attention``.
q (B,Sq,H,hd), k/v (B,Sk,Hk,hd); ``kv_head`` (H,) int names the K/V head
each query head reads (None: Hk == H, head h reads head h).  Scale
1/sqrt(hd), causal mask ``kpos <= qpos`` aligned top-left even when
Sq != Sk, f32 softmax, output in q's dtype.  The kernel takes bf16 and
hd in {64, 128}; see the source for what bounds it and how.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import LAUNCHES, kernel_ready

LOG2E = 1.4426950408889634


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          kv_head: Optional[torch.Tensor] = None):
    """Plain version (the port of ``kernels/ref.py:flash_attention``)."""
    if kv_head is not None:
        k = k.index_select(2, kv_head.to(k.device, torch.long))
        v = v.index_select(2, kv_head.to(v.device, torch.long))
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None]
        ki = torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(ki <= qi, s, torch.full((), -1e30, device=q.device))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True,
                    kv_head: Optional[torch.Tensor] = None):
    if q.device.type != "cuda":
        return flash_attention_plain(q, k, v, causal=causal, kv_head=kv_head)
    from ._build import check, library, strides_arg
    B, Sq, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    if not (k.device == v.device == q.device):
        raise ValueError("flash_attention: q, k, v must share a device")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash_attention kernel takes bf16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if hd not in (64, 128) or k.shape != (B, Sk, Hk, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention kernel: unsupported shapes "
                         f"q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} (hd must be 64 or 128)")
    if kv_head is None:
        if Hk != H:
            raise ValueError("kv_head is required when K/V heads != q heads")
        kv_head = torch.arange(H, device=q.device, dtype=torch.int32)
    if kv_head.dtype != torch.int32 or kv_head.device != q.device \
            or kv_head.shape != (H,):
        raise ValueError("kv_head must be an int32 (H,) tensor on q's device")
    q, k, v = kernel_ready(q), kernel_ready(k), kernel_ready(v)
    kv_head = kv_head.contiguous()
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    st = strides_arg(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     *o.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if Sq == 0 or Sk == 0 or B == 0:     # no key: l = 0 gives zeros
        return o.zero_()
    # the persistent blocks take q tiles off this counter
    counter = torch.zeros(1, dtype=torch.int32, device=q.device)
    rc = library().repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        kv_head.data_ptr(), counter.data_ptr(), B, H, Hk, Sq, Sk, hd, st,
        int(causal), LOG2E / math.sqrt(hd), stream)
    check(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o
