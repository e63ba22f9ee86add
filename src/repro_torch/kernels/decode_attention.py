"""Flash-decode: the CUDA kernel (``csrc/decode_attention.cu``) and its
plain PyTorch version.

Replaces ``src/repro/kernels/decode_attention.py:decode_attention``.
q (B,1,H,hd) against caches (B,S,Hk,hd) masked to ``cache_len`` keys
(a scalar or (B,) int32); ``kv_head`` (H,) int names the cache head each
query head reads (None: Hk == H).  f32 online softmax, output in q's
dtype.  The kernel takes bf16 and hd in {64, 128}; see the source for
what bounds it and how.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import LAUNCHES
from .flash_attention import LOG2E, _kernel_ready


def decode_attention_plain(q, k_cache, v_cache, cache_len, *,
                           kv_head: Optional[torch.Tensor] = None):
    """Plain version (the port of ``kernels/ref.py:decode_attention``)."""
    if kv_head is not None:
        idx = kv_head.to(k_cache.device, torch.long)
        k_cache = k_cache.index_select(2, idx)
        v_cache = v_cache.index_select(2, idx)
    B, _, H, hd = q.shape
    S = k_cache.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k_cache.float()) / math.sqrt(hd)
    ki = torch.arange(S, device=q.device)[None, None, None, :]
    vl = torch.as_tensor(cache_len, device=q.device)
    if vl.ndim:
        vl = vl.reshape(-1, 1, 1, 1)
    s = torch.where(ki < vl, s, torch.full((), -1e30, device=q.device))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v_cache.float()).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     kv_head: Optional[torch.Tensor] = None):
    if q.device.type != "cuda":
        return decode_attention_plain(q, k_cache, v_cache, cache_len,
                                      kv_head=kv_head)
    from ._build import check, library, strides_arg
    B, Sq, H, hd = q.shape
    S, Hk = k_cache.shape[1], k_cache.shape[2]
    if Sq != 1:
        raise ValueError(f"decode_attention kernel takes one query, got {Sq}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype == torch.bfloat16):
        raise TypeError("decode_attention kernel takes bf16")
    if hd not in (64, 128) or k_cache.shape != (B, S, Hk, hd) \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention kernel: unsupported shapes "
                         f"q{tuple(q.shape)} cache{tuple(k_cache.shape)}")
    if not (k_cache.device == v_cache.device == q.device):
        raise ValueError("decode_attention: tensors must share a device")
    if kv_head is None:
        if Hk != H:
            raise ValueError("kv_head is required when cache heads != q heads")
        kv_head = torch.arange(H, device=q.device, dtype=torch.int32)
    if kv_head.dtype != torch.int32 or kv_head.device != q.device \
            or kv_head.shape != (H,):
        raise ValueError("kv_head must be an int32 (H,) tensor on q's device")
    clen = torch.as_tensor(cache_len, device=q.device)
    if clen.dtype != torch.int32:
        raise TypeError("cache_len must be int32")
    clen = clen.expand(B).contiguous() if clen.ndim == 0 else clen.contiguous()
    if clen.shape != (B,):
        raise ValueError(f"cache_len must be () or ({B},)")
    q = _kernel_ready(q)
    k_cache, v_cache = _kernel_ready(k_cache), _kernel_ready(v_cache)
    lib = library()
    n_split = -(-S // lib.repro_decode_split_keys())
    part_o = torch.empty((B * H * n_split * hd,), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((B * H * n_split * 2,), dtype=torch.float32,
                          device=q.device)
    o = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    st = strides_arg(q.stride(0), q.stride(2), *k_cache.stride()[:3],
                     *v_cache.stride()[:3], o.stride(0), o.stride(2))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.repro_decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        clen.data_ptr(), kv_head.contiguous().data_ptr(), o.data_ptr(),
        part_o.data_ptr(), part_ml.data_ptr(), B, H, S, hd, st,
        LOG2E / math.sqrt(hd), stream)
    check(rc, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return o
