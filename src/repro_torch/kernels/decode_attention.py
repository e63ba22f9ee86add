"""Flash-decode: the CUDA kernel (``csrc/decode_attention.cu``) and its
plain PyTorch version.

Replaces ``src/repro/kernels/decode_attention.py:decode_attention``.
q (B,1,H,hd) against caches (B,S,Hk,hd) masked to ``cache_len`` keys
(a scalar or (B,) int32); ``kv_head`` (H,) int names the cache head each
query head reads (None: Hk == H).  f32 online softmax, output in q's
dtype.  The kernel takes bf16 and hd in {64, 128}; one block serves a
whole GQA group over one chunk of keys (see the source for what bounds
it and how).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import LAUNCHES, _not_capturing, cost, kernel_ready, meta_route
from .flash_attention import LOG2E

TILE_KEYS = 256        # keys a block stages in shared memory at once
MAX_CHUNKS = 32        # blocks a row at most
MERGE_GROUPS = 4       # first-level merges a row at most (8 chunks each)
_WORK: dict = {}       # per (device, stream, geometry): partials + counters
_HEADS: dict = {}      # per (device, H): the identity kv_head map


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
    if vl.ndim == 2:            # (B, Sq): a length per query position
        vl = vl[:, None, :, None]
    elif vl.ndim:
        vl = vl.reshape(-1, 1, 1, 1)
    s = torch.where(ki < vl, s, torch.full((), -1e30, device=q.device))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v_cache.float()).to(q.dtype)


def decode_chunk(S: int) -> tuple:
    """(keys a block reads, chunks a row) for a cache of S positions:
    256-key tiles, grouped so that a row has at most ``MAX_CHUNKS``
    chunks.  A function of S alone, never of the batch or of the rows'
    lengths, so a row's output is bitwise the same at every decode tier
    and whatever its neighbours hold."""
    tiles = -(-S // TILE_KEYS)
    chunk = TILE_KEYS * max(1, -(-tiles // MAX_CHUNKS))
    return chunk, -(-S // chunk)


def decode_merge_group(H: int, Hk: int) -> int:
    """Chunks a first-level merge takes: as many as keep one merging
    block at ~256 partial rows for the GQA group of H / Hk query heads
    (32, one level, up to 8 heads a group; 16 for chatglm3-6b's 16, one
    level up to S = 4096), and at least 8, so a row needs at most 4
    first-level merges."""
    return max(MAX_CHUNKS // MERGE_GROUPS,
               min(MAX_CHUNKS, 256 // -(-H // Hk)))


def decode_geometry(B: int, S: int, H: int, Hk: int, hd: int) -> dict:
    """The launch: chunk, chunks a row, the merge group, the grid
    (chunks, B*Hk), and the workspace in 4-byte words: B*H*(chunks +
    4)*(hd+2) floats of chunk and group partials, then B*Hk*5 counters."""
    chunk, n_chunks = decode_chunk(S)
    return {"chunk": chunk, "n_chunks": n_chunks,
            "group": decode_merge_group(H, Hk), "grid": (n_chunks, B * Hk),
            "work_words": B * H * (n_chunks + MERGE_GROUPS) * (hd + 2)
            + B * Hk * (MERGE_GROUPS + 1)}


def _work(dev, stream: int, geo: tuple, words: int) -> torch.Tensor:
    """The workspace of one geometry on one stream, zeroed once: the
    kernel leaves its counters at zero for the next call."""
    key = (dev, stream, geo)
    buf = _WORK.get(key)
    if buf is None:
        _not_capturing("workspace", stream)
        buf = _WORK[key] = torch.zeros((words,), dtype=torch.float32,
                                       device=dev)
    return buf


def _identity_heads(dev, H: int) -> torch.Tensor:
    key = (dev, H)
    t = _HEADS.get(key)
    if t is None:
        t = _HEADS[key] = torch.arange(H, device=dev, dtype=torch.int32)
    return t


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     kv_head: Optional[torch.Tensor] = None):
    if q.device.type == "meta":
        # a meta cache_len holds no lengths: every row reads its whole cache
        B, Sq, H, hd = q.shape
        return meta_route(
            "decode_attention",
            cost.decode_attention([k_cache.shape[1]] * B, H,
                                  k_cache.shape[2], hd,
                                  esize=q.element_size()),
            lambda: q.new_empty((B, Sq, H, v_cache.shape[-1])))
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
            or v_cache.shape != k_cache.shape or H > 256 or S < 1:
        raise ValueError(f"decode_attention kernel: unsupported shapes "
                         f"q{tuple(q.shape)} cache{tuple(k_cache.shape)}")
    dev = q.device
    if not (k_cache.device == v_cache.device == dev):
        raise ValueError("decode_attention: tensors must share a device")
    if kv_head is None:
        if Hk != H:
            raise ValueError("kv_head is required when cache heads != q heads")
        kv_head = _identity_heads(dev, H)
    if kv_head.dtype != torch.int32 or kv_head.device != dev \
            or kv_head.shape != (H,):
        raise ValueError("kv_head must be an int32 (H,) tensor on q's device")
    clen = cache_len
    if not isinstance(clen, torch.Tensor):
        clen = torch.full((B,), int(clen), dtype=torch.int32, device=dev)
    if clen.dtype != torch.int32:
        raise TypeError("cache_len must be int32")
    if clen.device != dev:
        clen = clen.to(dev)
    if clen.ndim == 0:
        clen = clen.expand(B)
    if clen.shape != (B,):
        raise ValueError(f"cache_len must be () or ({B},)")
    q = kernel_ready(q)
    k_cache, v_cache = kernel_ready(k_cache), kernel_ready(v_cache)
    geo = decode_geometry(B, S, H, Hk, hd)
    stream = torch.cuda.current_stream(dev).cuda_stream
    work = _work(dev, stream, (B, S, H, Hk, hd), geo["work_words"])
    o = torch.empty((B, 1, H, hd), dtype=q.dtype, device=dev)
    st = strides_arg(q.stride(0), q.stride(2), *k_cache.stride()[:3],
                     *v_cache.stride()[:3], o.stride(0), o.stride(2))
    rc = library().repro_decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        clen.contiguous().data_ptr(), kv_head.contiguous().data_ptr(),
        o.data_ptr(), work.data_ptr(), B, H, Hk, S, hd, geo["chunk"],
        geo["n_chunks"], geo["group"], st, LOG2E / math.sqrt(hd), stream)
    check(rc, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return o
