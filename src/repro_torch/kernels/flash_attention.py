"""Flash attention: the CUDA kernels (``csrc/flash_attention.cu``, and
``csrc/flash_attention_bwd.cu`` for its gradient) and their plain PyTorch
versions.

Replaces ``src/repro/kernels/flash_attention.py:flash_attention`` and,
for training, the reference's ``_sdpa_chunked_bwd``
(``src/repro/models/layers.py``).  q (B,Sq,H,hd), k/v (B,Sk,Hk,hd);
``kv_head`` (H,) int names the K/V head each query head reads (None:
Hk == H, head h reads head h).  Scale 1/sqrt(hd), causal mask
``kpos <= qpos`` aligned top-left even when Sq != Sk, f32 softmax, output
in q's dtype.  The kernels take bf16 and hd in {64, 128}; see the sources
for what bounds them and how.

``flash_attention`` is differentiable: where a gradient is to flow (grad
mode on and an operand that requires one) it runs ``FlashAttention``, an
autograd Function whose forward also keeps each row's log-sum-exp
(B,H,Sq) f32 and whose backward launches the backward kernel (on the
CPU: the plain forward and ``flash_attention_bwd_plain``).  Otherwise —
the serve path — the forward alone runs and writes no log-sum-exp.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import LAUNCHES, kernel_ready, sm_count

LOG2E = 1.4426950408889634


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          kv_head: Optional[torch.Tensor] = None):
    """Plain version (the port of ``kernels/ref.py:flash_attention``)."""
    if kv_head is not None:
        v = v.index_select(2, kv_head.to(v.device, torch.long))
    w = torch.softmax(_scores(q, k, causal, kv_head), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)


def _scores(q, k, causal, kv_head):
    """f32 scaled scores (B,H,Sq,Sk) of q against k read through
    ``kv_head``, the causal entries at -1e30."""
    if kv_head is not None:
        k = k.index_select(2, kv_head.to(k.device, torch.long))
    Sq, Sk, hd = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None]
        ki = torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(ki <= qi, s, torch.full((), -1e30, device=q.device))
    return s


def flash_attention_lse_plain(q, k, causal: bool = True,
                              kv_head: Optional[torch.Tensor] = None):
    """Row log-sum-exp (B,H,Sq) f32 of the scaled, masked scores: what the
    kernel keeps for the backward."""
    return torch.logsumexp(_scores(q, k, causal, kv_head), dim=-1)


def _kv_sum(t, kv_head, Hk):
    """(B,S,H,hd) per q head -> (B,S,Hk,hd): each K/V head's sum over the
    q heads ``kv_head`` maps to it, in head order."""
    if kv_head is None:
        return t
    out = t.new_zeros(t.shape[:2] + (Hk,) + t.shape[3:])
    return out.index_add_(2, kv_head.to(t.device, torch.long), t)


def flash_attention_bwd_plain(q, k, v, o, do, lse, causal: bool = True,
                              kv_head: Optional[torch.Tensor] = None):
    """Plain backward: (dq, dk, dv) of ``flash_attention`` at cotangent
    ``do``, from its output ``o`` and row log-sum-exp ``lse`` (the port of
    ``src/repro/models/layers.py:_sdpa_chunked_bwd`` with the GQA map: dK
    and dV of a K/V head sum over the q heads that ``kv_head`` maps to
    it).  f32 throughout; dq in q's dtype, dk and dv in k's and v's."""
    hd, Hk = q.shape[-1], k.shape[2]
    s = _scores(q, k, causal, kv_head)
    p = torch.exp(s - lse[..., None])                        # (B,H,Sq,Sk)
    if kv_head is not None:
        idx = kv_head.to(k.device, torch.long)
        kq, vq = k.index_select(2, idx), v.index_select(2, idx)
    else:
        kq, vq = k, v
    dof = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vq.float())
    delta = torch.einsum("bqhd,bqhd->bhq", dof, o.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kq.float()) / math.sqrt(hd)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) / math.sqrt(hd)
    return (dq.to(q.dtype), _kv_sum(dk, kv_head, Hk).to(k.dtype),
            _kv_sum(dv, kv_head, Hk).to(v.dtype))


def flash_attention(q, k, v, *, causal: bool = True,
                    kv_head: Optional[torch.Tensor] = None):
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, kv_head)
    if q.device.type != "cuda":
        return flash_attention_plain(q, k, v, causal=causal, kv_head=kv_head)
    return _flash_fwd(q, k, v, causal, kv_head)[0]


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its gradient: the forward keeps the row
    log-sum-exp, the backward launches ``csrc/flash_attention_bwd.cu`` on
    a CUDA tensor and runs ``flash_attention_bwd_plain`` on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, kv_head):
        if q.device.type == "cuda":
            o, lse = _flash_fwd(q, k, v, causal, kv_head, lse=True)
        else:
            o = flash_attention_plain(q, k, v, causal=causal, kv_head=kv_head)
            lse = flash_attention_lse_plain(q, k, causal, kv_head)
        ctx.save_for_backward(q, k, v, o, lse, kv_head)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_head = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse,
                                         causal=ctx.causal, kv_head=kv_head)
        return dq, dk, dv, None, None


def _checked(q, k, v, kv_head):
    """The kernels' operand checks; returns (q, k, v, kv_head) as the
    kernels take them."""
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
    return kernel_ready(q), kernel_ready(k), kernel_ready(v), \
        kv_head.contiguous()


def _flash_fwd(q, k, v, causal, kv_head, lse: bool = False):
    """Launch the forward kernel; returns (o, lse or None)."""
    from ._build import check, library, strides_arg
    q, k, v, kv_head = _checked(q, k, v, kv_head)
    B, Sq, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    lse_t = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
             if lse else None)
    st = strides_arg(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     *o.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if Sq == 0 or Sk == 0 or B == 0:     # no key: l = 0 gives zeros
        if lse_t is not None:
            lse_t.fill_(float("inf"))
        return o.zero_(), lse_t
    # the persistent blocks take q tiles off this counter
    counter = torch.zeros(1, dtype=torch.int32, device=q.device)
    rc = library().repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        kv_head.data_ptr(), counter.data_ptr(),
        None if lse_t is None else lse_t.data_ptr(), B, H, Hk, Sq, Sk, hd,
        st, int(causal), LOG2E / math.sqrt(hd), stream)
    check(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o, lse_t


BWD_BLOCK = 128      # keys of a dK/dV unit, q rows of a dQ unit


def flash_bwd_geometry(B: int, H: int, Hk: int, Sq: int, Sk: int, hd: int,
                       sms: int) -> dict:
    """Work split of the backward kernel (``csrc/flash_attention_bwd.cu``),
    a pure function of the shapes and the card's SM count ``sms``.

    The dK/dV pass has B * Hk * ceil(Sk / 128) units of 128 keys; where
    they cannot fill the card, each K/V head's q heads are split over
    ``splits`` units (doubling while the units are fewer than ``sms``, at
    most the H / Hk heads of a uniform map), which write f32 partial rows
    to a ``workspace`` (2, splits, B, Sk, Hk, hd) that a reduce pass sums
    in split order.  The dQ pass has B * H * ceil(Sq / 128) units.
    ``aux`` is the f32 scratch of the delta pass: lse * log2(e) and delta
    rows padded to ``sq_pad``.  ``step_rows``: the rows a step streams."""
    key_blocks = -(-Sk // BWD_BLOCK)
    base = B * Hk * key_blocks
    group = max(1, H // max(1, Hk))
    splits = 1
    while base * splits < sms and splits * 2 <= group:
        splits *= 2
    sq_pad = -(-Sq // BWD_BLOCK) * BWD_BLOCK
    return dict(step_rows=64 if hd == 128 else 128, splits=splits,
                dkdv_units=base * splits,
                dq_units=B * H * (sq_pad // BWD_BLOCK), sq_pad=sq_pad,
                aux=(2, B, H, sq_pad),
                workspace=None if splits == 1 else (2, splits, B, Sk, Hk, hd))


def flash_bwd_heads(kv_head, Hk: int, splits: int) -> dict:
    """The q heads each dK/dV unit walks, as the kernel picks them:
    {(kv head, split): heads}.  Of the cnt heads that ``kv_head`` maps to
    a K/V head, in head order, split s takes ranks
    [s * cnt // splits, (s + 1) * cnt // splits)."""
    kv_head = [int(h) for h in kv_head]
    out = {}
    for kvh in range(Hk):
        mine = [h for h, k in enumerate(kv_head) if k == kvh]
        cnt = len(mine)
        for s in range(splits):
            out[kvh, s] = mine[s * cnt // splits:(s + 1) * cnt // splits]
    return out


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        kv_head: Optional[torch.Tensor] = None):
    """(dq, dk, dv) by the backward kernel (``csrc/flash_attention_bwd.cu``)
    on CUDA tensors; ``flash_attention_bwd_plain`` on the CPU."""
    if q.device.type != "cuda":
        return flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                         kv_head=kv_head)
    from ._build import check, library, strides_arg
    q, k, v, kv_head = _checked(q, k, v, kv_head)
    B, Sq, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape \
            or lse.shape != (B, H, Sq):
        raise ValueError("flash_attention_bwd: o and do must have q's shape "
                         "and lse (B, H, Sq)")
    if o.dtype != torch.bfloat16 or do.dtype != torch.bfloat16 \
            or lse.dtype != torch.float32:
        raise TypeError("flash_attention_bwd takes bf16 o and do and an f32 "
                        "lse")
    o, do, lse = kernel_ready(o), kernel_ready(do), lse.contiguous()
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((B, Sk, Hk, hd), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    if B == 0 or Sq == 0 or Sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    geo = flash_bwd_geometry(B, H, Hk, Sq, Sk, hd,
                             sm_count(q.device.index or 0))
    aux = torch.empty(geo["aux"], dtype=torch.float32, device=q.device)
    work = (None if geo["workspace"] is None else
            torch.empty(geo["workspace"], dtype=torch.float32,
                        device=q.device))
    # the two passes' persistent blocks take units off these counters
    counter = torch.zeros(2, dtype=torch.int32, device=q.device)
    st = strides_arg(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     *o.stride()[:3], *do.stride()[:3], *dq.stride()[:3],
                     *dk.stride()[:3], *dv.stride()[:3])
    rc = library().repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), kv_head.data_ptr(), aux.data_ptr(),
        counter.data_ptr(), None if work is None else work.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, Hk, Sq, Sk, hd, st,
        int(causal), 1.0 / math.sqrt(hd), geo["splits"],
        torch.cuda.current_stream(q.device).cuda_stream)
    check(rc, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
