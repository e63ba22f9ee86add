"""Chunked SSD scan (Mamba2): the CUDA kernel (``csrc/ssd_scan.cu``) and
its plain PyTorch version.

Replaces ``src/repro/kernels/ssd_scan.py:ssd_scan``.  x (b, L, H, P),
dt (b, L, H), A/D (H,), B/C (b, L, G, N) with H % G == 0; head h reads
group h // (H // G).  Chunks of Q steps (``chunk_len``: the Pallas
wrapper's rule) carry an (N, P) f32 state; all products in f32, output
in x's dtype.  The kernel takes bf16 x/B/C, f32 dt/A/D, P = 64, N in
{64, 128}, Q <= 128, and x/B/C as views with a unit last stride (column
slices of the post-conv activations); one launch a call, its chunk
products on the tensor cores, persistent blocks that hand a chain's
state on through a workspace cached per (device, stream, geometry); see
the source for what bounds it and how.
"""
from __future__ import annotations

import torch

from . import LAUNCHES, _not_capturing, kernel_ready

_WORK: dict = {}       # per (device, stream, geometry): states + flags


def chunk_len(L: int, chunk: int) -> int:
    """The chunk length Q: ``min(chunk, L)``, halved until it divides L."""
    Q = min(chunk, L)
    while L % Q:
        Q //= 2
    return max(Q, 1)


def ssd_workspace_words(b: int, H: int, N: int, P: int = 64) -> int:
    """Four-byte words of the kernel's workspace for b x H chains (a
    chain: one (batch, head)): the f32 (N, P) state a block hands to the
    next one, and a ready flag, per chain."""
    return b * H * (N * P + 1)


def _work(dev, stream: int, geo: tuple) -> torch.Tensor:
    """The workspace of one geometry on one stream, zeroed once: the
    kernel leaves its flags at zero for the next call."""
    key = (dev, stream, geo)
    buf = _WORK.get(key)
    if buf is None:
        _not_capturing("workspace", stream)
        buf = _WORK[key] = torch.zeros((ssd_workspace_words(*geo),),
                                       dtype=torch.float32, device=dev)
    return buf


def ssd_scan_plain(x, dt, A, B, C, D, *, chunk: int = 128):
    """Plain version: the chunked form of the JAX package's
    ``SSDScanOp._ref`` (``models/mamba2.py``) in the kernel's signature."""
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = chunk_len(L, chunk)
    nc = L // Q
    xf = x.float().reshape(b, nc, Q, H, P)
    dtc = dt.float().reshape(b, nc, Q, H)
    Bc = B.float().reshape(b, nc, Q, G, N).repeat_interleave(H // G, dim=3)
    Cc = C.float().reshape(b, nc, Q, G, N).repeat_interleave(H // G, dim=3)
    cum = torch.cumsum(dtc * A.float(), dim=2)      # (b,nc,Q,H) inclusive
    # intra-chunk: M[i,j] = C_i.B_j exp(cum_i - cum_j) dt_j, j <= i; the
    # exponent is masked (exp above the diagonal overflows, inf*0 = NaN)
    CB = torch.einsum("bnihs,bnjhs->bnhij", Cc, Bc)
    cumT = cum.transpose(2, 3)                      # (b,nc,H,Q)
    lower = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    expo = torch.where(lower, cumT[..., :, None] - cumT[..., None, :],
                       torch.full((), float("-inf"), device=x.device))
    M = CB * torch.exp(expo) * dtc.transpose(2, 3)[..., None, :]
    y_intra = torch.einsum("bnhij,bnjhp->bnihp", M, xf)
    # chunk states S_n = sum_j exp(cum_Q - cum_j) dt_j B_j^T x_j
    last = cum[:, :, -1:, :]
    w = torch.exp(last - cum) * dtc
    S = torch.einsum("bnjh,bnjhs,bnjhp->bnhsp", w, Bc, xf)
    gamma = torch.exp(last[:, :, 0, :])             # (b,nc,H) chunk decay
    h = torch.zeros((b, H, N, P), dtype=torch.float32, device=x.device)
    hprev = []                                      # state before chunk n
    for n in range(nc):
        hprev.append(h)
        h = h * gamma[:, n, :, None, None] + S[:, n]
    hprev = torch.stack(hprev, 1)                   # (b,nc,H,N,P)
    y_inter = torch.einsum("bnihs,bnih,bnhsp->bnihp", Cc, torch.exp(cum),
                           hprev)
    y = y_intra + y_inter + xf * D.float()[None, None, None, :, None]
    return y.reshape(b, L, H, P).to(x.dtype)


def ssd_scan(x, dt, A, B, C, D, *, chunk: int = 128):
    if x.device.type != "cuda":
        return ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk)
    from ._build import check, library, strides_arg
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if len({t.device for t in (x, dt, A, B, C, D)}) != 1:
        raise ValueError("ssd_scan: all inputs must share a device")
    if not (x.dtype == B.dtype == C.dtype == torch.bfloat16
            and dt.dtype == A.dtype == D.dtype == torch.float32):
        raise TypeError(f"ssd_scan kernel takes bf16 x/B/C and f32 dt/A/D, "
                        f"got {x.dtype}/{B.dtype}/{C.dtype} and "
                        f"{dt.dtype}/{A.dtype}/{D.dtype}")
    Q = chunk_len(L, chunk) if L else 1
    if (dt.shape != (b, L, H) or A.shape != (H,) or D.shape != (H,)
            or B.shape != (b, L, G, N) or C.shape != B.shape or G < 1
            or H % G or P != 64 or N not in (64, 128) or Q > 128
            or b > 65535):
        raise ValueError(
            f"ssd_scan kernel: unsupported shapes x{tuple(x.shape)} "
            f"dt{tuple(dt.shape)} B{tuple(B.shape)} C{tuple(C.shape)} "
            f"chunk {chunk} (P must be 64, N 64 or 128, the chunk <= 128)")
    y = torch.empty((b, L, H, P), dtype=x.dtype, device=x.device)
    if b == 0 or L == 0:
        return y
    x, B, C = kernel_ready(x), kernel_ready(B), kernel_ready(C)
    A, D = A.contiguous(), D.contiguous()
    st = strides_arg(*x.stride()[:3], *dt.stride(), *B.stride()[:3],
                     *C.stride()[:3], *y.stride()[:3])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    work = _work(x.device, stream, (b, H, N))
    rc = library().repro_ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), y.data_ptr(), b, L, H, G, P, N, Q, st,
        work.data_ptr(), stream)
    check(rc, "ssd_scan")
    LAUNCHES["ssd_scan"] += 1
    return y
