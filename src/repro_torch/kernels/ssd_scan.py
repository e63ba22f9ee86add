"""Chunked SSD scan (Mamba2): the CUDA kernels (``csrc/ssd_scan.cu``, and
``csrc/ssd_scan_bwd.cu`` for its gradient) and their plain PyTorch
versions.

Replaces ``src/repro/kernels/ssd_scan.py:ssd_scan`` and, for training,
the reference's autodiff of ``SSDScanOp._ref`` (``models/mamba2.py``:
the Pallas kernel has no VJP).  x (b, L, H, P), dt (b, L, H), A/D (H,),
B/C (b, L, G, N) with H % G == 0; head h reads group h // (H // G).
Chunks of Q steps (``chunk_len``: the Pallas wrapper's rule) carry an
(N, P) f32 state; all products in f32, output in x's dtype.  The kernels
take bf16 x/B/C, f32 dt/A/D, P = 64, N in {64, 128}, Q <= 128, and
x/B/C as views with a unit last stride (column slices of the post-conv
activations).  The forward is one launch a call, its chunk products on
the tensor cores, persistent blocks that hand a chain's state on through
a workspace cached per (device, stream, geometry); see the sources for
what bounds them and how.

``ssd_scan`` is differentiable: where a gradient is to flow (grad mode on
and an operand that requires one) it runs ``SSDScan``, an autograd
Function that saves only its inputs; its backward recomputes each
chunk's starting state and launches ``csrc/ssd_scan_bwd.cu`` (on the
CPU: ``ssd_scan_bwd_plain``): four launches, the chunk products on the
tensor cores with the forward's numerics, a block per batch row, chunk
and set of a group's heads (``ssd_bwd_geometry``), a per-call workspace
(``ssd_bwd_workspace_words``).  Otherwise — the serve path — the forward
alone runs, as it did before training existed.
"""
from __future__ import annotations

import torch

from . import (LAUNCHES, _not_capturing, cost, kernel_ready, meta_route,
               sm_count)

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


def _compute_dtype(x):
    """f32, or f64 for f64 operands (the gradient tests' exact yardstick)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def ssd_scan_plain(x, dt, A, B, C, D, *, chunk: int = 128):
    """Plain version: the chunked form of the JAX package's
    ``SSDScanOp._ref`` (``models/mamba2.py``) in the kernel's signature."""
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = chunk_len(L, chunk)
    nc = L // Q
    ct = _compute_dtype(x)
    xf = x.to(ct).reshape(b, nc, Q, H, P)
    dtc = dt.to(ct).reshape(b, nc, Q, H)
    Bc = B.to(ct).reshape(b, nc, Q, G, N).repeat_interleave(H // G, dim=3)
    Cc = C.to(ct).reshape(b, nc, Q, G, N).repeat_interleave(H // G, dim=3)
    cum = torch.cumsum(dtc * A.to(ct), dim=2)       # (b,nc,Q,H) inclusive
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
    h = torch.zeros((b, H, N, P), dtype=ct, device=x.device)
    hprev = []                                      # state before chunk n
    for n in range(nc):
        hprev.append(h)
        h = h * gamma[:, n, :, None, None] + S[:, n]
    hprev = torch.stack(hprev, 1)                   # (b,nc,H,N,P)
    y_inter = torch.einsum("bnihs,bnih,bnhsp->bnihp", Cc, torch.exp(cum),
                           hprev)
    y = y_intra + y_inter + xf * D.to(ct)[None, None, None, :, None]
    return y.reshape(b, L, H, P).to(x.dtype)


def ssd_scan_bwd_plain(x, dt, A, B, C, D, dy, *, chunk: int = 128):
    """Plain backward: (dx, ddt, dA, dB, dC, dD) of ``ssd_scan_plain`` at
    cotangent ``dy``, chunk by chunk in the kernel's order: the chunks'
    starting states S_n walking forward, then dS' (the gradient of the
    state after each chunk) walking back, then each chunk's terms.  dx,
    dB and dC in x's dtype; ddt, dA and dD in dt's, A's and D's."""
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    R = H // G
    Q = chunk_len(L, chunk)
    nc = L // Q
    ct = _compute_dtype(x)
    xf = x.to(ct).reshape(b, nc, Q, H, P)
    dyf = dy.to(ct).reshape(b, nc, Q, H, P)
    dtc = dt.to(ct).reshape(b, nc, Q, H)
    Bc = B.to(ct).reshape(b, nc, Q, G, N).repeat_interleave(R, dim=3)
    Cc = C.to(ct).reshape(b, nc, Q, G, N).repeat_interleave(R, dim=3)
    Af, Df = A.to(ct), D.to(ct)
    cum = torch.cumsum(dtc * Af, dim=2)             # (b,nc,Q,H) inclusive
    last = cum[:, :, -1]                            # (b,nc,H)
    gamma = torch.exp(last)                         # chunk decay
    ecum = torch.exp(cum)
    w = torch.exp(last[:, :, None] - cum) * dtc     # state update weights
    # the chunks' starting states, walking forward
    Sloc = torch.einsum("bnjh,bnjhs,bnjhp->bnhsp", w, Bc, xf)
    h = torch.zeros((b, H, N, P), dtype=ct, device=x.device)
    Sn = []
    for n in range(nc):
        Sn.append(h)
        h = h * gamma[:, n, :, None, None] + Sloc[:, n]
    Sn = torch.stack(Sn, 1)                         # (b,nc,H,N,P)
    # dS' = dL/d(state after chunk n), walking back:
    # dS_n = exp(cum_Q) dS' + sum_i exp(cum_i) C_i^T dy_i
    dSloc = torch.einsum("bnih,bnihs,bnihp->bnhsp", ecum, Cc, dyf)
    g = torch.zeros_like(h)
    dSn = [None] * nc
    for n in reversed(range(nc)):
        dSn[n] = g
        g = g * gamma[:, n, :, None, None] + dSloc[:, n]
    dSn = torch.stack(dSn, 1)                       # (b,nc,H,N,P)
    # intra-chunk: M = C B^T E dt_j (E the masked decay), Z = (dy x^T) E
    # dt_j its cotangent's counterpart, K = (dy x^T) (C B^T) E
    cumT = cum.transpose(2, 3)                      # (b,nc,H,Q)
    lower = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    expo = torch.where(lower, cumT[..., :, None] - cumT[..., None, :],
                       torch.full((), float("-inf"), dtype=ct,
                                  device=x.device))
    E = torch.exp(expo)                             # (b,nc,H,Q,Q)
    dtT = dtc.transpose(2, 3)[..., None, :]         # dt_j
    CB = torch.einsum("bnihs,bnjhs->bnhij", Cc, Bc)
    Gm = torch.einsum("bnihp,bnjhp->bnhij", dyf, xf)
    M = CB * E * dtT
    Z = Gm * E * dtT
    K = Gm * CB * E
    # dx_j = sum_{i>=j} M_ij dy_i + w_j B_j dS' + D dy_j
    dx = (torch.einsum("bnhij,bnihp->bnjhp", M, dyf)
          + w[..., None] * torch.einsum("bnjhs,bnhsp->bnjhp", Bc, dSn)
          + Df[None, None, None, :, None] * dyf)
    # dC_i = sum_{j<=i} Z_ij B_j + exp(cum_i) S_n dy_i
    dC_inter = ecum[..., None] * torch.einsum("bnhsp,bnihp->bnihs", Sn, dyf)
    dCh = torch.einsum("bnhij,bnjhs->bnihs", Z, Bc) + dC_inter
    # dB_j = sum_{i>=j} Z_ij C_i + w_j dS' x_j
    q = torch.einsum("bnhsp,bnjhp->bnjhs", dSn, xf)
    dBh = torch.einsum("bnhij,bnihs->bnjhs", Z, Cc) + w[..., None] * q
    # the decay: dcum through E (rows +, columns -), the inter term, the
    # state update's weights and the chunk decay (at the last step)
    r = torch.exp(last[:, :, None] - cum) * (Bc * q).sum(-1)   # (b,nc,Q,H)
    v = r * dtc
    u = (Cc * dC_inter).sum(-1)
    rowK = (K * dtT).sum(-1).transpose(2, 3)         # sum_j K_ij dt_j
    colK = K.sum(-2).transpose(2, 3)                 # sum_i K_ij
    dcum = rowK - colK * dtc + u - v
    tail = v.sum(2) + gamma * (Sn * dSn).sum((-1, -2))
    dcum = torch.cat([dcum[:, :, :-1], dcum[:, :, -1:] + tail[:, :, None]],
                     dim=2)
    da = dcum.flip(2).cumsum(2).flip(2)              # reverse cumsum
    ddt = colK + r + da * Af
    dA = (da * dtc).sum((0, 1, 2))
    dD = (dyf * xf).sum((0, 1, 2, 4))
    dB = dBh.reshape(b, nc, Q, G, R, N).sum(4)
    dC = dCh.reshape(b, nc, Q, G, R, N).sum(4)
    return (dx.reshape(b, L, H, P).to(x.dtype),
            ddt.reshape(b, L, H).to(dt.dtype), dA.to(A.dtype),
            dB.reshape(b, L, G, N).to(B.dtype),
            dC.reshape(b, L, G, N).to(C.dtype), dD.to(D.dtype))


def ssd_scan(x, dt, A, B, C, D, *, chunk: int = 128):
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C, D)):
        return SSDScan.apply(x, dt, A, B, C, D, chunk)
    if x.device.type == "meta":
        return _ssd_meta(x, B, chunk)
    if x.device.type != "cuda":
        return ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk)
    return _ssd_fwd(x, dt, A, B, C, D, chunk)


class SSDScan(torch.autograd.Function):
    """``ssd_scan`` with its gradient.  The forward is the serve path's
    (the kernel on a CUDA tensor, ``ssd_scan_plain`` on the CPU) and saves
    only its inputs: the backward recomputes the chunks' states."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, chunk):
        if x.device.type == "cuda":
            y = _ssd_fwd(x, dt, A, B, C, D, chunk)
        elif x.device.type == "meta":
            y = _ssd_meta(x, B, chunk)
        else:
            y = ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk)
        ctx.save_for_backward(x, dt, A, B, C, D)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        return (*ssd_scan_bwd(*ctx.saved_tensors, dy, chunk=ctx.chunk),
                None)


def _ssd_meta(x, B, chunk):
    b, L, H, P = x.shape
    return meta_route(
        "ssd_scan",
        cost.ssd_scan(b, L, H, P, B.shape[2], B.shape[3],
                      chunk_len(L, chunk)),
        lambda: x.new_empty(x.shape))


def _checked(x, dt, A, B, C, D, chunk, what):
    """The kernels' operand checks; returns the chunk length Q."""
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if len({t.device for t in (x, dt, A, B, C, D)}) != 1:
        raise ValueError(f"{what}: all inputs must share a device")
    if not (x.dtype == B.dtype == C.dtype == torch.bfloat16
            and dt.dtype == A.dtype == D.dtype == torch.float32):
        raise TypeError(f"{what} kernel takes bf16 x/B/C and f32 dt/A/D, "
                        f"got {x.dtype}/{B.dtype}/{C.dtype} and "
                        f"{dt.dtype}/{A.dtype}/{D.dtype}")
    Q = chunk_len(L, chunk) if L else 1
    if (dt.shape != (b, L, H) or A.shape != (H,) or D.shape != (H,)
            or B.shape != (b, L, G, N) or C.shape != B.shape or G < 1
            or H % G or P != 64 or N not in (64, 128) or Q > 128
            or b > 65535):
        raise ValueError(
            f"{what} kernel: unsupported shapes "
            f"x{tuple(x.shape)} dt{tuple(dt.shape)} B{tuple(B.shape)} "
            f"C{tuple(C.shape)} chunk {chunk} (P must be 64, N 64 or 128, "
            f"the chunk <= 128)")
    return Q


def _ssd_fwd(x, dt, A, B, C, D, chunk):
    """Launch the forward kernel."""
    from ._build import check, library, strides_arg
    Q = _checked(x, dt, A, B, C, D, chunk, "ssd_scan")
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
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


def ssd_bwd_workspace_words(b: int, L: int, H: int, G: int, N: int, Q: int,
                            sets: int, P: int = 64) -> int:
    """Four-byte words of the backward's per-call workspace: per chain and
    chunk two slabs of N x P words (the chunk's own state terms in f32,
    which the walk turns in place into S_n and dS' as bf16 high and low
    tiles); dB and dC per head set, f32 (b, L, G, sets, N) each, where a
    group has more than one set; per (chain, chunk) the chunk decay, the
    dA and dD parts and the walk's N * P / 128 warps' parts of <S_n, dS'>."""
    nc = L // Q
    parts = 2 * b * L * G * sets * N if sets > 1 else 0
    return 2 * b * H * nc * N * P + parts + b * H * nc * (3 + N * P // 128)


def ssd_bwd_geometry(b: int, L: int, H: int, G: int, N: int, Q: int,
                     sms: int) -> dict:
    """Work split of the backward's states and chunk passes, a pure
    function of the shapes and the card's SM count ``sms``.

    A unit is a batch row, a chunk and a set of consecutive heads of one
    group; a block runs one (a whole SM's shared memory), so it loads the
    chunk's B and C once for its heads and sums dB and dC over them in
    head order.  The ``sets`` a group is cut into are the fewest for which
    the busiest SM runs the fewest head-chunks, ``span`` (units in waves of
    ``sms``, each as long as its largest set); set k of R = H / G heads
    takes ranks [k R // sets, (k + 1) R // sets) (``ssd_bwd_heads``)."""
    nc, R = L // Q, H // G
    span, sets = min((-(-(b * G * k * nc) // sms) * -(-R // k), k)
                     for k in range(1, R + 1))
    return dict(sets=sets, units=b * G * sets * nc, span=span,
                heads_per_unit=-(-R // sets),
                words=ssd_bwd_workspace_words(b, L, H, G, N, Q, sets))


def ssd_bwd_heads(H: int, G: int, sets: int) -> dict:
    """The heads each unit of a chunk takes, as the kernels pick them:
    {(group, set): heads}."""
    R = H // G
    return {(g, k): list(range(g * R + k * R // sets,
                               g * R + (k + 1) * R // sets))
            for g in range(G) for k in range(sets)}


def ssd_scan_bwd(x, dt, A, B, C, D, dy, *, chunk: int = 128):
    """(dx, ddt, dA, dB, dC, dD) by the backward kernels
    (``csrc/ssd_scan_bwd.cu``) on CUDA tensors; ``ssd_scan_bwd_plain`` on
    the CPU; the meta route on ``meta``.  Per-call buffers come from
    ``torch.empty`` (the graph's pool under capture); the kernels write
    every word they read."""
    if x.device.type == "meta":
        b, L, H, P = x.shape
        return meta_route(
            "ssd_scan_bwd",
            cost.ssd_scan_bwd(b, L, H, P, B.shape[2], B.shape[3],
                              chunk_len(L, chunk)),
            lambda: tuple(t.new_empty(t.shape)
                          for t in (x, dt, A, B, C, D)))
    if x.device.type != "cuda":
        return ssd_scan_bwd_plain(x, dt, A, B, C, D, dy, chunk=chunk)
    from ._build import check, library, strides_arg
    Q = _checked(x, dt, A, B, C, D, chunk, "ssd_scan_bwd")
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"ssd_scan_bwd: dy must be like x, got "
                         f"{dy.dtype}{tuple(dy.shape)} on {dy.device}")
    dev = x.device
    dx = torch.empty((b, L, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, L, H), dtype=torch.float32, device=dev)
    dA = torch.empty((H,), dtype=torch.float32, device=dev)
    dD = torch.empty((H,), dtype=torch.float32, device=dev)
    dB = torch.empty((b, L, G, N), dtype=B.dtype, device=dev)
    dC = torch.empty((b, L, G, N), dtype=C.dtype, device=dev)
    if b == 0 or L == 0:
        return tuple(t.zero_() for t in (dx, ddt, dA, dB, dC, dD))
    x, B, C, dy = (kernel_ready(x), kernel_ready(B), kernel_ready(C),
                   kernel_ready(dy))
    A, D = A.contiguous(), D.contiguous()
    geo = ssd_bwd_geometry(b, L, H, G, N, Q, sm_count(dev.index or 0))
    work = torch.empty((geo["words"],), dtype=torch.float32, device=dev)
    st = strides_arg(*x.stride()[:3], *dt.stride(), *B.stride()[:3],
                     *C.stride()[:3], *dy.stride()[:3])
    rc = library().repro_ssd_scan_bwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        dD.data_ptr(), b, L, H, G, P, N, Q, geo["sets"], st, work.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "ssd_scan_bwd")
    LAUNCHES["ssd_scan_bwd"] += 1
    return dx, ddt, dA, dB, dC, dD
