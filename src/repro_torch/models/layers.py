"""Schedulable model layers (manual SPMD) — the dense decoder ops.

Every layer is a DynaFlow ``Op``/``Module``: the traced graph exposes
logical operators (norm / projections / attention / collectives) so the
programmable scheduler can split, reorder, overlap and fuse them.
Kernels are written against the *local shard*; collectives go through
``dist.collectives`` and are the identity on one GPU.

Layouts follow the JAX package: linear weights are (d_in, d_out) and used
as ``x @ w``; activations are (B, S, d); attention heads (B, S, H, hd).
Attention, decode attention and RMSNorm go through ``kernels.ops`` — the
Hopper kernels on a CUDA tensor, their plain versions on the CPU.
The MoE ops live in ``moe.py``, the Mamba2 ops in ``mamba2.py``, the
hybrid's shared block in ``hybrid.py`` and Whisper's encoder-decoder
ops in ``whisper.py``.  Under ``mesh.fsdp`` a ``ShardedLinear`` stores
its weight data-sharded and gathers it with a schedulable network op
(``WeightGatherOp``), or under ``fsdp_resident`` keeps it sharded and
psums the partial product (``DataShardedLinearOp``).  The training head
(``HeadLossOp``) computes its loss and its gradient chunk by chunk
(``HeadLoss``), so no step holds more than one chunk's logits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.module import Module, Op, Param, TensorSpec
from ..dist import collectives as col

# ---------------------------------------------------------------------------
# config plumbing
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MeshInfo:
    """Static mesh-shape info modules need at construction time.

    The JAX package's ``attn_impl`` execution hint is left out: the
    port's attention route is fixed by the kernels it dispatches to
    (``models/base.py:KERNEL_SET``)."""

    tp: int = 1        # 'model' axis size
    dp: int = 1        # 'data' axis size
    pods: int = 1      # 'pod' axis size (1 = single pod)
    fsdp: bool = False  # ZeRO-3: shard params over 'data' too
    fsdp_resident: bool = False  # decode: keep data-sharded weights
                                 # resident (partial matmul + tiny psum)
                                 # instead of per-step all-gathers

    @property
    def dp_axes(self):
        return ("pod", "data") if self.pods > 1 else ("data",)


def make_param(local_shape, dtype, pspec, mesh: MeshInfo, init=None) -> Param:
    """Declare a param by LOCAL shape + partition spec; derive global.
    Axes of size 1 are dropped from the stored pspec."""
    sizes = {"model": mesh.tp, "data": mesh.dp, "pod": mesh.pods}
    gshape, eff_spec = [], []
    for d, names in zip(local_shape, tuple(pspec) + ((),) * (len(local_shape) - len(pspec))):
        if names is None or names == ():
            gshape.append(d)
            eff_spec.append(())
            continue
        if isinstance(names, str):
            names = (names,)
        names = tuple(n for n in names if sizes.get(n, 1) > 1)
        mult = 1
        for n in names:
            mult *= sizes[n]
        gshape.append(d * mult)
        eff_spec.append(names)
    return Param(tuple(local_shape), dtype, init=init, pspec=tuple(eff_spec),
                 global_shape=tuple(gshape))


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


# ---------------------------------------------------------------------------
# elementary ops
# ---------------------------------------------------------------------------


class LinearOp(Op):
    """Local matmul over the last dim.  Sharding is encoded in shapes.

    With ``owns_weight=False`` the weight arrives as a second *input*
    tensor (produced by a ``WeightGatherOp`` under FSDP) instead of a
    parameter — which is exactly what makes the weight gather schedulable.
    """

    resource = "compute"

    def __init__(self, d_in, d_out, name, mesh: MeshInfo,
                 pspec=((), ("model",)), dtype=torch.bfloat16,
                 owns_weight=True):
        super().__init__()
        self._shape = (d_in, d_out)
        if owns_weight:
            self.w = make_param((d_in, d_out), dtype, pspec, mesh)
        self.named(name)

    def kernel(self, p, x, *maybe_w):
        return torch.matmul(x, maybe_w[0] if maybe_w else p["w"])

    def flops_estimate(self, in_shapes):
        b = _numel(in_shapes[0].shape[:-1])
        return 2.0 * b * _numel(self._shape)


class WeightGatherOp(Op):
    """FSDP: all-gather a data-axis-sharded weight before use (network).

    This is the paper's §2.1 'prefetch the next layer's weight shards in
    parallel with computation' made a first-class schedulable op.  The
    gather dim adapts to divisibility (row-parallel weights whose input
    dim is not a dp multiple shard the output dim instead).
    """

    resource = "network"
    out_batch_dim = None

    def __init__(self, local_shape, name, mesh: MeshInfo,
                 pspec=((), ("model",)), dtype=torch.bfloat16):
        super().__init__()
        self.mesh = mesh
        self._full = tuple(local_shape)
        gdim = next(i for i in range(len(local_shape))
                    if local_shape[i] % mesh.dp == 0)
        self.gdim = gdim
        shape = list(local_shape)
        shape[gdim] //= mesh.dp
        spec = [tuple(e) for e in pspec]
        spec[gdim] = tuple(spec[gdim]) + ("data",)
        self.w = make_param(tuple(shape), dtype, tuple(spec), mesh)
        self.named(name)

    def kernel(self, p):
        return col.all_gather(p["w"], "data", dim=self.gdim)

    def infer_out(self, in_shapes):
        return TensorSpec(self._full, self.w.dtype)


class RMSNormOp(Op):
    resource = "memory"

    def __init__(self, d, name="rmsnorm", dtype=torch.bfloat16, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.g = Param((d,), dtype,
                       init=lambda gen, s, dt, dev: torch.ones(s, dtype=dt,
                                                               device=dev),
                       pspec=((),), global_shape=(d,))
        self.named(name)

    def kernel(self, p, x):
        from ..kernels import ops as kops
        return kops.rmsnorm(x, p["g"], eps=self.eps)


class AddOp(Op):
    resource = "memory"

    def __init__(self, name="residual_add"):
        super().__init__()
        self.named(name)

    def kernel(self, p, a, b):
        return a + b


class SwiGLUOp(Op):
    """Fused gate activation: silu(gate) * up  (memory-bound)."""

    resource = "memory"

    def __init__(self, name="swiglu"):
        super().__init__()
        self.named(name)

    def kernel(self, p, gate_up):
        gate, up = torch.chunk(gate_up, 2, dim=-1)
        return F.silu(gate.float()).to(gate.dtype) * up


class GELUOp(Op):
    """GELU in f32 (memory-bound): the tanh form, ``jax.nn.gelu``'s
    default, where ``F.gelu``'s own default is the erf form."""

    resource = "memory"

    def __init__(self, name="gelu"):
        super().__init__()
        self.named(name)

    def kernel(self, p, x):
        return F.gelu(x.float(), approximate="tanh").to(x.dtype)


# ---------------------------------------------------------------------------
# collectives as schedulable network ops
# ---------------------------------------------------------------------------


class PsumOp(Op):
    resource = "network"

    def __init__(self, axis="model", name="allreduce"):
        super().__init__()
        self.axis = axis
        self.named(name)

    def kernel(self, p, x):
        return col.psum(x, self.axis)

    def infer_out(self, in_shapes):
        return in_shapes[0]


class ReduceScatterOp(Op):
    """psum_scatter over ``dim`` (SP entry: partial sums -> seq shards)."""

    resource = "network"

    def __init__(self, mesh: MeshInfo, axis="model", dim=1, name="reduce_scatter"):
        super().__init__()
        self.axis, self.dim, self.mesh = axis, dim, mesh
        self.named(name)

    def kernel(self, p, x):
        return col.reduce_scatter(x, self.axis, dim=self.dim)

    def infer_out(self, in_shapes):
        s = list(in_shapes[0].shape)
        n = self.mesh.tp if self.axis == "model" else self.mesh.dp
        assert s[self.dim] % n == 0, (s, self.dim, n)
        s[self.dim] //= n
        return TensorSpec(tuple(s), in_shapes[0].dtype)


class AllGatherOp(Op):
    """all-gather over ``dim`` (SP exit: seq shards -> full sequence)."""

    resource = "network"

    def __init__(self, mesh: MeshInfo, axis="model", dim=1, name="all_gather"):
        super().__init__()
        self.axis, self.dim, self.mesh = axis, dim, mesh
        self.named(name)

    def kernel(self, p, x):
        return col.all_gather(x, self.axis, dim=self.dim)

    def infer_out(self, in_shapes):
        s = list(in_shapes[0].shape)
        n = self.mesh.tp if self.axis == "model" else self.mesh.dp
        s[self.dim] *= n
        return TensorSpec(tuple(s), in_shapes[0].dtype)


class DataShardedLinearOp(Op):
    """Decode-path ZeRO alternative: the weight's input dim stays sharded
    over 'data' (resident, never gathered); each rank multiplies its x
    slice and a psum over 'data' completes the contraction.  Trades
    d_in·d_out weight-gather bytes for d_out activation bytes — a huge
    win whenever tokens << d_in (single-token decode)."""

    resource = "compute"

    def __init__(self, d_in, d_out, name, mesh: MeshInfo,
                 pspec=((), ("model",)), dtype=torch.bfloat16):
        super().__init__()
        assert d_in % mesh.dp == 0, (name, d_in, mesh.dp)
        self.d_loc = d_in // mesh.dp
        self._shape = (d_in, d_out)
        self.w = make_param((self.d_loc, d_out), dtype,
                            (tuple(pspec[0]) + ("data",), pspec[1]), mesh)
        self.named(name)

    def kernel(self, p, x):
        xs = x.narrow(x.ndim - 1, col.axis_index("data") * self.d_loc,
                      self.d_loc)
        return col.psum(torch.matmul(xs, p["w"]), "data")

    def infer_out(self, in_shapes):
        s = list(in_shapes[0].shape)
        s[-1] = self._shape[1]
        return TensorSpec(tuple(s), self.w.dtype)

    def flops_estimate(self, in_shapes):
        b = _numel(in_shapes[0].shape[:-1])
        return 2.0 * b * self.d_loc * self._shape[1]


class ShardedLinear(Module):
    """Linear with optional FSDP: when ``mesh.fsdp`` the weight is stored
    data-sharded and re-assembled by a schedulable WeightGather (network)
    op — the ZeRO-3 prefetch-overlap target.  ``mesh.fsdp_resident``
    (decode) keeps the shard resident and psums the partial output
    instead (see DataShardedLinearOp).  ``mode`` names the one built:
    ``"plain"``, ``"gather"`` or ``"resident"``."""

    def __init__(self, d_in, d_out, name, mesh: MeshInfo,
                 pspec=((), ("model",)), dtype=torch.bfloat16, fsdp=None):
        super().__init__()
        fsdp = mesh.fsdp if fsdp is None else fsdp
        if fsdp and mesh.fsdp_resident and d_in % mesh.dp == 0:
            self.mode = "resident"
            self.lin = DataShardedLinearOp(d_in, d_out, name, mesh,
                                           pspec=pspec, dtype=dtype)
        elif fsdp:
            self.mode = "gather"
            self.gather = WeightGatherOp((d_in, d_out), f"{name}_wgather",
                                         mesh, pspec=pspec, dtype=dtype)
            self.lin = LinearOp(d_in, d_out, name, mesh, pspec=pspec,
                                dtype=dtype, owns_weight=False)
        else:
            self.mode = "plain"
            self.lin = LinearOp(d_in, d_out, name, mesh, pspec=pspec,
                                dtype=dtype)
        self.named(name)

    def forward(self, x):
        if self.mode == "gather":
            return self.lin(x, self.gather())
        return self.lin(x)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def _rope_angles(positions, dim, base=10000.0, dtype=torch.float32):
    """positions (...,) -> cos/sin (..., dim/2)."""
    inv = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, cos, sin):
    """x (..., hd_rot) with hd_rot even; NeoX-style half rotation."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def rope_full(q, k, positions, base=10000.0):
    """Standard llama RoPE over the whole head dim.
    q (B,S,H,hd), positions (B,S)."""
    hd = q.shape[-1]
    cos, sin = _rope_angles(positions, hd, base, q.dtype)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def rope_partial(q, k, positions, fraction=0.5, base=10000.0):
    """ChatGLM-style 2d RoPE: rotate only the first ``fraction`` of hd."""
    hd = q.shape[-1]
    rot = int(hd * fraction)
    cos, sin = _rope_angles(positions, rot, base, q.dtype)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]

    def app(x):
        return torch.cat([apply_rope(x[..., :rot], cos, sin), x[..., rot:]],
                         -1)

    return app(q), app(k)


def rope_mrope(q, k, positions3, sections=(16, 24, 24), base=10000.0):
    """Qwen2-VL M-RoPE: the head dim's halves split into (t, h, w)
    sections, each rotated by its own position stream.  The inverse
    frequencies run over the whole head dim and are sliced by section.
    positions3 (3, B, S)."""
    hd = q.shape[-1]
    assert sum(sections) == hd // 2, (sections, hd)
    inv = 1.0 / (base ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=q.device) / hd))
    cos_parts, sin_parts = [], []
    offset = 0
    for sec, pos in zip(sections, positions3):
        ang = pos.float()[..., None] * inv[offset:offset + sec]
        cos_parts.append(torch.cos(ang))
        sin_parts.append(torch.sin(ang))
        offset += sec
    cos = torch.cat(cos_parts, -1).to(q.dtype)[:, :, None, :]
    sin = torch.cat(sin_parts, -1).to(q.dtype)[:, :, None, :]
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def _rope_none(q, k, positions, **kw):
    return q, k


ROPE_FNS = {"full": rope_full, "partial2d": rope_partial,
            "mrope": rope_mrope, "none": _rope_none}


# ---------------------------------------------------------------------------
# GQA head layout under TP
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HeadLayout:
    """Static mapping of (padded) Q heads / replicated KV heads to shards."""

    n_q: int                 # true q heads
    n_kv: int                # true kv heads
    tp: int
    head_dim: int

    @property
    def q_pad(self) -> int:  # padded q heads (multiple of tp)
        return ((self.n_q + self.tp - 1) // self.tp) * self.tp

    @property
    def q_local(self) -> int:
        return self.q_pad // self.tp

    def kv_ids_for_shard(self, s: int) -> list[int]:
        """Distinct true-KV head ids shard ``s`` needs (>=1)."""
        group = max(1, self.n_q // self.n_kv)
        ids = []
        for i in range(self.q_local):
            h = s * self.q_local + i
            kv = min(h // group, self.n_kv - 1)
            if kv not in ids:
                ids.append(kv)
        return ids

    @property
    def kv_local(self) -> int:
        return max(len(self.kv_ids_for_shard(s)) for s in range(self.tp))

    def q_slot_map(self) -> np.ndarray:
        """(tp, q_local): local KV slot each local q head attends to."""
        m = np.zeros((self.tp, self.q_local), np.int32)
        group = max(1, self.n_q // self.n_kv)
        for s in range(self.tp):
            ids = self.kv_ids_for_shard(s)
            for i in range(self.q_local):
                h = s * self.q_local + i
                kv = min(h // group, self.n_kv - 1)
                m[s, i] = ids.index(kv)
        return m

    def q_valid_map(self) -> np.ndarray:
        """(tp, q_local) 1.0 for true heads, 0.0 for padding heads."""
        m = np.zeros((self.tp, self.q_local), np.float32)
        for s in range(self.tp):
            for i in range(self.q_local):
                m[s, i] = 1.0 if s * self.q_local + i < self.n_q else 0.0
        return m


class _ShardMaps:
    """This shard's q-slot / q-valid maps as tensors, cached per device
    (the kernels read the slot map on the device they run on)."""

    def __init__(self, layout: HeadLayout):
        self.layout = layout
        self._cache: dict = {}

    def get(self, device):
        key = (str(device), col.axis_index("model"))
        hit = self._cache.get(key)
        if hit is None:
            s = key[1]
            slot = torch.from_numpy(self.layout.q_slot_map()[s].copy())
            valid = self.layout.q_valid_map()[s]
            hit = (slot.to(device),
                   None if valid.all() else torch.from_numpy(valid.copy()).to(device))
            self._cache[key] = hit
        return hit


# ---------------------------------------------------------------------------
# attention ops
# ---------------------------------------------------------------------------


def _sdpa(q, k, v, causal: bool, valid_len=None):
    """Reference attention.  q (B,Sq,H,hd), k/v (B,Sk,H,hd).
    ``valid_len``: scalar, (B,) per-request cache lengths, or (B,Sq)
    per-query-position lengths (chunked decode: position j of the chunk
    sees ``cache_len + j + 1`` keys)."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    dev = q.device
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(hd)
    neg = torch.full((), -1e30, device=dev)
    if causal:
        qi = torch.arange(Sq, device=dev)[:, None]
        ki = torch.arange(Sk, device=dev)[None, :]
        logits = torch.where(ki <= qi, logits, neg)
    if valid_len is not None:
        vl = torch.as_tensor(valid_len, device=dev)
        if vl.ndim == 2:                    # (B,Sq) -> (B,1,Sq,1)
            vl = vl[:, None, :, None]
        elif vl.ndim:                       # (B,)   -> (B,1,1,1)
            vl = vl.reshape(-1, 1, 1, 1)
        ki = torch.arange(Sk, device=dev)[None, None, None, :]
        logits = torch.where(ki < vl, logits, neg)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


class RopeOp(Op):
    """Apply rotary embeddings to q and k (its own schedulable memory op)."""

    resource = "memory"

    def __init__(self, rope: str = "full", rope_kw: Optional[dict] = None,
                 name="rope"):
        super().__init__()
        if rope not in ROPE_FNS:
            raise NotImplementedError(f"rope {rope!r} is not ported yet")
        self.rope = rope
        self.rope_kw = rope_kw or {}
        self.named(name)

    def kernel(self, p, q, k, positions):
        return ROPE_FNS[self.rope](q, k, positions, **self.rope_kw)


class AttentionOp(Op):
    """Full (prefill) attention over roped q/k with GQA slot mapping.

    Inputs: q (B,S,q_local,hd), k,v (B,S,kv_local,hd).  Runs the flash
    kernel via ``kernels.ops`` (its plain version on the CPU), which reads
    each q head's K/V slot in place.
    """

    resource = "compute"

    def __init__(self, layout: HeadLayout, causal=True, name="attention"):
        super().__init__()
        self.layout = layout
        self.causal = causal
        self._maps = _ShardMaps(layout)
        self.named(name)

    def kernel(self, p, q, k, v):
        from ..kernels import ops as kops
        slot, valid = self._maps.get(q.device)
        out = kops.flash_attention(q, k, v, causal=self.causal, kv_head=slot)
        if valid is not None:
            out = out * valid[None, None, :, None].to(out.dtype)
        return out

    def flops_estimate(self, in_shapes):
        B, S, H, hd = in_shapes[0].shape
        return 4.0 * B * S * S * H * hd * (0.5 if self.causal else 1.0)


class DecodeAttentionOp(Op):
    """Single-token decode attention against a KV cache (memory-bound).

    Inputs: q/k_new (roped) (B,Sq,·,hd), v_new,
            k_cache/v_cache (B,S_max,kv_local,hd),
            cache_len (B,) int32 per-request lengths (ragged batch).
    Outputs: attn (B,Sq,q_local,hd), k_cache, v_cache.

    The new keys/values are written into ``k_cache``/``v_cache`` *in
    place* at each row's ``cache_len`` (this op is the caches' only
    reader), and the same tensors are returned as the updated caches.
    Sq == 1 reads the cache through the flash-decode kernel; Sq > 1
    (chunked prefill through the decode graph, the speculative verify
    step) through plain attention with a length per query position: on
    the CPU the decode kernel's plain version, which a width-1 step runs
    there too, so each position rounds as a width-1 step does (a verify
    step's greedy tokens are bitwise a plain decode step's); on the card,
    where a width-1 step runs the kernel and no plain formula rounds as
    it does, the JAX package's ``_sdpa`` (bf16 probabilities for the PV
    product: half the bytes of an f32 one).
    """

    resource = "memory"

    def __init__(self, layout: HeadLayout, name="decode_attention"):
        super().__init__()
        self.layout = layout
        self._maps = _ShardMaps(layout)
        self.named(name)

    def kernel(self, p, q, k_new, v_new, k_cache, v_cache, cache_len):
        B, Sq = q.shape[0], q.shape[1]
        clen = cache_len.to(torch.int32).reshape(-1).expand(B) \
            if cache_len.ndim == 0 else cache_len
        _write_time(k_cache, k_new, clen)
        _write_time(v_cache, v_new, clen)
        slot, valid = self._maps.get(q.device)
        if Sq == 1:
            from ..kernels import ops as kops
            out = kops.decode_attention(q, k_cache, v_cache, clen + 1,
                                        kv_head=slot)
        else:
            vl = clen[:, None] + 1 + torch.arange(Sq, dtype=clen.dtype,
                                                  device=clen.device)
            if q.device.type == "cpu":
                # the decode kernel's plain version, which a width-1 step
                # runs here: each position rounds as it would there
                from ..kernels.decode_attention import decode_attention_plain
                out = decode_attention_plain(q, k_cache, v_cache, vl,
                                             kv_head=slot)
            else:
                out = _sdpa(q, k_cache.index_select(2, slot.long()),
                            v_cache.index_select(2, slot.long()),
                            causal=False, valid_len=vl)
        if valid is not None:
            out = out * valid[None, None, :, None].to(out.dtype)
        return out, k_cache, v_cache

    def infer_out(self, in_shapes):
        q, k_new, v_new, kc, vc, clen = in_shapes
        return (TensorSpec(q.shape, q.dtype), TensorSpec(kc.shape, kc.dtype),
                TensorSpec(vc.shape, vc.dtype))

    def bytes_estimate(self, in_shapes, out_shapes):
        kc = in_shapes[3]
        return 2.0 * 2 * _numel(kc.shape)  # read K+V cache


def _write_time(cache, new, t):
    """In-place ``cache[b, t[b]:t[b]+Sq] = new[b]`` for every row ``b``.
    The write window must fit: ``t + Sq <= S_max`` is asserted on the
    device (no host sync); the JAX package's ``dynamic_update_slice``
    would clamp the start and silently shift the window instead."""
    B, Sq = new.shape[0], new.shape[1]
    pos = t.long()[:, None] + torch.arange(Sq, device=cache.device)
    torch._assert_async((pos[:, -1] < cache.shape[1]).all())
    rows = torch.arange(B, device=cache.device)[:, None]
    cache[rows, pos] = new.to(cache.dtype)


# ---------------------------------------------------------------------------
# embedding / head (vocab-sharded)
# ---------------------------------------------------------------------------


def _embed_init(gen, shape, dtype, device):
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return w.to(dtype) * 0.02


class EmbedOp(Op):
    """Vocab-sharded embedding lookup; emits a *partial* value that a
    following Psum/ReduceScatter network op completes."""

    resource = "memory"

    def __init__(self, vocab, d, mesh: MeshInfo, name="embed",
                 dtype=torch.bfloat16):
        super().__init__()
        vpad = -(-vocab // mesh.tp) * mesh.tp   # pad to a tp multiple
        self.vshard = vpad // mesh.tp
        self.w = make_param((self.vshard, d), dtype, (("model",), ()), mesh,
                            init=_embed_init)
        self.named(name)

    def kernel(self, p, ids):
        local = ids - col.axis_index("model") * self.vshard
        ok = (local >= 0) & (local < self.vshard)
        out = F.embedding(local.clamp(0, self.vshard - 1).long(), p["w"])
        return out * ok[..., None].to(out.dtype)


class LmHeadOp(Op):
    """x (B,S,d) -> logits (B,S,Vshard) vocab-sharded."""

    resource = "compute"

    def __init__(self, d, vocab, mesh: MeshInfo, name="lm_head",
                 dtype=torch.bfloat16, tie_path: Optional[tuple] = None):
        super().__init__()
        self.vocab = vocab
        self.vshard = -(-vocab // mesh.tp)
        self.tied = tie_path is not None
        if tie_path is None:
            self.w = make_param((d, self.vshard), dtype, ((), ("model",)), mesh)
        else:
            self.share_params(tie_path)
        self.named(name)

    def kernel(self, p, x):
        w = p["w"]
        if self.tied:
            w = w.t()  # embed table (Vshard, d) -> (d, Vshard)
        out = torch.matmul(x, w)
        # mask vocab-padding logits so sampling can never pick them
        gid = col.axis_index("model") * self.vshard + torch.arange(
            self.vshard, device=x.device)
        return torch.where(gid < self.vocab, out,
                           torch.full((), -1e30, dtype=out.dtype,
                                      device=x.device))

    def infer_out(self, in_shapes):
        B, S, d = in_shapes[0].shape
        return TensorSpec((B, S, self.vshard), in_shapes[0].dtype)

    def flops_estimate(self, in_shapes):
        B, S, d = in_shapes[0].shape
        return 2.0 * B * S * d * self.vshard


class ShardedXentOp(Op):
    """Cross-entropy over vocab-sharded logits (psum'd logsumexp): the
    mean over positions of lse - target.  The port of the JAX package's
    op of that name; no model of the port calls it (``HeadLossOp`` is the
    training head)."""

    resource = "compute"

    def __init__(self, mesh: MeshInfo, vshard: int, vocab: int = 0,
                 name="xent"):
        super().__init__()
        self.mesh = mesh
        self.vshard = vshard
        self.vocab = vocab or vshard * mesh.tp
        self.named(name)
        self.out_batch_dim = None  # scalar loss

    def kernel(self, p, logits, labels):
        lf = _vocab_masked(logits.float(), self.vshard, self.vocab)
        # the stability max carries no gradient (cancels in lse - tgt)
        m = col.pmax(lf.amax(-1).detach(), "model")
        se = col.psum(torch.exp(lf - m[..., None]).sum(-1), "model")
        lse = torch.log(se) + m
        tgt, ok = _target_logits(lf, labels, self.vshard)
        tgt = col.psum(tgt * ok.float(), "model")
        return torch.mean(lse - tgt)

    def infer_out(self, in_shapes):
        return TensorSpec((), torch.float32)


def _vocab_masked(logits, vshard: int, vocab: int):
    """f32 logits with the vocab-padding columns of this shard at -1e30."""
    if vshard * (col.axis_index("model") + 1) <= vocab:
        return logits
    gid = col.axis_index("model") * vshard + torch.arange(
        vshard, device=logits.device)
    return torch.where(gid < vocab, logits,
                       torch.full((), -1e30, device=logits.device))


def _target_logits(logits, labels, vshard: int):
    """(logit of each position's label where this shard holds it, whether
    it does)."""
    loc = labels.long() - col.axis_index("model") * vshard
    ok = (loc >= 0) & (loc < vshard)
    tgt = logits.gather(-1, loc.clamp(0, vshard - 1)[..., None])[..., 0]
    return tgt, ok


def _mm_f32(a, b):
    """a @ b with f32 sums of exact products: the JAX package's
    ``preferred_element_type=float32`` product of bf16 operands.  On the
    card cuBLAS takes the bf16 operands on the tensor cores and writes
    f32; on the CPU the operands are widened first."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class HeadLoss(torch.autograd.Function):
    """Seq-chunked LM head + cross entropy with its gradient, one chunk of
    logits at a time in both directions: the forward keeps only each
    position's log-sum-exp, and the backward recomputes a chunk's f32
    logits, turns them into softmax - onehot and takes dx and dW from it.
    Autograd through the plain ops would keep every chunk's f32 logits
    for the backward (3.2 GB for smollm-135m at B=8, S=2048).

    x (B,S,d); w (d,V) or, tied, the embedding table (V,d); labels (B,S)
    int (-100 ignored).  Returns (loss_sum, token_count), (B,) f32 each.
    On the card dx and dW are products of the bf16-rounded softmax -
    onehot (the tensor cores' operand type), with f32 sums."""

    @staticmethod
    def forward(ctx, x, w, labels, tied, vshard, vocab, chunk):
        B, S, d = x.shape
        wm = w.t() if tied else w                       # (d, V)
        valid = labels != -100
        lse = torch.empty((B, S), dtype=torch.float32, device=x.device)
        tok = torch.empty((B, S), dtype=torch.float32, device=x.device)
        for c0 in range(0, S, chunk):
            c = min(chunk, S - c0)
            xi = x[:, c0:c0 + c].reshape(B * c, d)
            li = labels[:, c0:c0 + c]
            logits = _vocab_masked(_mm_f32(xi, wm).reshape(B, c, -1),
                                   vshard, vocab)
            m = col.pmax(logits.amax(-1), "model")
            se = col.psum(torch.exp(logits - m[..., None]).sum(-1), "model")
            lse_i = torch.log(se) + m
            tgt, ok = _target_logits(logits, li, vshard)
            tgt = col.psum(torch.where(ok, tgt, torch.zeros((), device=x.device)),
                           "model")
            lse[:, c0:c0 + c] = lse_i
            tok[:, c0:c0 + c] = torch.where(valid[:, c0:c0 + c], lse_i - tgt,
                                            torch.zeros((), device=x.device))
        ctx.save_for_backward(x, w, labels, lse)
        ctx.cfg = (tied, vshard, vocab, chunk)
        return tok.sum(-1), valid.sum(-1).float()

    @staticmethod
    def backward(ctx, g_ls, g_cnt):
        x, w, labels, lse = ctx.saved_tensors
        tied, vshard, vocab, chunk = ctx.cfg
        B, S, d = x.shape
        wm = w.t() if tied else w                       # (d, V)
        cuda = x.device.type == "cuda"
        dx = torch.empty_like(x)
        dw = torch.zeros(wm.shape, dtype=torch.float32, device=x.device)
        # the forward's lse and target logit are psums over 'model', whose
        # transpose (the JAX package's, under ``check_vma=False``) is a
        # psum of the cotangent: identity on one rank
        scale = torch.zeros((B, S), dtype=torch.float32, device=x.device) \
            if g_ls is None else col.psum(g_ls.float(), "model")[
                :, None].expand(B, S)
        for c0 in range(0, S, chunk):
            c = min(chunk, S - c0)
            xi = x[:, c0:c0 + c].reshape(B * c, d)
            li = labels[:, c0:c0 + c]
            logits = _vocab_masked(_mm_f32(xi, wm).reshape(B, c, -1),
                                   vshard, vocab)
            p = torch.exp(logits - lse[:, c0:c0 + c, None])
            del logits
            loc = li.long() - col.axis_index("model") * vshard
            ok = (loc >= 0) & (loc < vshard)
            p.scatter_add_(-1, loc.clamp(0, vshard - 1)[..., None],
                           -ok.float()[..., None])
            p *= (scale[:, c0:c0 + c] * (li != -100).float())[..., None]
            p = p.reshape(B * c, -1)
            if cuda:
                pb = p.to(x.dtype)
                dx[:, c0:c0 + c] = torch.mm(pb, wm.t()).reshape(B, c, d)
                dw += _mm_f32(xi.t(), pb)
            else:
                dx[:, c0:c0 + c] = torch.mm(p, wm.t().float()).reshape(
                    B, c, d).to(x.dtype)
                dw += torch.mm(xi.t().float(), p)
        dw = dw.t() if tied else dw
        return dx, dw.to(w.dtype), None, None, None, None, None


class HeadLossOp(Op):
    """Fused LM head + cross entropy, seq-chunked so the (B,S,V/tp) logits
    never fully materialize (``HeadLoss``).

    Inputs x (B,S,d), labels (B,S) int32 (-100 = ignore).
    Outputs per-sample (loss_sum (B,), token_count (B,)) f32 — summed and
    normalized by the train step.
    """

    resource = "compute"

    def __init__(self, d, vocab, mesh: MeshInfo, name="head_loss",
                 dtype=torch.bfloat16, tie_path: Optional[tuple] = None,
                 chunk=512):
        super().__init__()
        self.vocab = vocab
        self.vshard = -(-vocab // mesh.tp)
        self.chunk = chunk
        self.tied = tie_path is not None
        if tie_path is None:
            self.w = make_param((d, self.vshard), dtype, ((), ("model",)), mesh)
        else:
            self.share_params(tie_path)
        self.named(name)

    def kernel(self, p, x, labels):
        return HeadLoss.apply(x, p["w"], labels, self.tied, self.vshard,
                              self.vocab, min(self.chunk, x.shape[1]))

    def infer_out(self, in_shapes):
        B = in_shapes[0].shape[0]
        return (TensorSpec((B,), torch.float32),
                TensorSpec((B,), torch.float32))

    def flops_estimate(self, in_shapes):
        B, S, d = in_shapes[0].shape
        return 2.0 * B * S * d * self.vshard


class TakeLastOp(Op):
    """Keep only the final sequence position (prefill -> next-token logits)."""

    resource = "memory"

    def __init__(self, name="take_last"):
        super().__init__()
        self.named(name)

    def kernel(self, p, x):
        return x[:, -1:, :]


# ---------------------------------------------------------------------------
# composite blocks
# ---------------------------------------------------------------------------


class MLPBlock(Module):
    """SwiGLU (or, with any other ``act``, GELU) MLP, column/row parallel
    (+SP reduce-scatter outside).  SwiGLU's ``wi`` holds gate and up,
    ``d -> 2 d_ff``; GELU's ``d -> d_ff``."""

    def __init__(self, d, d_ff, mesh: MeshInfo, name="mlp",
                 dtype=torch.bfloat16, act="swiglu"):
        super().__init__()
        assert d_ff % mesh.tp == 0, (d_ff, mesh.tp)
        ff_loc = d_ff // mesh.tp
        mult = 2 if act == "swiglu" else 1
        self.wi = ShardedLinear(d, mult * ff_loc, "mlp_in", mesh, dtype=dtype)
        self.act = SwiGLUOp() if act == "swiglu" else GELUOp()
        self.wo = ShardedLinear(ff_loc, d, "mlp_out", mesh,
                                pspec=(("model",), ()), dtype=dtype)
        self.named(name)

    def forward(self, x):
        return self.wo(self.act(self.wi(x)))


class QKVProj(Module):
    """Fused QKV projection, head-sharded; emits q/k/v split ops."""

    def __init__(self, d, layout: HeadLayout, mesh: MeshInfo, name="qkv",
                 dtype=torch.bfloat16):
        super().__init__()
        lay = layout
        hd = lay.head_dim
        self.lay = lay
        out_dim = (lay.q_local + 2 * lay.kv_local) * hd
        self.proj = ShardedLinear(d, out_dim, "qkv_proj", mesh, dtype=dtype)
        self.splitter = _QKVSplit(lay).named("qkv_split")
        self.named(name)

    def forward(self, x):
        return self.splitter(self.proj(x))


class _QKVSplit(Op):
    """Views of q, k, v inside the fused projection's output (no copy)."""

    resource = "memory"

    def __init__(self, lay: HeadLayout):
        super().__init__()
        self.lay = lay

    def kernel(self, p, qkv):
        lay = self.lay
        hd = lay.head_dim
        B, S, _ = qkv.shape
        nq, nk = lay.q_local * hd, lay.kv_local * hd
        q = qkv[..., :nq].reshape(B, S, lay.q_local, hd)
        k = qkv[..., nq:nq + nk].reshape(B, S, lay.kv_local, hd)
        v = qkv[..., nq + nk:].reshape(B, S, lay.kv_local, hd)
        return q, k, v


class OProj(Module):
    """Row-parallel attention output projection (emits partial sums)."""

    def __init__(self, d, layout: HeadLayout, mesh: MeshInfo, name="o_proj",
                 dtype=torch.bfloat16):
        super().__init__()
        self.flat = _FlattenHeads().named("flatten_heads")
        self.proj = ShardedLinear(layout.q_local * layout.head_dim, d, "o_proj",
                                  mesh, pspec=(("model",), ()), dtype=dtype)
        self.named(name)

    def forward(self, attn):
        return self.proj(self.flat(attn))


class _FlattenHeads(Op):
    resource = "memory"

    def kernel(self, p, x):
        B, S, H, hd = x.shape
        return x.reshape(B, S, H * hd)
