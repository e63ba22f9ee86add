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
MoE, Mamba2, FSDP weight gathers and the training head arrive with later
slices.
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
    """Static mesh-shape info modules need at construction time."""

    tp: int = 1        # 'model' axis size
    dp: int = 1        # 'data' axis size
    pods: int = 1      # 'pod' axis size (1 = single pod)
    fsdp: bool = False  # ZeRO-3: shard params over 'data' too


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
    """Local matmul over the last dim.  Sharding is encoded in shapes."""

    resource = "compute"

    def __init__(self, d_in, d_out, name, mesh: MeshInfo,
                 pspec=((), ("model",)), dtype=torch.bfloat16):
        super().__init__()
        self._shape = (d_in, d_out)
        self.w = make_param((d_in, d_out), dtype, pspec, mesh)
        self.named(name)

    def kernel(self, p, x):
        return torch.matmul(x, p["w"])

    def flops_estimate(self, in_shapes):
        b = _numel(in_shapes[0].shape[:-1])
        return 2.0 * b * _numel(self._shape)


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


class ShardedLinear(Module):
    """Linear over the local shard.  The FSDP variants (schedulable weight
    gathers, data-sharded resident weights) arrive with the training
    slice."""

    def __init__(self, d_in, d_out, name, mesh: MeshInfo,
                 pspec=((), ("model",)), dtype=torch.bfloat16, fsdp=None):
        super().__init__()
        if (mesh.fsdp if fsdp is None else fsdp):
            raise NotImplementedError("FSDP linears are not ported yet")
        self.lin = LinearOp(d_in, d_out, name, mesh, pspec=pspec, dtype=dtype)
        self.named(name)

    def forward(self, x):
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


ROPE_FNS = {"full": rope_full, "partial2d": rope_partial}


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
    (chunked prefill through the decode graph) through ``_sdpa`` with
    per-position lengths.
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
            out = _sdpa(q, k_cache.index_select(2, slot.long()),
                        v_cache.index_select(2, slot.long()), causal=False,
                        valid_len=vl)
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
    """SwiGLU MLP, column/row parallel (+SP reduce-scatter outside)."""

    def __init__(self, d, d_ff, mesh: MeshInfo, name="mlp",
                 dtype=torch.bfloat16, act="swiglu"):
        super().__init__()
        assert d_ff % mesh.tp == 0, (d_ff, mesh.tp)
        if act != "swiglu":
            raise NotImplementedError(f"activation {act!r} is not ported yet")
        ff_loc = d_ff // mesh.tp
        self.wi = ShardedLinear(d, 2 * ff_loc, "mlp_in", mesh, dtype=dtype)
        self.act = SwiGLUOp()
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
