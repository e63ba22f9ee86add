"""Mamba2 (SSD — state-space duality) layers; mamba2-2.7b / zamba2 blocks.

TP shards heads/channels over 'model'; the sequence is replicated across
the model axis (an SSD scan is sequential in L, so Megatron-style sequence
partition does not apply).

Schedulable ops per layer:  norm (memory) → in_proj (compute) →
conv1d (memory) → ssd_scan (compute) → gated norm (memory) →
out_proj (compute) → all-reduce (network).

The full-sequence scan goes through ``kernels.ops.ssd_scan`` — the Hopper
kernel on a CUDA tensor, its plain version (the chunked form the JAX
package's model runs) on the CPU.  The convolutions, the gated norm and
the one-token decode update are plain PyTorch, as the JAX package left
them to XLA.  The convolutions are unrolled f32 sums over the 4 taps, not
``F.conv1d``: on the card cuDNN runs an f32 convolution in TF32 by
default.

Training runs the prefill's layer stack (``layer_stacks("train")``) into
``TrainHead``.  Where a gradient flows the scan is the ``SSDScan``
autograd Function: its forward is the serve path's and saves only the
scan's inputs; its backward recomputes each chunk's starting state and
launches ``csrc/ssd_scan_bwd.cu`` (its chunk products on the tensor
cores; on the CPU ``ssd_scan_bwd_plain``, the VJP of the reference's
``SSDScanOp._ref`` written out chunk by chunk).  The conv, the softplus and the gated norm train under autograd
as plain PyTorch, as the reference leaves them to XLA's autodiff.

Decode keeps two caches per layer: conv_state (B, W-1, ch_loc) and
ssm_state (B, H_loc, N, P) — O(1) per token.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..core.module import Module, Op, TensorSpec
from .base import EmbedSegment, LMBase, LogitsHead, TrainHead
from .layers import (AddOp, make_param, MeshInfo, PsumOp, RMSNormOp,
                     ShardedLinear)


def ssm_dims(cfg: ArchConfig, tp: int):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    assert H % tp == 0, (H, tp)
    H_loc = H // tp
    d_in_loc = H_loc * s.head_dim
    ch_loc = d_in_loc + 2 * s.n_groups * s.state  # conv channels (x,B,C)
    return d_in, d_in_loc, H, H_loc, ch_loc


def _conv_init(gen, shape, dtype, device):
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (w * 0.1).to(dtype)


def _zeros(gen, shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def _ones(gen, shape, dtype, device):
    return torch.ones(shape, dtype=dtype, device=device)


def _a_log_init(gen, shape, dtype, device):
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return torch.log(1.0 + 15.0 * u).to(dtype)      # log U(1, 16)


def _ssm_params(op, H_loc, mesh):
    """A_log, D, dt_bias: shared by the prefill scan and the decode step."""
    op.A_log = make_param((H_loc,), torch.float32, (("model",),), mesh,
                          init=_a_log_init)
    op.D = make_param((H_loc,), torch.float32, (("model",),), mesh,
                      init=_ones)
    op.dt_bias = make_param((H_loc,), torch.float32, (("model",),), mesh,
                            init=_zeros)


def _conv_params(op, ch_loc, width, mesh):
    op.cw = make_param((ch_loc, width), torch.float32, (("model",), ()),
                       mesh, init=_conv_init)
    op.cb = make_param((ch_loc,), torch.float32, (("model",),), mesh,
                       init=_zeros)


class SSMInProj(Module):
    """d -> [z, xBC, dt] (column parallel)."""

    def __init__(self, cfg: ArchConfig, mesh: MeshInfo):
        super().__init__()
        d_in, d_in_loc, H, H_loc, ch_loc = ssm_dims(cfg, mesh.tp)
        out_loc = d_in_loc + ch_loc + H_loc  # z + xBC + dt
        self.proj = ShardedLinear(cfg.d_model, out_loc, "ssm_in", mesh)
        self.named("in_proj")

    def forward(self, x):
        return self.proj(x)


class Conv1dOp(Op):
    """Causal depthwise conv over [x;B;C] channels (width W, memory-bound)."""

    resource = "memory"

    def __init__(self, cfg: ArchConfig, mesh: MeshInfo, name="conv1d"):
        super().__init__()
        s = cfg.ssm
        _, self.d_in_loc, _, self.H_loc, self.ch_loc = ssm_dims(cfg, mesh.tp)
        self.W = s.conv_width
        _conv_params(self, self.ch_loc, s.conv_width, mesh)
        self.named(name)

    def kernel(self, p, zxbcdt):
        # split z / xBC / dt
        z = zxbcdt[..., :self.d_in_loc]
        xbc = zxbcdt[..., self.d_in_loc:self.d_in_loc + self.ch_loc]
        dt = zxbcdt[..., self.d_in_loc + self.ch_loc:]
        L = xbc.shape[1]
        pad = F.pad(xbc.float(), (0, 0, self.W - 1, 0))
        out = torch.zeros_like(pad[:, :L])
        for w in range(self.W):  # width is 4: unrolled taps
            out = out + pad[:, w:w + L, :] * p["cw"][:, w]
        out = F.silu(out + p["cb"])
        return z, out.to(zxbcdt.dtype), dt


class SSDScanOp(Op):
    """Chunked SSD (Mamba2) over the full sequence (train/prefill).

    Inputs: xbc (B,L,ch_loc) post-conv, dt (B,L,H_loc).
    Output: y (B,L,d_in_loc), through ``kernels.ops.ssd_scan``.
    """

    resource = "compute"

    def __init__(self, cfg: ArchConfig, mesh: MeshInfo, name="ssd_scan"):
        super().__init__()
        self.s = cfg.ssm
        _, self.d_in_loc, _, self.H_loc, self.ch_loc = ssm_dims(cfg, mesh.tp)
        _ssm_params(self, self.H_loc, mesh)
        self.named(name)

    def _split(self, xbc):
        """x, B and C as views of the post-conv activations."""
        s = self.s
        gn = s.n_groups * s.state
        x = xbc[..., :self.d_in_loc]
        Bmat = xbc[..., self.d_in_loc:self.d_in_loc + gn]
        Cmat = xbc[..., self.d_in_loc + gn:]
        x = x.unflatten(-1, (self.H_loc, s.head_dim))
        Bmat = Bmat.unflatten(-1, (s.n_groups, s.state))
        Cmat = Cmat.unflatten(-1, (s.n_groups, s.state))
        return x, Bmat, Cmat

    def kernel(self, p, xbc, dt):
        from ..kernels import ops as kops
        x, Bm, Cm = self._split(xbc)
        dtv = F.softplus(dt.float() + p["dt_bias"])     # (B,L,H)
        A = -torch.exp(p["A_log"])                      # (H,)
        y = kops.ssd_scan(x, dtv, A, Bm, Cm, p["D"], chunk=self.s.chunk)
        return y.flatten(2).to(xbc.dtype)

    def infer_out(self, in_shapes):
        B, L, _ = in_shapes[0].shape
        return TensorSpec((B, L, self.d_in_loc), in_shapes[0].dtype)

    def flops_estimate(self, in_shapes):
        B, L, _ = in_shapes[0].shape
        s = self.s
        return 6.0 * B * L * self.H_loc * s.head_dim * s.state


class GatedNormOp(Op):
    """RMSNorm(y * silu(z)) — Mamba2's gated output norm (memory)."""

    resource = "memory"

    def __init__(self, d_loc, mesh: MeshInfo, name="gated_norm"):
        super().__init__()
        self.g = make_param((d_loc,), torch.bfloat16, (("model",),), mesh,
                            init=_ones)
        self.named(name)

    def kernel(self, p, y, z):
        v = y.float() * F.silu(z.float())
        var = torch.mean(v * v, dim=-1, keepdim=True)
        return (v * torch.rsqrt(var + 1e-5)).to(y.dtype) * p["g"]


class Mamba2Layer(Module):
    """Full-sequence Mamba2 block (train/prefill)."""

    def __init__(self, cfg: ArchConfig, mesh: MeshInfo):
        super().__init__()
        d = cfg.d_model
        _, d_in_loc, _, _, _ = ssm_dims(cfg, mesh.tp)
        self.ln = RMSNormOp(d, "ln_ssm")
        self.inp = SSMInProj(cfg, mesh)
        self.conv = Conv1dOp(cfg, mesh)
        self.ssd = SSDScanOp(cfg, mesh)
        self.gate = GatedNormOp(d_in_loc, mesh)
        self.outp = ShardedLinear(d_in_loc, d, "ssm_out", mesh,
                                  pspec=(("model",), ()))
        self.ar = PsumOp(name="ar_ssm")
        self.add = AddOp("add_ssm")
        self.named("mamba")

    def forward(self, *, x, positions=None):
        h = self.ln(x)
        zxbcdt = self.inp(h)
        z, xbc, dt = self.conv(zxbcdt)
        y = self.ssd(xbc, dt)
        y = self.gate(y, z)
        y = self.outp(y)
        y = self.ar(y)
        return {"x": self.add(x, y)}


class SSDDecodeOp(Op):
    """One-token SSD state update (memory-bound decode step).

    Inputs: xbc (B,1,ch_loc), dt (B,1,H_loc), conv handled upstream;
            ssm_state (B,H_loc,N,P).
    Outputs: y (B,1,d_in_loc), new ssm_state."""

    resource = "memory"

    def __init__(self, cfg: ArchConfig, mesh: MeshInfo, name="ssd_decode"):
        super().__init__()
        self.s = cfg.ssm
        _, self.d_in_loc, _, self.H_loc, self.ch_loc = ssm_dims(cfg, mesh.tp)
        _ssm_params(self, self.H_loc, mesh)
        self.named(name)

    def kernel(self, p, xbc, dt, state):
        s = self.s
        Bsz = xbc.shape[0]
        H, P, N, G = self.H_loc, s.head_dim, s.state, s.n_groups
        x = xbc[:, 0, :self.d_in_loc].float().reshape(Bsz, H, P)
        Bm = xbc[:, 0, self.d_in_loc:self.d_in_loc + G * N]
        Cm = xbc[:, 0, self.d_in_loc + G * N:]
        Bm = Bm.float().reshape(Bsz, G, N).repeat_interleave(H // G, dim=1)
        Cm = Cm.float().reshape(Bsz, G, N).repeat_interleave(H // G, dim=1)
        dtv = F.softplus(dt[:, 0].float() + p["dt_bias"])
        a = torch.exp(dtv * (-torch.exp(p["A_log"])))     # (B,H)
        new = state.float() * a[..., None, None] + \
            torch.einsum("bh,bhs,bhp->bhsp", dtv, Bm, x)
        y = torch.einsum("bhs,bhsp->bhp", Cm, new) + x * p["D"][None, :, None]
        return (y.reshape(Bsz, 1, H * P).to(xbc.dtype),
                new.to(state.dtype))

    def infer_out(self, in_shapes):
        xbc, dt, state = in_shapes
        B = xbc.shape[0]
        return (TensorSpec((B, 1, self.d_in_loc), xbc.dtype),
                TensorSpec(state.shape, state.dtype))


class ConvDecodeOp(Op):
    """One-token causal conv using the rolling conv_state cache."""

    resource = "memory"

    def __init__(self, cfg: ArchConfig, mesh: MeshInfo, name="conv_decode"):
        super().__init__()
        s = cfg.ssm
        _, self.d_in_loc, _, self.H_loc, self.ch_loc = ssm_dims(cfg, mesh.tp)
        self.W = s.conv_width
        _conv_params(self, self.ch_loc, s.conv_width, mesh)
        self.named(name)

    def kernel(self, p, zxbcdt, conv_state):
        # conv_state (B, W-1, ch): previous raw xBC inputs
        z = zxbcdt[..., :self.d_in_loc]
        xbc = zxbcdt[:, 0, self.d_in_loc:self.d_in_loc + self.ch_loc]
        dt = zxbcdt[..., self.d_in_loc + self.ch_loc:]
        window = torch.cat([conv_state.float(), xbc[:, None].float()], 1)
        out = window[:, 0] * p["cw"][:, 0]
        for w in range(1, self.W):  # unrolled taps
            out = out + window[:, w] * p["cw"][:, w]
        out = F.silu(out + p["cb"])[:, None]
        new_state = window[:, 1:].to(conv_state.dtype)
        return z, out.to(zxbcdt.dtype), dt, new_state

    def infer_out(self, in_shapes):
        zx, cs = in_shapes
        B = zx.shape[0]
        return (TensorSpec((B, 1, self.d_in_loc), zx.dtype),
                TensorSpec((B, 1, self.ch_loc), zx.dtype),
                TensorSpec((B, 1, zx.shape[-1] - self.d_in_loc
                            - self.ch_loc), zx.dtype),
                TensorSpec(cs.shape, cs.dtype))


class Mamba2DecodeLayer(Module):
    def __init__(self, cfg: ArchConfig, mesh: MeshInfo):
        super().__init__()
        d = cfg.d_model
        _, d_in_loc, _, _, _ = ssm_dims(cfg, mesh.tp)
        self.ln = RMSNormOp(d, "ln_ssm")
        self.inp = SSMInProj(cfg, mesh)
        self.conv = ConvDecodeOp(cfg, mesh)
        self.ssd = SSDDecodeOp(cfg, mesh)
        self.gate = GatedNormOp(d_in_loc, mesh)
        self.outp = ShardedLinear(d_in_loc, d, "ssm_out", mesh,
                                  pspec=(("model",), ()))
        self.ar = PsumOp(name="ar_ssm")
        self.add = AddOp("add_ssm")
        self.named("mamba")

    def forward(self, *, x, conv_state, ssm_state, positions=None,
                cache_len=None):
        h = self.ln(x)
        zxbcdt = self.inp(h)
        z, xbc, dt, conv_state = self.conv(zxbcdt, conv_state)
        y, ssm_state = self.ssd(xbc, dt, ssm_state)
        y = self.gate(y, z)
        y = self.outp(y)
        y = self.ar(y)
        return {"x": self.add(x, y), "conv_state": conv_state,
                "ssm_state": ssm_state}


def mamba_cache_specs(cfg: ArchConfig, mesh: MeshInfo, B_loc: int) -> dict:
    """Per-layer decode caches of a Mamba2 layer (bf16, as the JAX
    package keeps them)."""
    s = cfg.ssm
    _, _, _, H_loc, ch_loc = ssm_dims(cfg, mesh.tp)
    return {
        "conv_state": TensorSpec((B_loc, s.conv_width - 1, ch_loc),
                                 torch.bfloat16),
        "ssm_state": TensorSpec((B_loc, H_loc, s.state, s.head_dim),
                                torch.bfloat16),
    }


class Mamba2LM(LMBase):
    """Attention-free Mamba2 LM; trains through the prefill's stack (see
    the module's docstring for the scan's gradient).  The prefill stack
    collects no state, so
    decode starts from whatever the cache rows hold, as in the JAX
    package's serve engine (its prefill -> decode state handoff is not
    implemented either)."""

    family = "ssm"

    def make_embed(self, phase):
        return EmbedSegment(self.cfg, self.mesh, sp=False)

    def layer_stacks(self, phase):
        cfg, mesh = self.cfg, self.mesh
        if phase == "decode":
            mod = Mamba2DecodeLayer(cfg, mesh)
            return [("layers", mod, cfg.n_layers,
                     ("conv_state", "ssm_state"), ("conv_state", "ssm_state"))]
        mod = Mamba2Layer(cfg, mesh)
        return [("layers", mod, cfg.n_layers, (), ())]

    def make_head(self, phase):
        if phase == "train":
            return TrainHead(self.cfg, self.mesh, sp=False)
        return LogitsHead(self.cfg, self.mesh, sp=False,
                          keep_last=(phase != "decode"))

    def cache_specs(self, stack_name, B_loc, s_max):
        return mamba_cache_specs(self.cfg, self.mesh, B_loc)

    def seq_local(self, phase, S):
        return S  # no SP for SSD (sequential scan)

