"""Plain float32 reference of the Zamba2 hybrid, its loss and one AdamW
step, for ``bench/configs/zamba2-1.2b.json``.

Mamba2 layers (Dao and Gu, arXiv:2405.21060) in groups, each group
followed by one attention block whose weights every use shares
(Zyphra, arXiv:2411.15242), then the trailing Mamba2 layers; the head is
the tied embedding.  Everything runs in float32 torch ops with autograd:
no kernel, no cache.  The SSD scan is this file's own chunked form of
the recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,
y_t = C_t h_t + D x_t.  Each layer is recomputed in the backward
(``torch.utils.checkpoint``) so that the reference fits beside the
weights; that changes no arithmetic.  Departures from the published
model, all of them the trained system's too:

  * the shared block takes concat(hidden, embedding) at width 2 d and
    has no per-use LoRA adapters, no per-use input norms and one shared
    block, not two alternating;
  * the shared block's rotary embedding covers each whole head, pairing
    dimension i with i + 64;
  * Mamba2 layers use one group of B and C and no inner norm before the
    gated norm;
  * weights are random, drawn from the seed (``param_layout``).

AdamW is the trained system's arithmetic (decoupled weight decay on
every leaf, bias correction by 1 - b^t, global-norm clipping), with the
learning rate of a cosine schedule in its warm-up.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def dims(cfg: dict) -> dict:
    d = cfg["hidden_size"]
    d_in = cfg["mamba_expand"] * d
    P, N, G = cfg["mamba_headdim"], cfg["mamba_d_state"], cfg["mamba_ngroups"]
    return {"L": cfg["num_hidden_layers"], "d": d, "d_in": d_in,
            "H": d_in // P, "P": P, "N": N, "G": G,
            "ch": d_in + 2 * G * N, "W": cfg["mamba_d_conv"],
            "every": cfg["attn_every"], "heads": cfg["num_attention_heads"],
            "kv": cfg["num_key_value_heads"], "hd": cfg["attention_head_dim"],
            "ff": cfg["intermediate_size"], "V": cfg["vocab_size"],
            "eps": cfg["rms_norm_eps"], "base": cfg["rope_theta"],
            "chunk": cfg["chunk_size"]}


def stacks(m: dict) -> list:
    """(name, layers) of the Mamba2 stacks, in order; a shared-block use
    follows every stack but the trailing one."""
    groups = m["L"] // m["every"]
    out = [(f"mamba_g{i}", m["every"]) for i in range(groups)]
    tail = m["L"] - groups * m["every"]
    return out + ([("mamba_tail", tail)] if tail else [])


def param_layout(cfg: dict) -> list:
    m = dims(cfg)
    bf, f32 = torch.bfloat16, torch.float32
    d, d2, H = m["d"], 2 * m["d"], m["H"]
    out = [(("embed", "emb", "w"), (m["V"], d), bf, "embed"),
           (("head", "ln", "g"), (d,), bf, "gain")]
    for name, n in stacks(m):
        out += [
            ((name, "ln", "g"), (n, d), bf, "gain"),
            ((name, "inp", "proj", "lin", "w"),
             (n, d, m["d_in"] + m["ch"] + H), bf, "fan_in"),
            ((name, "conv", "cw"), (n, m["ch"], m["W"]), f32,
             ("uniform", -0.3, 0.3)),
            ((name, "conv", "cb"), (n, m["ch"]), f32, ("uniform", -0.1, 0.1)),
            ((name, "ssd", "A_log"), (n, H), f32, ("log_uniform", 1.0, 16.0)),
            ((name, "ssd", "D"), (n, H), f32, ("uniform", 0.5, 1.5)),
            ((name, "ssd", "dt_bias"), (n, H), f32,
             ("inv_softplus_log_uniform", 1e-3, 1e-1)),
            ((name, "gate", "g"), (n, m["d_in"]), bf, "gain"),
            ((name, "outp", "lin", "w"), (n, m["d_in"], d), bf, "fan_in"),
        ]
    hq, hk, hd = m["heads"], m["kv"], m["hd"]
    out += [
        (("shared_attn", "ln1", "g"), (d2,), bf, "gain"),
        (("shared_attn", "qkv", "proj", "lin", "w"), (d2, (hq + 2 * hk) * hd),
         bf, "fan_in"),
        (("shared_attn", "oproj", "proj", "lin", "w"), (hq * hd, d2), bf,
         "fan_in"),
        (("shared_attn", "ln2", "g"), (d2,), bf, "gain"),
        (("shared_attn", "mlp", "wi", "lin", "w"), (d2, 2 * m["ff"]), bf,
         "fan_in"),
        (("shared_attn", "mlp", "wo", "lin", "w"), (m["ff"], d2), bf,
         "fan_in"),
        (("shared_attn", "down", "lin", "w"), (d2, d), bf, "fan_in"),
    ]
    return out


def rmsnorm(x, g, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * g


def ssd_scan(x, dt, A, B, C, D, chunk):
    """y (b, L, H, P) of the SSD recurrence, chunk by chunk.
    x (b,L,H,P), dt (b,L,H), A (H,), B and C (b,L,G,N), D (H,)."""
    b, L, H, P = x.shape
    G = B.shape[2]
    Q = min(chunk, L)
    nc = L // Q
    xs = x.reshape(b, nc, Q, H, P)
    dts = dt.reshape(b, nc, Q, H)
    Bs = B.reshape(b, nc, Q, G, -1).repeat_interleave(H // G, dim=3)
    Cs = C.reshape(b, nc, Q, G, -1).repeat_interleave(H // G, dim=3)
    a = torch.cumsum(dts * A, dim=2)                       # (b,nc,Q,H)
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    seg = a.transpose(2, 3)[..., :, None] - a.transpose(2, 3)[..., None, :]
    decay = torch.exp(seg.masked_fill(~tri, float("-inf")))  # (b,nc,H,Q,Q)
    scores = torch.einsum("bcihn,bcjhn->bchij", Cs, Bs) * decay \
        * dts.transpose(2, 3)[..., None, :]
    y = torch.einsum("bchij,bcjhp->bcihp", scores, xs)
    tail = torch.exp(a[:, :, -1:, :] - a) * dts            # (b,nc,Q,H)
    states = torch.einsum("bcjh,bcjhn,bcjhp->bchnp", tail, Bs, xs)
    h = torch.zeros_like(states[:, 0])
    before = []
    for c in range(nc):
        before.append(h)
        h = h * torch.exp(a[:, c, -1])[..., None, None] + states[:, c]
    before = torch.stack(before, 1)                        # (b,nc,H,N,P)
    y = y + torch.einsum("bcihn,bcih,bchnp->bcihp", Cs, torch.exp(a), before)
    y = y + xs * D[None, None, None, :, None]
    return y.reshape(b, L, H, P)


def mamba(x, p, m):
    d_in, ch, H, P, N, G = (m[k] for k in ("d_in", "ch", "H", "P", "N", "G"))
    bsz, L, _ = x.shape
    h = rmsnorm(x, p["ln"]["g"].float(), m["eps"])
    zxbcdt = h @ p["inp"]["proj"]["lin"]["w"].float()
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + ch]
    dt = zxbcdt[..., d_in + ch:]
    W = m["W"]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    conv = sum(pad[:, w:w + L] * p["conv"]["cw"][:, w] for w in range(W))
    xbc = F.silu(conv + p["conv"]["cb"])
    xs = xbc[..., :d_in].reshape(bsz, L, H, P)
    Bm = xbc[..., d_in:d_in + G * N].reshape(bsz, L, G, N)
    Cm = xbc[..., d_in + G * N:].reshape(bsz, L, G, N)
    dt = F.softplus(dt + p["ssd"]["dt_bias"])
    A = -torch.exp(p["ssd"]["A_log"])
    y = ssd_scan(xs, dt, A, Bm, Cm, p["ssd"]["D"], m["chunk"])
    v = y.reshape(bsz, L, d_in) * F.silu(z)
    v = rmsnorm(v, p["gate"]["g"].float(), 1e-5)
    return x + v @ p["outp"]["lin"]["w"].float()


def rope(x, positions, base):
    hd = x.shape[-1]
    inv = 1.0 / (base ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd))
    ang = positions.float()[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def shared(x, x0, p, m):
    bsz, L, _ = x.shape
    hq, hk, hd = m["heads"], m["kv"], m["hd"]
    h = torch.cat([x, x0], -1)
    a = rmsnorm(h, p["ln1"]["g"].float(), m["eps"])
    qkv = a @ p["qkv"]["proj"]["lin"]["w"].float()
    q = qkv[..., :hq * hd].reshape(bsz, L, hq, hd)
    k = qkv[..., hq * hd:(hq + hk) * hd].reshape(bsz, L, hk, hd)
    v = qkv[..., (hq + hk) * hd:].reshape(bsz, L, hk, hd)
    pos = torch.arange(L, device=x.device)
    q, k = rope(q, pos, m["base"]), rope(k, pos, m["base"])
    k = k.repeat_interleave(hq // hk, dim=2)
    v = v.repeat_interleave(hq // hk, dim=2)
    att = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True).transpose(1, 2).reshape(bsz, L, hq * hd)
    h = h + att @ p["oproj"]["proj"]["lin"]["w"].float()
    gu = rmsnorm(h, p["ln2"]["g"].float(), m["eps"]) \
        @ p["mlp"]["wi"]["lin"]["w"].float()
    h = h + (F.silu(gu[..., :m["ff"]]) * gu[..., m["ff"]:]) \
        @ p["mlp"]["wo"]["lin"]["w"].float()
    return x + h @ p["down"]["lin"]["w"].float()


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def loss(params: dict, cfg: dict, ids, labels) -> torch.Tensor:
    """Mean cross entropy over every label but -100."""
    m = dims(cfg)
    emb = params["embed"]["emb"]["w"]
    x = emb[ids.long()].float()
    x0 = x
    names = stacks(m)
    for si, (name, n) in enumerate(names):
        for i in range(n):
            x = checkpoint(mamba, x, _layer(params[name], i), m,
                           use_reentrant=False)
        if name != "mamba_tail":
            x = checkpoint(shared, x, x0, params["shared_attn"], m,
                           use_reentrant=False)
    h = rmsnorm(x, params["head"]["ln"]["g"].float(), m["eps"])
    logits = h @ emb.float().t()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long(), ignore_index=-100)


def cosine_lr(step: int, opt: dict) -> float:
    """The schedule's learning rate at ``step`` (from 0)."""
    peak, warm, total = opt["lr"], opt["warmup"], opt["total_steps"]
    if step < warm:
        return peak * min((step + 1.0) / max(warm, 1), 1.0)
    frac = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * frac)))


@torch.no_grad()
def adamw(params: list, grads: list, state: list, step: int, opt: dict):
    """One AdamW step over f32 ``params`` in place; returns the clip
    scale."""
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = torch.clamp(opt["grad_clip"] / torch.clamp_min(gnorm, 1e-12),
                        max=1.0)
    lr, b1, b2 = cosine_lr(step, opt), opt["b1"], opt["b2"]
    c1, c2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
    for p, g, st in zip(params, grads, state):
        g = g * scale
        st["m"].mul_(b1).add_((1 - b1) * g)
        st["v"].mul_(b2).add_((1 - b2) * g * g)
        upd = (st["m"] / c1) / (torch.sqrt(st["v"] / c2) + opt["eps"])
        p.sub_(lr * (upd + opt["weight_decay"] * p))
    return scale
