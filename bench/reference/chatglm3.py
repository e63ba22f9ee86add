"""Plain float32 reference of a ChatGLM3-style dense decoder.

The forward pass of the configuration in ``bench/configs/chatglm3-6b.json``
in float32 torch ops, one sequence at a time, one layer at a time, with
no cache, no batching and no kernel.  TF32 is switched off by the
caller (``judge.no_tf32``).  It follows the published model (GLM team,
arXiv:2406.12793: pre-norm RMSNorm decoder, SwiGLU MLP, grouped-query
attention with 2 KV heads, rotary embedding on half of each head) with
these departures, all of them the served system's too:

  * no bias on the QKV projection (the published model has one);
  * the rotation pairs dimension i with i + 32 within the rotated half
    (the published model pairs neighbours 2i, 2i + 1);
  * weights are random, drawn from the seed (``param_layout``);
  * bfloat16 weights widened to float32 (the served type is bfloat16;
    the published checkpoint is float16).

``linear`` is the one place a matmul happens: the control swaps it for
one that rounds its operands to fp8 (``bench/harness/judge.py``).
"""
from __future__ import annotations

import math

import torch


def dims(cfg: dict) -> dict:
    return {"L": cfg["num_layers"], "d": cfg["hidden_size"],
            "H": cfg["num_attention_heads"], "K": cfg["multi_query_group_num"],
            "hd": cfg["kv_channels"], "ff": cfg["ffn_hidden_size"],
            "V": cfg["padded_vocab_size"], "eps": cfg["layernorm_epsilon"],
            "rot": int(cfg["kv_channels"] * cfg["rotary_fraction"]),
            "base": cfg["rope_theta"]}


def param_layout(cfg: dict, dtype=torch.bfloat16) -> list:
    """``(path, shape, dtype, init)`` of every weight, in the served
    layout: linear weights ``(d_in, d_out)`` used as ``x @ w``, layers
    stacked on a leading dim."""
    m = dims(cfg)
    L, d, H, K, hd, ff, V = (m[k] for k in ("L", "d", "H", "K", "hd", "ff",
                                             "V"))
    return [
        (("embed", "emb", "w"), (V, d), dtype, "embed"),
        (("layers", "ln1", "g"), (L, d), dtype, "gain"),
        (("layers", "qkv", "proj", "lin", "w"), (L, d, (H + 2 * K) * hd),
         dtype, "fan_in"),
        (("layers", "oproj", "proj", "lin", "w"), (L, H * hd, d), dtype,
         "fan_in"),
        (("layers", "ln2", "g"), (L, d), dtype, "gain"),
        (("layers", "mlp", "wi", "lin", "w"), (L, d, 2 * ff), dtype,
         "fan_in"),
        (("layers", "mlp", "wo", "lin", "w"), (L, ff, d), dtype, "fan_in"),
        (("head", "ln", "g"), (d,), dtype, "gain"),
        (("head", "out", "w"), (d, V), dtype, "fan_in"),
    ]


def f32_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.float()


def rmsnorm(x, g, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) \
        * g.float()


def rope(x, positions, rot, base):
    """Rotate the first ``rot`` dims of each head; x (S, h, hd)."""
    inv = 1.0 / (base ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                       device=x.device) / rot))
    ang = positions.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2, rest = x[..., :rot // 2], x[..., rot // 2:rot], x[..., rot:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, rest], -1)


def attention(q, k, v):
    """Causal attention, q (S, H, hd), k/v (S, K, hd), H a multiple of K."""
    S, H, hd = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)


def layer(x, p, i, m, positions, linear):
    d, H, K, hd = m["d"], m["H"], m["K"], m["hd"]
    S = x.shape[0]
    h = rmsnorm(x, p["layers"]["ln1"]["g"][i], m["eps"])
    qkv = linear(h, p["layers"]["qkv"]["proj"]["lin"]["w"][i])
    q = qkv[:, :H * hd].reshape(S, H, hd)
    k = qkv[:, H * hd:(H + K) * hd].reshape(S, K, hd)
    v = qkv[:, (H + K) * hd:].reshape(S, K, hd)
    q = rope(q, positions, m["rot"], m["base"])
    k = rope(k, positions, m["rot"], m["base"])
    a = attention(q, k, v).reshape(S, H * hd)
    x = x + linear(a, p["layers"]["oproj"]["proj"]["lin"]["w"][i])
    h = rmsnorm(x, p["layers"]["ln2"]["g"][i], m["eps"])
    gu = linear(h, p["layers"]["mlp"]["wi"]["lin"]["w"][i])
    gate, up = gu[:, :m["ff"]], gu[:, m["ff"]:]
    return x + linear(torch.nn.functional.silu(gate) * up,
                      p["layers"]["mlp"]["wo"]["lin"]["w"][i])


@torch.no_grad()
def logits(params: dict, cfg: dict, ids: torch.Tensor, at: torch.Tensor,
           linear=f32_linear) -> torch.Tensor:
    """f32 logits ``(len(at), V)`` at positions ``at`` of the sequence
    ``ids`` (1-d, on the weights' device): position j's logits predict
    token j + 1."""
    m = dims(cfg)
    positions = torch.arange(ids.shape[0], device=ids.device)
    x = params["embed"]["emb"]["w"][ids.long()].float()
    for i in range(m["L"]):
        x = layer(x, params, i, m, positions, linear)
    h = rmsnorm(x[at], params["head"]["ln"]["g"], m["eps"])
    return linear(h, params["head"]["out"]["w"])
