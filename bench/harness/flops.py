"""The benchmark's own arithmetic: the chip's peaks and the model FLOPs
that the utilisation metrics divide by them.

Peaks are NVIDIA's datasheet figures for one H100 SXM at its full power
limit of 700 W (dense, no sparsity); every run prints the card's power
limit beside its numbers.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def dense_layer_params(m: dict) -> int:
    """Matmul weights of one ChatGLM3-style decoder layer (``m`` as
    ``reference.chatglm3.dims``): QKV, output, gate/up and down."""
    d, H, K, hd, ff = m["d"], m["H"], m["K"], m["hd"], m["ff"]
    return d * (H + 2 * K) * hd + H * hd * d + d * 2 * ff + ff * d


def serve_prompt_flops(m: dict, n: int) -> float:
    """A prompt of ``n`` tokens through every layer: 2 per weight a token
    plus causal attention, 4 H hd per query and key it sees (QK and PV);
    the head runs at the served positions only (``serve_token_flops``)."""
    return (2.0 * m["L"] * dense_layer_params(m) * n
            + 4.0 * m["L"] * m["H"] * m["hd"] * n * (n + 1) / 2)


def serve_token_flops(m: dict, prompt: int, k: int) -> float:
    """The ``k``-th served token (from 0) of a request with a ``prompt``-
    token prompt: the head at position ``prompt - 1 + k`` and, from the
    second token on, that position through every layer, attending to
    ``prompt + k`` keys."""
    head = 2.0 * m["d"] * m["V"]
    if k == 0:
        return head
    keys = prompt + k
    return (head + 2.0 * m["L"] * dense_layer_params(m)
            + 4.0 * m["L"] * m["H"] * m["hd"] * keys)


def ssm_train_flops(m: dict, layout, B: int, S: int) -> float:
    """Model FLOPs of one train step of a Mamba2 or hybrid LM (``m`` as
    ``reference.zamba2.dims``, ``layout`` its weights): 6 per matmul
    weight a token (the linears, the shared block's at each of its uses,
    the tied embedding as the head's matmul; not the convolutions' taps,
    the norms' gains or the scan's per-head parameters), plus three
    times the forward's SSD scan, 6 B S H P N a layer, and three times
    the shared block's causal attention, 4 B S^2 heads hd / 2 a use.
    Recomputation is not counted.  A frozen copy of the arithmetic of
    ``ssm_train_flops`` in the repository's ``chip_smoke.py``."""
    uses = m["L"] // m["every"] if m["every"] else 0
    n = 0
    for path, shape, _, _ in layout:
        if path[-2:] == ("lin", "w") or path == ("embed", "emb", "w"):
            k = 1
            for s in shape:
                k *= s
            n += k * (uses if path[0] == "shared_attn" else 1)
    scan = 6.0 * B * S * m["H"] * m["P"] * m["N"]
    attn = 4.0 * B * S * S * m["heads"] * m["hd"] * 0.5 * uses
    return 6.0 * n * B * S + 3 * (scan * m["L"] + attn)
