"""The work of each hand-written kernel, from its shapes: one function per
row of ``PERF.md``'s kernel table (rows 1-12).

Each returns a :class:`Cost`:

  * ``flops``: the operations the function needs, the numerator of a
    kernel row's bound in ``chip_smoke.py``.  Causal attention counts the
    unmasked half of its products (the kernels skip the tiles above the
    diagonal); decode attention counts the keys each row's length reads.
  * ``nbytes``: each operand read once and each result written once.
  * ``dot_flops``: the products in full, as the JAX package's dots
    compute them (2 · result elements · contraction, the masked half of
    causal attention included, an elementwise kernel none): what a dry run
    counts as the kernel's FLOPs (``roofline/count.py``), so that its
    totals compare with the JAX package's ``roofline.hlo.analyze``.
  * ``f32``: the operations run on the f32 units outside the tensor cores
    (their peak is 67 TFLOP/s, not 989).

A dry run charges ``dot_flops`` and ``nbytes`` for every launch it would
make (``kernels.meta_route``); ``chip_smoke.py``'s rows take their
bounds from ``flops`` and ``nbytes``.  Element sizes default to bf16's.
"""
from __future__ import annotations

from typing import NamedTuple


class Cost(NamedTuple):
    flops: float
    nbytes: float
    dot_flops: float
    f32: bool = False


def flash_attention(B: int, Sq: int, Sk: int, H: int, Hk: int, hd: int, *,
                    causal: bool = True, lse: bool = False,
                    esize: int = 2) -> Cost:
    """Row 1: q, o (B, Sq, H, hd), k, v (B, Sk, Hk, hd); ``lse``: the
    training forward also writes each row's f32 log-sum-exp (B, H, Sq)."""
    full = 4.0 * B * Sq * Sk * H * hd
    nbytes = esize * (2 * B * Sq * H * hd + 2 * B * Sk * Hk * hd)
    if lse:
        nbytes += 4 * B * H * Sq
    return Cost(full * (0.5 if causal else 1.0), nbytes, full)


def decode_attention(lens, H: int, Hk: int, hd: int, *,
                     esize: int = 2) -> Cost:
    """Row 2: one query (B, 1, H, hd) against the first ``lens[b]`` keys
    and values of row b's (S, Hk, hd) cache, int32 lengths."""
    B, keys = len(lens), float(sum(lens))
    flops = 4.0 * keys * H * hd
    nbytes = 2 * keys * Hk * hd * esize + 2 * B * H * hd * esize + 4 * B
    return Cost(flops, nbytes, flops)


def rmsnorm(n: int, d: int, *, x_esize: int = 2, g_esize: int = 2,
            out_esize: int = 2) -> Cost:
    """Row 3: x (n, d) and g (d,) read, the (n, d) output written."""
    return Cost(4.0 * n * d, n * d * (x_esize + out_esize) + d * g_esize,
                0.0)


def fused_add_rmsnorm(n: int, d: int, *, esize: int = 2, g_esize: int = 2,
                      h_esize: int = 2) -> Cost:
    """Row 4: x, y (n, d) and g (d,) read, s and h (n, d) written."""
    return Cost(6.0 * n * d, n * d * (3 * esize + h_esize) + d * g_esize,
                0.0)


def grouped_ffn(E: int, N: int, D: int, F: int, *, esize: int = 2) -> Cost:
    """Row 5: x (E, N, D), w1 and w3 (E, D, F), w2 (E, F, D) read, y
    (E, N, D) written: three products of 2 E N D F."""
    flops = 6.0 * E * N * D * F
    return Cost(flops, esize * (2 * E * N * D + 3 * E * D * F), flops)


def _ssd_products(b: int, L: int, H: int, P: int, N: int, Q: int) -> float:
    """The JAX package's chunked scan (``SSDScanOp._ref``) in full:
    C_i . B_j and M x over each chunk's whole square, the chunk states and
    C S, per head."""
    return 2.0 * b * L * H * (Q * N + Q * P + 2 * N * P)


def ssd_scan(b: int, L: int, H: int, P: int, G: int, N: int,
             Q: int) -> Cost:
    """Row 6: x, y (b, L, H, P) and B, C (b, L, G, N) in bf16, dt
    (b, L, H) f32.  The function needs C_i . B_j once per group and only
    for j <= i (Q(Q+1)/2 dot products of N per chunk), M x over the same
    triangle per head, and C S and the state update (N P each) per row and
    head."""
    flops = b * L * ((G * N + H * P) * (Q + 1) + 4 * H * N * P)
    nbytes = 2 * 2 * b * L * H * P + 2 * 2 * b * L * G * N + 4 * b * L * H
    return Cost(float(flops), float(nbytes), _ssd_products(b, L, H, P, N, Q))


def flash_attention_bwd(B: int, Sq: int, Sk: int, H: int, Hk: int, hd: int,
                        *, causal: bool = True, esize: int = 2) -> Cost:
    """Row 7: q, o, do, dq (B, Sq, H, hd), k, v, dk, dv (B, Sk, Hk, hd)
    and the f32 lse (B, H, Sq): the function needs 5 products of
    2 B Sq Sk H hd (S recomputed, dP, dV, dQ, dK), causal the unmasked
    half of each."""
    product = 2.0 * B * Sq * Sk * H * hd
    nbytes = esize * 4 * (B * Sq * H * hd + B * Sk * Hk * hd) + 4 * B * H * Sq
    return Cost(5 * product * (0.5 if causal else 1.0), nbytes, 5 * product)


def rmsnorm_bwd(n: int, d: int, *, esize: int = 2) -> Cost:
    """Row 8: x and dh read, dx written; g read and dg written."""
    return Cost(8.0 * n * d, (3 * n * d + 2 * d) * esize, 0.0)


def fused_add_rmsnorm_bwd(n: int, d: int, *, esize: int = 2) -> Cost:
    """Row 9: s, dh and ds_out read, ds written; g read and dg written."""
    return Cost(10.0 * n * d, (4 * n * d + 2 * d) * esize, 0.0)


def adamw(leaves) -> Cost:
    """Row 10: AdamW over ``leaves``, (numel, param element size, grad
    element size) each: the param and the grad read, the param written, f32
    m and v read and written (16 bytes); ~17 f32 operations an element."""
    n = sum(k for k, _, _ in leaves)
    nbytes = sum(k * (2 * pe + ge + 16) for k, pe, ge in leaves)
    return Cost(17.0 * n, float(nbytes), 0.0, f32=True)


def grouped_ffn_gate_bwd(n: int, *, esize: int = 2) -> Cost:
    """Row 11: h1, h3 and dh read, dh1, dh3 and h written, ``n`` elements
    each; ~13 f32 operations an element (an exp among them)."""
    return Cost(13.0 * n, 6.0 * n * esize, 0.0, f32=True)


def ssd_scan_bwd(b: int, L: int, H: int, P: int, G: int, N: int,
                 Q: int) -> Cost:
    """Row 12: what the chunked VJP needs, per head and chunk: the
    recomputed state update and sum_i exp(cum_i) C_i^T dy_i, dx's, dC's
    and dB's inter-chunk terms (2 Q N P each), dy_i . x_j and dx's M term
    over the triangle (2 T P each), dC's and dB's intra terms (2 T N
    each); C_i . B_j over the triangle once per group; x, dy, dx, B, C, dB,
    dC, dt, ddt, A, D, dA and dD once.  Its products in full are the
    transposes of the forward's, two for each."""
    tri = Q * (Q + 1) // 2
    flops = b * (L // Q) * (H * (10 * Q * N * P + 4 * tri * (P + N))
                            + G * 2 * tri * N)
    nbytes = (3 * 2 * b * L * H * P + 4 * 2 * b * L * G * N
              + 2 * 4 * b * L * H + 4 * 4 * H)
    return Cost(float(flops), float(nbytes),
                2 * _ssd_products(b, L, H, P, N, Q))
