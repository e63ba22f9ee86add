"""On-device sampling for the serve engine.

A pure function of the logits and three integer tensors, in plain torch
ops, so temperature / top-k / top-p sampling runs inside the captured
decode and prefill steps (no extra host sync).

Determinism contract
--------------------
Every sampled token is drawn from random bits keyed only by ``(seed,
rid, position)`` — the request's seed, its id, and the absolute stream
position of the token being emitted.  No batch index, tier, iteration
count or clock enters them, so a sampled run is reproducible across
batch compositions, across a preemption's resume (the re-prefill
derives the same positions) and across process restarts; it is also
what would make a speculative verify step lossless under sampling.
Seeds, rids and positions are runtime inputs of the captured steps and
never salt a PlanStore key; only the policy does (:func:`sampling_salt`).

The bits come from Philox4x32-10 (Salmon et al., SC'11), a counter-based
generator: key ``(seed, rid)``, counter ``(j, position, 0, 0)``, whose
four output words are the bits of vocabulary entries ``4j .. 4j+3``.
It is written in int64 torch ops on 32-bit values; the 32x32-bit
products are split into 16-bit limbs so that no intermediate passes
2^49, and the bits are the same on the CPU and on CUDA.
``torch.Generator`` cannot serve: its state advances per call, not per
``(seed, rid, position)``.  The draw is Gumbel-max: ``argmax(filtered
+ g)`` with ``g = -log(-log(u))`` and ``u`` in (0, 1) from the top 23
bits of each word.  The JAX package draws with threefry through
``jax.random.categorical``; its bits cannot be matched, so the contract,
not the tokens, is what the two packages share.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """On-device sampling policy.

    ``temperature == 0`` selects greedy argmax (the engine's greedy
    step, bitwise).  ``top_k == 0`` and ``top_p == 1.0`` disable the
    respective filters.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError("SamplingConfig: temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError("SamplingConfig: top_k must be >= 0")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError("SamplingConfig: top_p must be in (0, 1]")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    def identity(self) -> tuple:
        if self.greedy:
            return ("sampling", "greedy")
        return ("sampling", float(self.temperature), int(self.top_k),
                float(self.top_p))


GREEDY = SamplingConfig()


def resolve_sampling(cfg: Optional[SamplingConfig]) -> SamplingConfig:
    """``None`` means greedy — the engine's default."""
    return GREEDY if cfg is None else cfg


def sampling_salt(cfg: Optional[SamplingConfig]) -> str:
    """Printable policy identity for the engine's graph keys: the policy
    is baked into a captured step, so two policies never share one;
    seeds, rids and positions are runtime inputs and never appear
    here."""
    cfg = resolve_sampling(cfg)
    if cfg.greedy:
        return "greedy"
    return f"t{cfg.temperature:g}k{cfg.top_k}p{cfg.top_p:g}"


# -- Philox4x32-10 -----------------------------------------------------------

_M0, _M1 = 0xD2511F53, 0xCD9E8D57          # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85          # key schedule (Weyl) constants
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor):
    """High and low 32 bits of ``m * x`` for a 32-bit constant ``m`` and
    int64 ``x`` in [0, 2^32), with every product below 2^48."""
    lo = m * (x & 0xFFFF)                           # < 2^48
    t = m * (x >> 16) + (lo >> 16)                  # < 2^49
    return t >> 16, ((t & 0xFFFF) << 16) | (lo & 0xFFFF)


def philox4x32(counter, key, rounds: int = 10):
    """Philox4x32 on int64 tensors holding 32-bit values: ``counter`` is
    four broadcastable tensors, ``key`` two; returns the four output
    words (int64 in [0, 2^32))."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(rounds):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _u32(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor's low 32 bits as int64 in [0, 2^32)."""
    return x.to(torch.int64) & _MASK32


def random_bits(seeds, rids, positions, vocab: int) -> torch.Tensor:
    """``(N, vocab)`` int64 words in [0, 2^32) for ``N`` rows keyed by
    their ``(seed, rid, position)``: vocabulary entry ``v`` is word
    ``v % 4`` of Philox4x32-10 at key ``(seed, rid)``, counter ``(v // 4,
    position, 0, 0)``."""
    seeds = _u32(seeds).reshape(-1, 1)
    dev = seeds.device
    n = seeds.shape[0]
    j = torch.arange((vocab + 3) // 4, dtype=torch.int64, device=dev)[None]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    words = philox4x32((j, _u32(positions).reshape(-1, 1), zero, zero),
                       (seeds, _u32(rids).reshape(-1, 1)))
    return torch.stack(words, -1).reshape(n, -1)[:, :vocab]


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """Words -> f32 in (0, 1): ``(2 * (bits >> 9) + 1) * 2^-24``, exact
    in f32, never 0 or 1."""
    return ((bits >> 9) * 2 + 1).to(torch.float32) * (2.0 ** -24)


# -- the policy --------------------------------------------------------------


def _filter_logits(logits: torch.Tensor, cfg: SamplingConfig):
    """Temperature, top-k and top-p over ``(N, V)`` f32 logits: the
    JAX package's semantics.  Top-k keeps every value tied with the k-th
    largest; top-p keeps a token while the probability mass before it
    (in descending order) is below ``top_p``, so the top token always
    survives."""
    # 0-d tensors made on the device (capture-safe); dividing by a
    # tensor is a true division on CUDA too (a Python scalar divisor
    # becomes a multiply by its reciprocal there)
    scaled = logits / logits.new_full((), cfg.temperature)
    vocab = scaled.shape[-1]
    neg = scaled.new_full((), float("-inf"))
    if cfg.top_k and cfg.top_k < vocab:
        kth = scaled.topk(cfg.top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth, neg, scaled)
    if cfg.top_p < 1.0:
        desc = scaled.sort(dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < cfg.top_p
        floor = torch.where(keep, desc, -neg).amin(dim=-1, keepdim=True)
        scaled = torch.where(scaled < floor, neg, scaled)
    return scaled


def sample_tokens(logits: torch.Tensor, cfg: Optional[SamplingConfig], *,
                  seeds, rids, positions) -> torch.Tensor:
    """int32 token ids from ``logits`` ``(..., V)``.

    ``seeds`` / ``rids`` / ``positions`` are integer tensors that
    broadcast against the leading dims of ``logits`` (seeds are read as
    unsigned 32-bit).  The greedy policy is a pure argmax — the engine's
    greedy step."""
    cfg = resolve_sampling(cfg)
    if cfg.greedy:
        return logits.argmax(-1).to(torch.int32)
    lead, vocab = logits.shape[:-1], logits.shape[-1]
    flat = logits.reshape(-1, vocab).to(torch.float32)
    dev = flat.device

    def rows(x):
        if not isinstance(x, torch.Tensor):      # a fill, capture-safe
            return torch.full((flat.shape[0],), int(x), dtype=torch.int64,
                              device=dev)
        return x.to(dev, torch.int64).expand(lead).reshape(-1)
    u = uniform(random_bits(rows(seeds), rows(rids), rows(positions), vocab))
    gumbel = -torch.log(-torch.log(u))
    tok = (_filter_logits(flat, cfg) + gumbel).argmax(-1)
    return tok.reshape(lead).to(torch.int32)
