"""The one traffic generator: every mix is a data file it reads.

A serving mix (``bench/traffic/<name>.json``) gives a loop, lengths and
arrivals:

  * ``"loop": "closed"`` — ``clients`` callers, each sending its next
    request when its last one ends, drawing from a pool of ``pool``
    requests in order.  With ``"stagger": true`` the first request of
    client ``i`` asks for ``(i + 0.5) / clients`` of its drawn output
    length, so that the first wave ends spread out and the window sees a
    steady mix rather than one wave of prefills.
  * ``"loop": "open"`` — Poisson arrivals at ``rate_per_s``, for
    ``settle_s`` plus the window plus ``tail_s`` seconds (the gaps, too,
    at the exponential's quantiles).
  * ``"prompt"`` / ``"output"`` — a length distribution: ``lognormal``
    (``median``, ``sigma``), ``uniform`` or ``fixed``, clipped to
    ``[min, max]``.

Every seed gets the same set of sizes and arrival gaps, taken at the
distribution's quantiles ``(i + 0.5) / n``; the seed only orders them
and draws the token ids.  The order is stratified in blocks of
``BLOCK`` requests: the quantiles are cut into ``BLOCK`` strata and each
block takes one value of every stratum, so any run of a few blocks,
such as the requests one window sees, holds nearly the same work for
every seed.  So two seeds do the same work in another order, and the
spread between runs is the system's, not the draw's.

A mix may fix its design (``"design_seed"``): which stratum of prompt
length, output length and arrival gap each request takes is then drawn
once from that number, the same for every seed, and the seed orders the
values within each stratum and draws the token ids.  Every seed then
sends nearly the same sizes at nearly the same times, so a tail that
hangs on how long prompts bunch together (an open loop's time to first
token) reads the system and not the draw.

A training mix gives ``batch`` and ``seq``; the training driver draws
its batches on the device (``drivers/train.py``).
"""
from __future__ import annotations

import dataclasses
import math
import statistics

import numpy as np

_NORMAL = statistics.NormalDist()
BLOCK = 32


def quantile_lengths(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths at the distribution's quantiles, ascending."""
    u = (np.arange(n) + 0.5) / n
    dist = spec["dist"]
    if dist == "lognormal":
        z = np.array([_NORMAL.inv_cdf(float(p)) for p in u])
        x = spec["median"] * np.exp(spec["sigma"] * z)
    elif dist == "uniform":
        x = spec["min"] + (spec["max"] - spec["min"]) * u
    elif dist == "fixed":
        x = np.full(n, float(spec["value"]))
    else:
        raise ValueError(f"unknown length distribution {dist!r}")
    lo, hi = spec.get("min", 1), spec.get("max", 1 << 30)
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def stratified(values: np.ndarray, rng: np.random.Generator,
               design: np.random.Generator | None = None) -> np.ndarray:
    """``values`` (ascending, a multiple of ``BLOCK`` long) in blocks of
    ``BLOCK``, each block one value of each of ``BLOCK`` equal strata,
    in an order drawn from ``rng``.  With ``design``, the stratum of
    each position comes from ``design`` and ``rng`` only orders the
    values within each stratum."""
    n = len(values)
    per = n // BLOCK
    strata = values.reshape(BLOCK, per)
    if design is not None:
        where = stratified(np.repeat(np.arange(BLOCK), per), design)
        out = np.empty_like(values)
        for s in range(BLOCK):
            out[where == s] = rng.permutation(strata[s])
        return out
    picks = np.stack([rng.permutation(row) for row in strata], 1)
    return np.stack([rng.permutation(b) for b in picks]).reshape(n)


def _rng(seed: int, stream: str) -> np.random.Generator:
    """A generator for one named stream of the run's draws."""
    salt = int.from_bytes(stream.encode(), "little") % (1 << 63)
    return np.random.Generator(np.random.PCG64([seed & ((1 << 64) - 1),
                                                salt]))


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # int32 token ids
    max_new: int
    due_s: float = 0.0          # open loop: scheduled arrival after start
    warmup: bool = False        # a staggered first-wave request


@dataclasses.dataclass
class ServeTraffic:
    loop: str
    requests: list
    clients: int = 0
    settle_s: float = 0.0


def serve_traffic(spec: dict, seed: int, vocab: int,
                  seconds: float) -> ServeTraffic:
    loop = spec["loop"]
    settle = float(spec.get("settle_s", 0.0))
    if loop == "closed":
        n = int(spec["pool"])
        clients = int(spec["clients"])
    elif loop == "open":
        rate = float(spec["rate_per_s"])
        n = int(math.ceil(rate * (settle + seconds
                                  + float(spec.get("tail_s", 0.0)))))
        clients = 0
    else:
        raise ValueError(f"unknown loop {loop!r}")
    n = -(-n // BLOCK) * BLOCK
    order = _rng(seed, "order")
    fixed = spec.get("design_seed")

    def design(stream):
        return None if fixed is None else _rng(int(fixed), stream)
    plens = stratified(quantile_lengths(spec["prompt"], n), order,
                       design("prompt"))
    olens = stratified(quantile_lengths(spec["output"], n), order,
                       design("output"))
    ids = _rng(seed, "ids").integers(0, vocab, size=int(plens.sum()),
                                     dtype=np.int32)
    cuts = np.concatenate([[0], np.cumsum(plens)])
    due = np.zeros(n)
    if loop == "open":
        u = (np.arange(n) + 0.5) / n
        gaps = stratified(-np.log1p(-u) / rate, order, design("gap"))
        due = np.cumsum(gaps) - gaps[0]
    reqs = []
    for i in range(n):
        out = int(olens[i])
        warm = loop == "closed" and spec.get("stagger", False) \
            and i < clients
        if warm:
            out = max(1, int(math.ceil(out * (i + 0.5) / clients)))
        reqs.append(Request(i, ids[cuts[i]:cuts[i + 1]], out,
                            float(due[i]), warm))
    return ServeTraffic(loop, reqs, clients, settle)

