"""Weights from the seed, made on the device in a few large calls.

A reference module's ``param_layout(cfg)`` lists the leaves as ``(path,
shape, dtype, init)``.  ``make_params`` draws one normal buffer a dtype
with a ``torch.Generator`` on the device, cuts every leaf out of it as a
view and scales it in place by its ``init``:

  * ``fan_in``  — std 1/sqrt(shape[-2]) (a ``(d_in, d_out)`` weight, or a
    stack of them);
  * ``embed``   — std 0.02;
  * ``gain``    — 1 + 0.1 N(0, 1), a norm's gain;
  * ``("uniform", lo, hi)`` / ``("log_uniform", lo, hi)`` — from the
    leaf's normal draws through the normal's CDF (the log of a uniform
    draw for ``log_uniform``);
  * ``("inv_softplus_log_uniform", lo, hi)`` — softplus^-1 of a
    log-uniform draw (a Mamba2 ``dt`` bias).

The same tensors go to the program and to the reference.
"""
from __future__ import annotations

import math

import torch


def _fill(t: torch.Tensor, init, shape) -> None:
    if init == "fan_in":
        t.mul_(1.0 / math.sqrt(shape[-2]))
    elif init == "embed":
        t.mul_(0.02)
    elif init == "gain":
        t.mul_(0.1).add_(1.0)
    else:
        kind, lo, hi = init
        u = (torch.special.ndtr(t.float()) * (1 - 2e-6) + 1e-6)
        if kind == "uniform":
            t.copy_(lo + (hi - lo) * u)
        elif kind == "log_uniform":
            t.copy_(torch.log(lo + (hi - lo) * u))
        elif kind == "inv_softplus_log_uniform":
            dt = torch.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u)
            t.copy_(dt + torch.log(-torch.expm1(-dt)))
        else:
            raise ValueError(f"unknown init {init!r}")


def make_params(layout, seed: int, device) -> dict:
    """The param tree of ``layout`` drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & ((1 << 63) - 1))
    by_dtype: dict = {}
    for path, shape, dtype, init in layout:
        by_dtype.setdefault(dtype, []).append((path, shape, init))
    tree: dict = {}
    for dtype, entries in by_dtype.items():
        total = sum(math.prod(s) for _, s, _ in entries)
        flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
        at = 0
        for path, shape, init in entries:
            n = math.prod(shape)
            leaf = flat[at:at + n].view(shape)
            at += n
            _fill(leaf, init, shape)
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf
    return tree


def leaves(tree: dict, prefix=()):
    """(path, tensor) of every leaf of a nested dict, in sorted order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v
