"""AdamW from scratch + int8-quantized second moment (the port of
``src/repro/optim/adamw.py``: 4x less optimizer-state memory, block-wise
scales).

The arithmetic is the JAX package's, in f32: m and v are f32, each step
scales the gradient by the clip factor, updates m and v, corrects their
bias by 1 - b^count, and updates the param in f32 before rounding it to
its own dtype.  ``torch.optim.AdamW`` is not that arithmetic (its bias
correction and weight-decay order differ), so it is not used.

Where the JAX package is pure, the port updates in place: ``adamw_update``
writes the new params into the param tensors and the new m and v (or
their int8 codes and scales) into the state's tensors, and returns the
same objects.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import adamw as kadamw
from ..tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantized: bool = False     # int8 second moment
    block: int = 256            # quantization block size


def adamw_init(params, cfg: AdamWConfig):
    """{"state": {"m", "v"} per param leaf, "count": int32 0-d}, on each
    param's device."""
    def init_leaf(p):
        m = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if cfg.quantized:
            v = quantize_state(torch.zeros_like(m), cfg.block)
        else:
            v = torch.zeros_like(m)
        return {"m": m, "v": v}

    dev = leaves(params)[0].device
    return {"state": tree_map(init_leaf, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def quantize_state(v, block: int):
    """Block-wise int8 quantization of the (non-negative) second moment
    with a sqrt code map: q = round(127·sqrt(v/absmax)).  The nonlinear
    map keeps resolution near zero: a linear map rounds small-v entries
    to exactly 0, and any gradient noise (e.g. from int8-compressed
    all-reduces) then explodes m/sqrt(v).  The shape stays implicit (the
    param's, at dequantize time) so the state holds only tensors."""
    flat = v.reshape(-1)
    flat = F.pad(flat, (0, (-flat.shape[0]) % block))
    blocks = flat.reshape(-1, block)
    scale = torch.clamp_min(blocks.amax(dim=1, keepdim=True), 1e-20)
    q = torch.clamp(torch.round(127.0 * torch.sqrt(blocks / scale)), 0, 127)
    q = torch.where(blocks > 0, torch.clamp_min(q, 1.0),
                    torch.zeros((), device=q.device))   # never zero v>0
    return {"q": q.to(torch.int8), "scale": scale.to(torch.float32)}


def dequantize_state(qs, shape) -> torch.Tensor:
    code = qs["q"].to(torch.float32) / 127.0
    flat = (code * code * qs["scale"]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def _is_quant(x) -> bool:
    return isinstance(x, dict) and "q" in x and "scale" in x


def _state_leaves(state) -> list:
    """The {"m", "v"} dicts of the state tree, in param-leaf order."""
    if isinstance(state, dict) and "m" in state:
        return [state]
    return [s for k in sorted(state) for s in _state_leaves(state[k])]


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves(grads)))


@torch.no_grad()
def adamw_update(params, grads, opt_state, cfg: AdamWConfig,
                 lr: Optional[torch.Tensor] = None,
                 gnorm: Optional[torch.Tensor] = None):
    """One AdamW step, in place.  Returns (params, opt_state, grad_norm),
    the first two the objects passed in.  Pass a globally reduced
    ``gnorm`` under SPMD so clipping is identical on every rank (see
    ``train/step.py:global_grad_norm``).

    Leaves with f32 m and v go through ``kernels.adamw.adamw``: one
    launch of the multi-tensor kernel on the card, the same chain
    (``adamw_chain``) leaf by leaf on the CPU.  The int8 second moment
    runs the chain eagerly around its dequantize and quantize.  Nothing
    here copies from the host or waits for the device, so a CUDA Graph
    can capture the update (the constants are filled on the device)."""
    flat_p = leaves(params)
    dev = flat_p[0].device
    if isinstance(lr, torch.Tensor):
        lr = lr.to(dev, torch.float32)
    else:
        lr = torch.full((), cfg.lr if lr is None else lr,
                        dtype=torch.float32, device=dev)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = (torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12),
                             1.0) if cfg.grad_clip else None)
    count = opt_state["count"] + 1
    cf = count.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.full((), cfg.b1, dtype=torch.float32,
                                    device=dev), cf)
    c2 = 1.0 - torch.pow(torch.full((), cfg.b2, dtype=torch.float32,
                                    device=dev), cf)
    flat_g = leaves(grads)
    flat_s = _state_leaves(opt_state["state"])
    assert len(flat_p) == len(flat_g) == len(flat_s), \
        (len(flat_p), len(flat_g), len(flat_s))
    consts = dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                  weight_decay=cfg.weight_decay)
    dense = [(p, g, st) for p, g, st in zip(flat_p, flat_g, flat_s)
             if not _is_quant(st["v"])]
    kadamw.adamw([p for p, _, _ in dense], [g for _, g, _ in dense],
                 [st["m"] for _, _, st in dense],
                 [st["v"] for _, _, st in dense], lr, scale, c1, c2, **consts)
    for p, g, st in zip(flat_p, flat_g, flat_s):
        if not _is_quant(st["v"]):
            continue
        pn, m, v = kadamw.adamw_chain(
            p, g, st["m"], dequantize_state(st["v"], p.shape), lr,
            1.0 if scale is None else scale, c1, c2, **consts)
        p.copy_(pn)
        st["m"].copy_(m)
        qs = quantize_state(v, cfg.block)
        st["v"]["q"].copy_(qs["q"])
        st["v"]["scale"].copy_(qs["scale"])
    opt_state["count"].copy_(count)
    return params, opt_state, gnorm
