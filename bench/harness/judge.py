"""The comparison that decides ``correct``, and its control.

A served model: once the window has closed, a sample of the requests
finished inside it, drawn from the seed and holding the one with the
most served tokens, is run through the plain reference once, prompt and
served tokens together, and every served position of each is compared.
Each served token is greedy, so the reference's best logit at its
position is at least its own: the number compared is the widest gap by
which a served token's reference logit lies below the reference's best
(``max_logit_gap``).

The control computes the same reference with every matmul's operands
rounded to fp8 (e4m3, a scale per row of the activations and per output
column of the weights): the step below the bfloat16 the configuration
serves in.  It need not decode: at each served position it reads the
gap of the token that the fp8 model puts first.  A control run holds
that gap to the limit in the program's place.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for the reference."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to e4m3 with one scale per slice along ``dim``."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = FP8_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def fp8_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _fp8(x, -1) @ _fp8(w.float(), 0)


def pick_sample(finished: list, seed: int, max_requests: int) -> list:
    """The finished request with the most served tokens, then others in
    an order drawn from the seed, ``max_requests`` in all."""
    if not finished:
        return []
    rng = np.random.Generator(np.random.PCG64([seed & ((1 << 64) - 1), 7]))
    first = max(range(len(finished)), key=lambda i: len(finished[i][1]))
    rest = [i for i in rng.permutation(len(finished)) if i != first]
    return [finished[i] for i in [first] + rest[:max_requests - 1]]


def logit_gaps(ref, params, cfg, sample, device, linear=None) -> dict:
    """Per sample request ``(prompt, served)``: the reference's logits at
    each served position.  Returns the widest gap of the served tokens
    and, with ``linear`` (the control), the widest gap of the tokens the
    control puts first, both measured on the float32 reference."""
    worst, worst_ctrl, tokens = 0.0, 0.0, 0
    with no_tf32():
        for prompt, served in sample:
            seq = np.concatenate([np.asarray(prompt, np.int64),
                                  np.asarray(served, np.int64)])
            ids = torch.from_numpy(seq[:-1]).to(device)
            n = len(prompt)
            at = torch.arange(n - 1, len(seq) - 1, device=device)
            want = torch.from_numpy(np.asarray(served, np.int64)).to(device)
            lg = ref.logits(params, cfg, ids, at)
            best = lg.max(-1).values
            gap = (best - lg.gather(1, want[:, None])[:, 0]).max().item()
            worst = max(worst, gap)
            tokens += len(served)
            if linear is not None:
                c = ref.logits(params, cfg, ids, at, linear=linear)
                pick = c.argmax(-1)
                g = (best - lg.gather(1, pick[:, None])[:, 0]).max().item()
                worst_ctrl = max(worst_ctrl, g)
                del c
            del lg
    out = {"max_logit_gap": worst, "tokens_compared": tokens,
           "requests_compared": len(sample)}
    if linear is not None:
        out["control_max_logit_gap"] = worst_ctrl
    return out
