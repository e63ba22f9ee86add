"""Each plain reference agrees with the program at smoke sizes on the CPU:
the same weights from the benchmark's layout, the program's bfloat16
against the reference's float32."""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from bench.harness import catalog, judge, weights  # noqa: E402

SEEDS = (2 ** 31 + 11, 2 ** 31 + 12)


def glm_smoke() -> dict:
    """chatglm3-6b's file at the port's smoke sizes."""
    cfg = catalog.config("chatglm3-6b")
    cfg.update(num_layers=2, hidden_size=32, num_attention_heads=4,
               multi_query_group_num=2, kv_channels=8, ffn_hidden_size=64,
               padded_vocab_size=128)
    cfg["bench"] = dict(cfg["bench"], smoke=True)
    return cfg


def zamba_smoke() -> dict:
    """zamba2-1.2b's file at the port's smoke sizes."""
    cfg = catalog.config("zamba2-1.2b")
    cfg.update(hidden_size=32, num_hidden_layers=4, mamba_d_state=16,
               mamba_headdim=8, num_attention_heads=4, num_key_value_heads=2,
               attention_head_dim=8, intermediate_size=64, vocab_size=128,
               chunk_size=8, attn_every=2)
    cfg["bench"] = dict(cfg["bench"], smoke=True)
    return cfg


def _program(cfg):
    from repro_torch.api import compile as port_compile
    return port_compile(cfg["bench"]["arch"], smoke=True, device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_chatglm3_reference_agrees_with_the_prefill(seed):
    cfg = glm_smoke()
    ref = catalog.reference("chatglm3")
    params = weights.make_params(ref.param_layout(cfg), seed, "cpu")
    prog = _program(cfg)
    S = 48
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 128, (1, S), dtype=np.int32))
    step = prog.prefill(1, S)
    got = step.fn(params, {"ids": ids, "positions": torch.arange(
        S, dtype=torch.int32)[None]})["logits"][0, -1].float()
    want = ref.logits(params, cfg, ids[0], torch.tensor([S - 1]))[0]
    err = (got - want).abs().max().item()
    assert err < 0.05 * want.abs().max().item(), err
    assert got.argmax() == want.argmax()
    # the fp8 control moves the logits far more than the program's bf16
    ctrl = ref.logits(params, cfg, ids[0], torch.tensor([S - 1]),
                      linear=judge.fp8_linear)[0]
    assert (ctrl - want).abs().max().item() > 3 * err


@pytest.mark.parametrize("seed", SEEDS)
def test_zamba2_reference_agrees_with_the_train_step(seed):
    cfg = zamba_smoke()
    ref = catalog.reference("zamba2")
    params = weights.make_params(ref.param_layout(cfg), seed, "cpu")
    prog = _program(cfg)
    B, S = 2, 32
    step = prog.train_step(B, S)
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, 128, (B, S + 1), generator=g, dtype=torch.int32)
    batch = {"ids": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous(),
             "positions": torch.arange(S, dtype=torch.int32).expand(B, S)
             .contiguous()}
    grads, (ls, cnt) = step.fn.grads(params, batch)
    p32 = {}
    for path, t in weights.leaves(params):
        node = p32
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t.detach().float().requires_grad_()
    flat = [t for _, t in weights.leaves(p32)]
    loss = ref.loss(p32, cfg, batch["ids"], batch["labels"])
    want = torch.autograd.grad(loss, flat)
    assert abs(float(ls.sum() / cnt.sum()) - loss.item()) \
        < 2e-3 * loss.item()
    got = [t for _, t in weights.leaves(grads)]
    norms = [w.norm().item() for w in want]
    med = sorted(norms)[len(norms) // 2]
    for (path, _), a, b in zip(weights.leaves(params), got, want):
        gap = abs(a.float().norm().item() - b.norm().item()) \
            / max(b.norm().item(), med)
        assert gap < 0.05, (path, gap)


def test_the_references_scan_is_the_recurrence():
    """The chunked scan equals the step-by-step recurrence."""
    ref = catalog.reference("zamba2")
    g = torch.Generator().manual_seed(3)
    b, L, H, P, G, N = 1, 24, 4, 3, 2, 5
    x = torch.randn(b, L, H, P, generator=g, dtype=torch.float64)
    dt = torch.rand(b, L, H, generator=g, dtype=torch.float64) * 0.5
    A = -torch.rand(H, generator=g, dtype=torch.float64) * 2
    B = torch.randn(b, L, G, N, generator=g, dtype=torch.float64)
    C = torch.randn(b, L, G, N, generator=g, dtype=torch.float64)
    D = torch.randn(H, generator=g, dtype=torch.float64)
    y = ref.ssd_scan(x, dt, A, B, C, D, chunk=8)
    h = torch.zeros(b, H, N, P, dtype=torch.float64)
    Bh = B.repeat_interleave(H // G, dim=2)
    Ch = C.repeat_interleave(H // G, dim=2)
    for t in range(L):
        h = h * torch.exp(dt[:, t] * A)[..., None, None] + torch.einsum(
            "bh,bhn,bhp->bhnp", dt[:, t], Bh[:, t], x[:, t])
        want = torch.einsum("bhn,bhnp->bhp", Ch[:, t], h) \
            + x[:, t] * D[:, None]
        assert torch.allclose(y[:, t], want, atol=1e-10)
