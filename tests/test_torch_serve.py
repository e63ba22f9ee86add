"""The port's serving engine against the JAX package's.

Smoke smollm-135m and smoke deepseek-moe-16b (a dense first layer and
one MoE layer, whose decode caches are two stacks) on the same
parameters (``params_from_numpy`` of
``repro``'s ``init_params(PRNGKey(0))``), a batch of mixed prompt
lengths that exercises batched bucketed prefill (full and padded
buckets), power-of-two decode tiers and row compaction, greedy decode.
The reference is ``repro.serve.ServeEngine`` with ``lowered=False``.

Greedy tokens must be equal wherever the reference's choice is not a
near tie.  The two frameworks' logits agree within the bf16 tolerance of
tests/test_kernels.py (atol=rtol=3e-2, atol scaled by the logits'
magnitude), so an argmax can only flip where the reference's top-1/top-2
margin is below twice that bound.  At a request's first differing token
the test recomputes the reference's logits for that position and
requires such a near tie; after it the two continuations legitimately
diverge.  In the MoE model a route can flip as well (tests/test_torch_moe.py):
there a near tie of the reference's router probabilities at that
position — its k-th and (k+1)-th within ``2 * (3e-2 + 3e-2 * p_k)`` —
also explains a differing token (the smoke model's one MoE layer is its
last, so only that position's route reaches its logits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.core import ScheduleContext as JCtx
from repro.models.base import build_forward as jbuild_forward
from repro.models.layers import MeshInfo as JMeshInfo
from repro.models.registry import build_model as jbuild_model
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.api import compile as tcompile
from repro_torch.convert import params_from_numpy
from repro_torch.serve import Request, ServeConfig

ARCHS = ["smollm-135m", "deepseek-moe-16b"]
BF16 = dict(atol=3e-2, rtol=3e-2)
PROMPT_LENS = (3, 8, 13, 16, 30, 5)
NEW_TOKENS = 6
CFG = dict(max_batch=4, s_max=64, prefill_buckets=(8, 16, 32),
           prefill_batch=2)


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    arch = request.param
    jm = jbuild_model(jget_smoke(arch), JMeshInfo())
    jparams = jm.init_params(jax.random.PRNGKey(0), phase="prefill")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jm.cfg.vocab, n).astype(np.int32)
               for n in PROMPT_LENS]

    ref = JServeEngine(jm, jparams, "dynamic",
                       JServeConfig(lowered=False, **CFG))
    for i, p in enumerate(prompts):
        ref.submit(JRequest(i, p, max_new_tokens=NEW_TOKENS))
    want = {r.rid: list(r.output) for r in ref.run()}

    prog = tcompile(arch, smoke=True, device="cpu")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    eng = prog.serve(tparams, ServeConfig(**CFG))
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, max_new_tokens=NEW_TOKENS))
    done = eng.run()
    got = {r.rid: list(r.output) for r in done}
    return jm, jparams, prompts, want, got, eng, done


def reference_margin(jm, jparams, context, monkeypatch):
    """Top-1 minus top-2 of the reference's next-token logits and the flip
    bound for them, and whether a route of the last position is a near
    tie (MoE)."""
    import repro.models.moe as jmoe
    n = len(context)
    segs, _ = jm.build_segments("prefill", 1, n, s_max=n)
    fwd = jbuild_forward(segs, "sequential",
                         JCtx(local_batch=1, seq_len=n, phase="prefill"),
                         lowered=False)
    probs = []
    router = jmoe.RouterOp.kernel

    def kernel(op, p, x):
        jax.debug.callback(lambda x, wr: probs.append(np.asarray(
            jax.nn.softmax(np.asarray(x, np.float32) @ np.asarray(wr), -1))),
            x, p["wr"], ordered=True)
        return router(op, p, x)
    monkeypatch.setattr(jmoe.RouterOp, "kernel", kernel)
    ids = jnp.asarray(np.asarray(context, np.int32)[None])
    pos = jnp.arange(n, dtype=jnp.int32)[None]
    logits = np.asarray(fwd(jparams, {"ids": ids, "positions": pos})
                        ["logits"][0, -1], np.float32)
    top2 = np.sort(logits)[-2:]
    scale = max(1.0, float(np.abs(logits).max()))
    bound = 2 * (BF16["atol"] * scale + BF16["rtol"] * abs(float(top2[1])))
    route_tie = False
    if probs:
        k = jm.cfg.moe.top_k
        p = np.sort(probs[-1][0, -1])[::-1]
        route_tie = p[k - 1] - p[k] < 2 * (BF16["atol"]
                                           + BF16["rtol"] * p[k - 1])
    return float(top2[1] - top2[0]), bound, route_tie


def test_every_request_finishes_in_vocab(served):
    jm, _, prompts, want, got, eng, done = served
    assert sorted(got) == list(range(len(PROMPT_LENS)))
    for r in done:
        assert r.ok and len(r.output) == NEW_TOKENS
        assert all(0 <= t < jm.cfg.vocab for t in r.output)
        assert r.first_token_s >= r.submitted_s > 0


def test_engine_exercised_batching_tiers_and_compaction(served):
    eng = served[5]
    st = eng.stats
    assert st["prefill_reqs"] == len(PROMPT_LENS)
    assert st["prefill_steps"] < len(PROMPT_LENS)        # batched
    assert sum(1 for t, n in st["tier_steps"].items() if n) >= 2
    assert st["decode_tokens"] >= len(PROMPT_LENS) * (NEW_TOKENS - 1)
    # one host sync per engine iteration, never one per token row
    assert st["host_syncs"] <= st["decode_steps"] + st["prefill_steps"] + 1


@pytest.mark.parametrize("rid", range(len(PROMPT_LENS)))
def test_greedy_tokens_match_reference(served, rid, monkeypatch):
    jm, jparams, prompts, want, got, _, _ = served
    a, b = got[rid], want[rid]
    assert len(a) == len(b) == NEW_TOKENS
    first = next((i for i in range(NEW_TOKENS) if a[i] != b[i]), None)
    if first is None:
        return
    context = list(prompts[rid]) + b[:first]
    margin, bound, route_tie = reference_margin(jm, jparams, context,
                                                monkeypatch)
    assert margin < bound or route_tie, (
        f"request {rid}: token {first} differs ({a[first]} vs {b[first]}) "
        f"where the reference's top-1/top-2 margin {margin:.4f} exceeds "
        f"the flip bound {bound:.4f}")


def test_engine_refuses_oversized_and_cross_device_input(served):
    eng = served[5]
    with pytest.raises(ValueError):
        eng.submit(Request(99, np.zeros(40, np.int32)))      # > bucket 32
    with pytest.raises(ValueError):
        eng.submit(Request(99, np.zeros(0, np.int32)))
    prog = tcompile(eng.model.cfg, device="cpu")
    params = prog.init_params(0)
    params["embed"]["emb"]["w"] = params["embed"]["emb"]["w"].to("meta")
    with pytest.raises(ValueError):
        prog.serve(params, ServeConfig(**CFG))
    assert torch.device("cpu") == eng.device
