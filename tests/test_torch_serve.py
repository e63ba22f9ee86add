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
import repro_torch.core.plan_store as tstore
from repro_torch.api import Program
from repro_torch.api import compile as tcompile
from repro_torch.convert import params_from_numpy
from repro_torch.serve import (ChunkingDisabled, EmptyPrompt, PromptOverflow,
                               Request, ServeConfig)

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
    assert_matches_reference(jm, jparams, prompts, got, want, rid,
                             monkeypatch)


def assert_matches_reference(jm, jparams, prompts, got, want, rid,
                             monkeypatch):
    """Request ``rid``'s tokens equal the reference's, or differ first
    where the reference's choice is a near tie."""
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
    """A prompt with no decode slot left in ``s_max`` and an empty one
    are refused with typed errors; one longer than the largest bucket is
    refused only where chunked prefill is off (it is served chunked
    otherwise: tests/test_torch_lifecycle.py)."""
    eng = served[5]
    with pytest.raises(PromptOverflow):
        eng.submit(Request(99, np.zeros(64, np.int32)))      # s_max 64
    with pytest.raises(EmptyPrompt):
        eng.submit(Request(99, np.zeros(0, np.int32)))
    unchunked = Program(eng.model, eng.scheduler, device="cpu").serve(
        eng.params, ServeConfig(**CFG, chunked_prefill=False))
    with pytest.raises(ChunkingDisabled):
        unchunked.submit(Request(99, np.zeros(40, np.int32)))  # > bucket 32
    assert not eng.waiting and not unchunked.waiting
    prog = tcompile(eng.model.cfg, device="cpu")
    params = prog.init_params(0)
    params["embed"]["emb"]["w"] = params["embed"]["emb"]["w"].to("meta")
    with pytest.raises(ValueError):
        prog.serve(params, ServeConfig(**CFG))
    assert torch.device("cpu") == eng.device


# ---------------------------------------------------------------------------
# the PlanStore under the engine, every family
# ---------------------------------------------------------------------------

FAMILIES = ["smollm-135m", "deepseek-moe-16b", "mamba2-2.7b", "zamba2-1.2b"]


def _port_serve(prog, params, prompts, **kw):
    eng = prog.serve(params, ServeConfig(**CFG, **kw))
    eng.warmup()
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, max_new_tokens=NEW_TOKENS))
    return eng, {r.rid: list(r.output) for r in eng.run()}


def _no_lower(*a, **k):
    raise AssertionError("lower() called on a warm-started store")


@pytest.fixture(scope="module", params=FAMILIES)
def stored(request, tmp_path_factory):
    """A smoke engine of each family served through a path-bound store
    (``compile(plan_store_path=...)``), the same program's interpreter,
    the JAX package's interpreter, and two warm starts that may not
    lower: one from the file ``run()`` checkpointed, one from a
    ``Program.save`` bundle."""
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
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    d = tmp_path_factory.mktemp(arch)
    path, bundle = str(d / "plans.dfps"), str(d / "program.dfpb")
    prog = tcompile(arch, smoke=True, device="cpu", plan_store_path=path)
    eng, got = _port_serve(prog, tparams, prompts)
    _, interp = _port_serve(prog, tparams, prompts, lowered=False)
    cold = dict(prog.stats)
    prog.save(bundle)
    warm = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tstore, "lower", _no_lower)
        for how, wprog in (
                ("path", lambda: tcompile(arch, smoke=True, device="cpu",
                                          plan_store_path=path)),
                ("bundle", lambda: Program.load(bundle, device="cpu"))):
            weng, wgot = _port_serve(wprog(), tparams, prompts)
            warm[how] = (weng.stats["plan_store"], wgot)
    return dict(arch=arch, eng=eng, got=got, interp=interp, want=want,
                cold=cold, warm=warm, path=path, jm=jm, jparams=jparams,
                prompts=prompts)


def test_store_decode_tiers_after_the_first_are_shares(stored):
    tb = stored["eng"].stats["tier_builds"]
    assert tb[1]["misses"] > 0 and tb[1]["shares"] == 0
    for t in (2, 4):
        assert tb[t]["misses"] == 0 and tb[t]["shares"] == tb[1]["misses"]
    assert stored["cold"]["shares"] > 0 and stored["cold"]["hits"] == 0


def test_store_served_tokens_equal_interpreter_and_reference(stored,
                                                           monkeypatch):
    assert stored["got"] == stored["interp"]
    for rid in range(len(PROMPT_LENS)):
        assert_matches_reference(stored["jm"], stored["jparams"],
                                 stored["prompts"], stored["got"],
                                 stored["want"], rid, monkeypatch)
    assert stored["eng"].stats["prefill_graph_replays"] == 0     # the CPU


@pytest.mark.parametrize("how", ["path", "bundle"])
def test_saved_store_serves_with_zero_lowers(stored, how):
    snap, tokens = stored["warm"][how]
    assert snap["misses"] == 0 and snap["restore_hits"] > 0
    assert snap["restore_rejected"] == snap["restore_errors"] == 0
    assert snap["restore_hits"] + snap["shares"] \
        == stored["cold"]["misses"] + stored["cold"]["shares"]
    assert tokens == stored["got"]


def test_run_checkpoints_the_path_bound_store(stored):
    eng = stored["eng"]
    assert eng.store.path == stored["path"] and not eng.store.dirty
    assert eng.stats["plan_store"]["restore_saved"] \
        == stored["cold"]["misses"]



# ---------------------------------------------------------------------------
# chunked prefill: prompts longer than the largest bucket, every family
# ---------------------------------------------------------------------------

CHUNK_CFG = dict(max_batch=4, s_max=64, prefill_buckets=(16, 32))
LONG = (np.arange(40, dtype=np.int32) * 7 + 3) % 100
ONE_SHORT = (np.arange(33, dtype=np.int32) * 5 + 1) % 100   # n-1 = 32


def _chunk_mix(eng, mod):
    """The long prompt first, three short ones behind it, then (once they
    are done) a prompt whose chunks cover exactly n-1 tokens."""
    rng = np.random.default_rng(8)
    eng.submit(mod.Request(0, LONG.copy(), max_new_tokens=3))
    for i in (1, 2, 3):
        eng.submit(mod.Request(i, rng.integers(0, 100, 8).astype(np.int32),
                               max_new_tokens=3))
    eng.run()
    eng.submit(mod.Request(4, ONE_SHORT.copy(), max_new_tokens=2))
    eng.run()
    return {r.rid: r for r in eng.finished}


CHUNK_FAMILIES = ["chatglm3-6b", "deepseek-moe-16b", "mamba2-2.7b",
                  "zamba2-1.2b"]


@pytest.fixture(scope="module", params=CHUNK_FAMILIES)
def chunked(request):
    """The chunk mix on the JAX engine (``lowered=False``), the port's
    engine and the port's interpreter, same parameters."""
    import repro.serve as jserve
    import repro_torch.serve as tserve
    arch = request.param
    jm = jbuild_model(jget_smoke(arch), JMeshInfo())
    jparams = jm.init_params(jax.random.PRNGKey(0), phase="prefill")
    ref = JServeEngine(jm, jparams, "dynamic",
                       JServeConfig(lowered=False, **CHUNK_CFG))
    want = _chunk_mix(ref, jserve)
    prog = tcompile(arch, smoke=True, device="cpu")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    eng = prog.serve(tparams, ServeConfig(**CHUNK_CFG))
    got = _chunk_mix(eng, tserve)
    interp = prog.serve(tparams, ServeConfig(lowered=False, **CHUNK_CFG))
    got_interp = _chunk_mix(interp, tserve)
    return dict(arch=arch, jm=jm, jparams=jparams, prog=prog,
                tparams=tparams, ref=ref, want=want, eng=eng, got=got,
                interp=interp, got_interp=got_interp)


def _near_tie(c, rid, monkeypatch):
    """Tokens of ``rid`` equal the reference's, or first differ where the
    reference's choice is a near tie (attention and MoE models; the SSM
    models' chunk steps must match exactly: the reference's prefill
    forward is not what their served tokens come from)."""
    a, b = c["got"][rid].output, list(c["want"][rid].output)
    assert len(a) == len(b)
    first = next((i for i in range(len(a)) if a[i] != b[i]), None)
    if first is None:
        return
    assert c["arch"] in ARCHS + ["chatglm3-6b"], (rid, a, b)
    context = list(c["want"][rid].prompt) + b[:first]
    margin, bound, route_tie = reference_margin(c["jm"], c["jparams"],
                                                context, monkeypatch)
    assert margin < bound or route_tie, (rid, a, b, margin, bound)


@pytest.mark.parametrize("rid", range(5))
def test_chunked_tokens_match_reference(chunked, rid, monkeypatch):
    assert chunked["got"][rid].ok and chunked["want"][rid].ok
    assert chunked["got"][rid].output == chunked["got_interp"][rid].output
    _near_tie(chunked, rid, monkeypatch)


def test_chunked_dispatch_and_counters_match_reference(chunked):
    eng, ref = chunked["eng"], chunked["ref"]
    assert eng.dispatch_log == ref.dispatch_log
    assert eng.dispatch_log == chunked["interp"].dispatch_log
    for k in ("chunk_steps", "prefill_steps", "decode_steps",
              "decode_tokens", "finished", "peak_active"):
        assert eng.stats[k] == ref.stats[k], k
    # 40 tokens: chunks (0, 32) and (32, 16); 33 tokens: (0, 32)
    assert eng.stats["chunk_steps"] == 3
    assert eng.stats["chunk_graph_replays"] == 0           # the CPU
    assert len(chunked["got"][4].output) == 2              # one short


def test_chunked_prefill_fairness_ttft_ordering(chunked):
    """The long prompt submitted first does not monopolize dispatch: the
    short prompts prefill before its last chunk and see their first
    token strictly earlier.  On the attention models fairness does not
    change its tokens (against a solo run); on the SSM models a decode
    step between two chunks advances the chunking row's recurrent state,
    in the reference as here, so there the solo run is held to the
    reference's solo run instead."""
    import repro.serve as jserve
    log = chunked["eng"].dispatch_log
    last_chunk = max(i for i, e in enumerate(log)
                     if e[0] == "chunk" and 0 in e[1])
    first_prefill = min(i for i, e in enumerate(log) if e[0] == "prefill")
    assert first_prefill < last_chunk, log
    done = chunked["got"]
    for i in (1, 2, 3):
        assert done[i].first_token_s < done[0].first_token_s, i
    solo = chunked["prog"].serve(chunked["tparams"], ServeConfig(**CHUNK_CFG))
    solo.submit(Request(0, LONG.copy(), max_new_tokens=3))
    ref = JServeEngine(chunked["jm"], chunked["jparams"], "dynamic",
                       JServeConfig(lowered=False, **CHUNK_CFG))
    ref.submit(jserve.Request(0, LONG.copy(), max_new_tokens=3))
    ref_solo = list(ref.run()[0].output)
    solo_out = solo.run()[0].output
    if chunked["jm"].cfg.family in ("ssm", "hybrid"):
        assert solo_out == ref_solo
    else:
        assert solo_out == done[0].output
        assert ref_solo == list(chunked["want"][0].output)


@pytest.mark.parametrize("arch", ["chatglm3-6b", "deepseek-moe-16b"])
def test_chunked_prefill_matches_offline_greedy(arch, monkeypatch):
    """A prompt longer than every bucket, chunked through the decode
    graph, against the port's own offline greedy (a whole-prompt prefill
    forward per token), up to a near tie of the reference's."""
    jm = jbuild_model(jget_smoke(arch), JMeshInfo())
    jparams = jm.init_params(jax.random.PRNGKey(0), phase="prefill")
    prog = tcompile(arch, smoke=True, device="cpu")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    eng = prog.serve(tparams, ServeConfig(**CHUNK_CFG))
    eng.submit(Request(0, LONG.copy(), max_new_tokens=3))
    got = eng.run()[0].output
    assert eng.stats["chunk_steps"] >= 2
    ids, want = list(LONG), []
    for _ in range(3):
        n = len(ids)
        step = prog.prefill(1, n, s_max=64)
        out = step(tparams, {
            "ids": torch.tensor([ids], dtype=torch.int32),
            "positions": torch.arange(n, dtype=torch.int32)[None]})
        want.append(int(out["logits"][0, -1].float().argmax()))
        ids.append(want[-1])
    first = next((i for i in range(3) if got[i] != want[i]), None)
    if first is not None:
        margin, bound, route_tie = reference_margin(
            jm, jparams, list(LONG) + want[:first], monkeypatch)
        assert margin < bound or route_tie, (got, want)


def test_chunked_prefill_disabled_and_oversized_reject(chunked):
    prog, tparams = chunked["prog"], chunked["tparams"]
    off = prog.serve(tparams, ServeConfig(chunked_prefill=False, **CHUNK_CFG))
    with pytest.raises(ChunkingDisabled, match="largest prefill bucket"):
        off.submit(Request(0, LONG.copy(), max_new_tokens=2))
    with pytest.raises(PromptOverflow, match="s_max"):
        chunked["eng"].submit(Request(9, np.zeros(64, np.int32)))
    assert not off.waiting and not chunked["eng"].waiting
