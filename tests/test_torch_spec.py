"""Speculative decode in the port's serve engine, against its own plain
decode and against the JAX package's engine.

Every case of the JAX package's ``tests/test_spec_decode.py`` that
concerns speculative decode runs here on the port's engine with the same
assertions: spec greedy decode equals plain greedy decode bitwise
(``ngram`` and ``self`` × k 2 and 4 × dense and paged), an eos inside a
draft window cuts where plain decode stops, preemption and resume,
sampled spec equals plain sampled, the warm restart lowers nothing, a
paged rollback under injected allocation denials falls back and leaks
no page, ``k="auto"`` explores and then exploits, and the guard rails
(recurrent-state models, k against the smallest bucket, ``self`` on a
model of two stacks).

Then the port's engine is held to the JAX engine at
``ServeConfig(lowered=False)`` on the same requests and parameters
(``params_from_numpy`` of the reference's ``init_params(PRNGKey(0))``):
the same tokens — equal, or differing first where the reference's
choice is a near tie (the rule of ``tests/test_torch_serve.py``) — and,
where the tokens are equal, the same ``spec_steps``, ``spec_drafted``,
``spec_accepted``, ``spec_rollbacks``, ``spec_fallbacks`` and
``page_denied``.  Sampled tokens are not compared across the packages
(JAX draws with threefry, the port with Philox): each package's sampled
spec run equals its own plain sampled run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.serve as jserve
import repro_torch.core.plan_store as tstore
import repro_torch.serve as tserve
from repro.configs import get_smoke_config as jget_smoke
from repro.core import ScheduleContext as JCtx
from repro.core.autotune import AutoPolicy as JAutoPolicy
from repro.core.strategies import get_strategy as jget_strategy
from repro.models.base import build_forward as jbuild_forward
from repro.models.layers import MeshInfo as JMeshInfo
from repro.models.registry import build_model as jbuild_model
from repro_torch.api import Program
from repro_torch.api import compile as tcompile
from repro_torch.convert import params_from_numpy
from repro_torch.core.autotune import AutoPolicy
from repro_torch.core.strategies import get_strategy
from repro_torch.core.strategies.registry import get_entry

CFG = dict(max_batch=4, s_max=64, prefill_buckets=(16, 32))
SAMPLED = dict(temperature=0.8, top_k=20)
COUNTERS = ("spec_steps", "spec_drafted", "spec_accepted", "spec_rollbacks",
            "spec_fallbacks", "page_denied", "decode_steps", "decode_tokens",
            "host_syncs", "preempted", "resumed", "alloc_denied")
BF16 = dict(atol=3e-2, rtol=3e-2)


@pytest.fixture(scope="module")
def setup():
    jm = jbuild_model(jget_smoke("chatglm3-6b"), JMeshInfo())
    jparams = jm.init_params(jax.random.PRNGKey(0), phase="prefill")
    prog = tcompile("chatglm3-6b", smoke=True, device="cpu",
                    policy="sequential")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jm, jparams, prog, tparams


def make_engine(setup, scheduler=None, store=None, **kw):
    _, _, prog, tparams = setup
    if scheduler is not None or store is not None:
        prog = Program(prog.model, scheduler or prog.policy, device="cpu",
                       store=store)
    return prog.serve(tparams, tserve.ServeConfig(**{**CFG, **kw}))


def make_reference(setup, scheduler="sequential", **kw):
    jm, jparams, _, _ = setup
    sched = jget_strategy(scheduler) if isinstance(scheduler, str) \
        else scheduler
    return jserve.ServeEngine(jm, jparams, sched, jserve.ServeConfig(
        lowered=False, **{**CFG, **kw}))


def prompts_for(n, seed=0, lo=4, hi=14):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 100, int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def run_outputs(eng, reqs):
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    assert all(r.ok for r in done), [r.result for r in done if not r.ok]
    return {r.rid: list(r.output) for r in done}


def trace(mod=tserve, n=4, seed=3, max_new=10, stagger=True, **req_kw):
    """Staggered max_new: rows finish apart and the engine walks down
    the decode tiers mid-run."""
    return [mod.Request(rid=i, prompt=pr.copy(),
                        max_new_tokens=max_new + (2 * i if stagger else 0),
                        **req_kw)
            for i, pr in enumerate(prompts_for(n, seed=seed))]


def _backend(cache, mod=tserve):
    return mod.PagedCache(page_size=16) if cache == "paged" else None


def _spec(mod, proposer, k, **kw):
    return mod.SpecConfig(proposer=proposer, k=k, **kw)


# -- configuration and the ngram proposer ------------------------------------


def test_spec_config_validation():
    with pytest.raises(ValueError):
        tserve.SpecConfig(k=0)
    with pytest.raises(ValueError):
        tserve.SpecConfig(proposer="nope")
    tserve.SpecConfig(k="auto")
    assert isinstance(tserve.resolve_proposer("self"),
                      tserve.SelfSpecProposer)
    assert tserve.DRAFT_K_CANDIDATES == (2, 4, 8)
    assert tserve.ServeConfig().spec is None


@pytest.mark.parametrize("stream,k", [([1, 2, 3, 4, 1, 2, 3], 3), ([5], 4),
                                      ([7, 8, 7, 8], 4),
                                      ([3, 1, 3, 1, 2, 3, 1], 5)])
def test_ngram_proposer_drafts_like_the_reference(stream, k):
    got = tserve.NGramProposer().draft([stream], k)
    want = jserve.NGramProposer().draft([stream], k)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (1, k) and got.dtype == np.int32


def test_ngram_proposer_drafts_continuations():
    prop = tserve.NGramProposer()
    np.testing.assert_array_equal(prop.draft([[1, 2, 3, 4, 1, 2, 3]], 3),
                                  [[4, 1, 2]])
    np.testing.assert_array_equal(prop.draft([[5]], 4), [[5, 5, 5, 5]])
    assert prop.draft([[7, 8, 7, 8]], 4).shape == (1, 4)


def test_engine_refuses_a_spec_that_is_not_a_spec_config(setup):
    with pytest.raises(ValueError, match="SpecConfig"):
        make_engine(setup, spec={"k": 2})


# -- bitwise spec greedy == plain greedy, and == the JAX engine --------------


@pytest.fixture(scope="module")
def plain_greedy(setup):
    out = {}
    for cache in ("dense", "paged"):
        eng = make_engine(setup, cache=_backend(cache))
        out[cache] = run_outputs(eng, trace())
    assert out["dense"] == out["paged"]
    return out


def _reference_margin(setup, context):
    """Top-1 minus top-2 of the reference's next-token logits after
    ``context``, and the bound within which the port may flip them."""
    jm, jparams, _, _ = setup
    n = len(context)
    segs, _ = jm.build_segments("prefill", 1, n, s_max=n)
    fwd = jbuild_forward(segs, "sequential",
                         JCtx(local_batch=1, seq_len=n, phase="prefill"),
                         lowered=False)
    logits = np.asarray(fwd(jparams, {
        "ids": jnp.asarray(np.asarray(context, np.int32)[None]),
        "positions": jnp.arange(n, dtype=jnp.int32)[None]})
        ["logits"][0, -1], np.float32)
    top2 = np.sort(logits)[-2:]
    scale = max(1.0, float(np.abs(logits).max()))
    bound = 2 * (BF16["atol"] * scale + BF16["rtol"] * abs(float(top2[1])))
    return float(top2[1] - top2[0]), bound


def assert_matches_reference(setup, reqs, got, want):
    """Every request's tokens equal the reference's, or differ first
    where the reference's choice is a near tie."""
    for r in reqs:
        a, b = got[r.rid], want[r.rid]
        first = next((i for i in range(min(len(a), len(b)))
                      if a[i] != b[i]), None)
        if first is None:
            assert len(a) == len(b), r.rid
            continue
        margin, bound = _reference_margin(
            setup, list(r.prompt) + b[:first])
        assert margin < bound, (
            f"request {r.rid}: token {first} differs ({a[first]} vs "
            f"{b[first]}) where the reference's margin {margin:.4f} "
            f"exceeds the flip bound {bound:.4f}")


def assert_counters_match(eng, ref, got, want):
    """The spec counters equal the reference's wherever the tokens do
    (the counters follow the tokens)."""
    if got != want:
        return
    for key in COUNTERS:
        assert eng.stats[key] == ref.stats[key], key
    assert eng.stats["tier_steps"] == ref.stats["tier_steps"]
    assert eng.dispatch_log == ref.dispatch_log


@pytest.mark.parametrize("cache", ("dense", "paged"))
@pytest.mark.parametrize("proposer,k", [("ngram", 2), ("ngram", 4),
                                        ("self", 2), ("self", 4)])
def test_spec_greedy_bitwise_equals_plain(setup, plain_greedy, proposer, k,
                                          cache):
    eng = make_engine(setup, cache=_backend(cache),
                      spec=_spec(tserve, proposer, k))
    got = run_outputs(eng, trace())
    assert got == plain_greedy[cache]
    st = eng.stats
    assert st["spec_steps"] > 0
    assert len(st["tier_steps"]) > 1
    # one harvest a decode iteration: spec steps are synchronous
    assert st["host_syncs"] <= st["decode_steps"] + st["prefill_steps"]


@pytest.mark.parametrize("cache", ("dense", "paged"))
@pytest.mark.parametrize("proposer,k", [("ngram", 2), ("ngram", 4),
                                        ("self", 2), ("self", 4)])
def test_spec_engine_matches_the_jax_engine(setup, proposer, k, cache):
    eng = make_engine(setup, cache=_backend(cache),
                      spec=_spec(tserve, proposer, k))
    got = run_outputs(eng, trace())
    ref = make_reference(setup, cache=_backend(cache, jserve),
                         spec=_spec(jserve, proposer, k))
    want = run_outputs(ref, trace(jserve))
    assert_matches_reference(setup, trace(), got, want)
    assert_counters_match(eng, ref, got, want)
    assert eng.stats["spec_steps"] > 0


def test_spec_greedy_with_eos_mid_draft(setup, plain_greedy):
    """An eos accepted inside a draft window cuts the stream exactly
    where plain decode stops — and where the JAX engine's does."""
    eos, rid = None, None
    for r, out in plain_greedy["dense"].items():
        if len(out) > 3:
            eos, rid = out[2], r
            break
    assert eos is not None
    want = run_outputs(make_engine(setup), trace(eos_id=eos))
    spec = make_engine(setup, spec=_spec(tserve, "ngram", 4))
    got = run_outputs(spec, trace(eos_id=eos))
    assert got == want
    assert len(want[rid]) <= len(plain_greedy["dense"][rid])
    ref = make_reference(setup, spec=_spec(jserve, "ngram", 4))
    jwant = run_outputs(ref, trace(jserve, eos_id=eos))
    assert_matches_reference(setup, trace(eos_id=eos), got, jwant)
    assert_counters_match(spec, ref, got, jwant)


def test_spec_survives_preemption_resume(setup):
    """Preempt-and-requeue under a memory-pressure window: the resumed
    speculative rows still match an uninterrupted plain run bitwise, and
    the JAX engine's speculative run."""
    want = run_outputs(make_engine(setup),
                       trace(seed=14, stagger=False, max_new=6))
    eng = make_engine(setup, faults=tserve.FaultInjector(
        pressure=((2, 5, 3),)), spec=_spec(tserve, "ngram", 2))
    got = run_outputs(eng, trace(seed=14, stagger=False, max_new=6))
    assert got == want
    assert eng.stats["preempted"] >= 1
    ref = make_reference(setup, faults=jserve.FaultInjector(
        pressure=((2, 5, 3),)), spec=_spec(jserve, "ngram", 2))
    jwant = run_outputs(ref, trace(jserve, seed=14, stagger=False,
                                   max_new=6))
    assert_matches_reference(setup, trace(seed=14, stagger=False,
                                          max_new=6), got, jwant)
    assert_counters_match(eng, ref, got, jwant)


def test_spec_sampled_equals_plain_sampled(setup):
    """Lossless under sampling: the verify step re-samples each position
    with the key plain decode would use.  The JAX engine holds the same
    for its own (threefry) draws."""
    def reqs(mod):
        return [mod.Request(rid=i, prompt=pr.copy(), max_new_tokens=8,
                            seed=7 * i)
                for i, pr in enumerate(prompts_for(4, seed=6))]

    samp = tserve.SamplingConfig(**SAMPLED)
    want = run_outputs(make_engine(setup, sampling=samp), reqs(tserve))
    spec = make_engine(setup, sampling=samp,
                       spec=_spec(tserve, "ngram", 3))
    assert run_outputs(spec, reqs(tserve)) == want
    assert spec.stats["spec_steps"] > 0
    jsamp = jserve.SamplingConfig(**SAMPLED)
    jwant = run_outputs(make_reference(setup, sampling=jsamp),
                        reqs(jserve))
    jgot = run_outputs(make_reference(setup, sampling=jsamp,
                                      spec=_spec(jserve, "ngram", 3)),
                       reqs(jserve))
    assert jgot == jwant


def test_seed_never_salts_a_spec_key(setup, monkeypatch):
    """Engines that differ only in seed form the same plan keys and the
    same verify graph keys (recorded by a spy: nothing is captured on
    the CPU)."""
    samp = tserve.SamplingConfig(**SAMPLED)

    def keys(seed):
        store = tstore.PlanStore()
        eng = make_engine(setup, store=store, sampling=samp, seed=seed,
                          spec=_spec(tserve, "ngram", 2))
        eng.warmup()
        run_outputs(eng, [tserve.Request(rid=0, prompt=prompts_for(1)[0],
                                         max_new_tokens=4, seed=seed)])
        graphs = []
        with monkeypatch.context() as mp:
            mp.setattr(eng.store, "get_or_build",
                       lambda key, build: graphs.append(key[:1] + key[2:]))
            eng._spec_graph("verify", 1, 2)
        return sorted(map(repr, store._plans.keys())), graphs
    a, b = keys(0), keys(123)
    assert a == b
    assert a[1][0][0] == "spec_verify" and a[1][0][-2:] == (1, 2)


# -- the store: no lowering after warmup, warm restart -----------------------


def test_spec_warmup_then_serving_lowers_nothing(setup):
    store = tstore.PlanStore()
    eng = make_engine(setup, store=store, spec=_spec(tserve, "self", 4))
    eng.warmup(prefill=[(b, s) for b in eng.prefill_tiers
                        for s in CFG["prefill_buckets"]])
    builds = eng.stats["spec_builds"]
    assert set(builds) == {(t, 4) for t in eng.tiers}
    assert all(b["misses"] == 0 for b in builds.values()), builds
    misses = store.stats["misses"]
    run_outputs(eng, trace(seed=9))
    assert store.stats["misses"] == misses
    assert eng.stats["spec_builds"] == builds


def test_spec_warm_restart_zero_lowers_on_verify_buckets(setup, tmp_path,
                                                         monkeypatch):
    """A restarted engine restores or specializes every verify bucket
    from the persisted store — never a cold ``lower()``."""
    path = str(tmp_path / "spec.dfps")
    spec_cfg = _spec(tserve, "ngram", 4)
    store = tstore.PlanStore(path=path)
    eng = make_engine(setup, store=store, spec=spec_cfg)
    eng.warmup()
    run_outputs(eng, trace(seed=9))
    assert store.save() >= 1

    def bomb(*a, **k):
        raise AssertionError("warm restart re-lowered a verify bucket")
    monkeypatch.setattr(tstore, "lower", bomb)
    store2 = tstore.PlanStore.open(path)
    eng2 = make_engine(setup, store=store2, spec=spec_cfg)
    eng2.warmup()
    builds = eng2.stats["spec_builds"]
    assert builds and all(b["misses"] == 0 for b in builds.values()), builds
    assert sum(b["shares"] + b["restore_hits"]
               for b in builds.values()) > 0, builds
    got = run_outputs(eng2, trace(seed=9))
    assert got == run_outputs(make_engine(setup), trace(seed=9))


# -- paged rollback under faults ---------------------------------------------


def test_paged_rollback_under_alloc_denial(setup):
    """Allocation denials make the verify reservation fail: the engine
    falls back to plain decode for that iteration, stays bitwise
    correct, frees every page at the end, and counts as the JAX engine
    does."""
    want = run_outputs(make_engine(setup, cache=_backend("paged")),
                       trace(seed=10, max_new=12))
    eng = make_engine(setup, cache=_backend("paged"),
                      faults=tserve.FaultInjector(alloc_fail=(4, 5, 6, 7)),
                      spec=_spec(tserve, "ngram", 4))
    got = run_outputs(eng, trace(seed=10, max_new=12))
    assert got == want
    st = eng.stats
    assert st["spec_fallbacks"] >= 1, st
    assert st["spec_steps"] > 0, st
    assert int(eng.cache.blocks_used.sum()) == 0
    assert eng.cache.row_owner == {}
    ref = make_reference(setup, cache=_backend("paged", jserve),
                         faults=jserve.FaultInjector(alloc_fail=(4, 5, 6, 7)),
                         spec=_spec(jserve, "ngram", 4))
    jwant = run_outputs(ref, trace(jserve, seed=10, max_new=12))
    assert_matches_reference(setup, trace(seed=10, max_new=12), got, jwant)
    assert_counters_match(eng, ref, got, jwant)


def test_paged_rollback_returns_the_rejected_pages(setup):
    """Each verify step reserves W = k + 1 positions of pages; after the
    harvest a row holds only the pages its accepted length needs."""
    eng = make_engine(setup, cache=tserve.PagedCache(page_size=4),
                      spec=_spec(tserve, "ngram", 8))
    for r in trace(seed=11, max_new=14):
        eng.submit(r)
    while eng._busy():
        eng.step()
        for row in eng.active:
            assert int(eng.cache.blocks_used[row]) == \
                eng.cache.pages_needed(int(eng.cache.lengths[row]))
    assert eng.stats["spec_rollbacks"] > 0
    assert eng.cache.pages_used() == 0


# -- draft-k autotuning ------------------------------------------------------


def test_spec_decode_registry_param_space():
    entry = get_entry("spec_decode")
    assert dict(entry.param_space)["draft_k"] == (2, 4, 8)
    assert not entry.tunable
    assert entry.factory(draft_k=4).name == "sequential"


@pytest.mark.parametrize("mod", ["torch", "jax"])
def test_auto_policy_spec_draft_k_explore_then_exploit(mod):
    policy = AutoPolicy() if mod == "torch" else JAutoPolicy()
    store = (tstore.PlanStore() if mod == "torch"
             else __import__("repro.core", fromlist=["PlanStore"])
             .PlanStore())
    policy.bind_store(store)
    arch, cands = "toy-arch", (2, 4, 8)
    seen = []
    for _ in cands:
        k = policy.spec_draft_k(arch=arch, candidates=cands)
        seen.append(k)
        policy.observe(phase="spec_decode", arch=arch, local_batch=4,
                       seq_len=k, seconds=0.01,
                       stats={"draft_k": k,
                              "acceptance_rate": 0.9 if k == 4 else 0.1})
    assert seen == [2, 4, 8]
    assert policy.spec_draft_k(arch=arch, candidates=cands) == 4
    fresh = type(policy)()
    fresh.bind_store(store)
    assert fresh.spec_draft_k(arch=arch, candidates=cands) == 4


def test_spec_auto_k_engine_stays_bitwise_greedy(setup, plain_greedy):
    """k='auto' under the auto policy: whatever k the picker explores,
    greedy outputs never change, and the policy saw every step."""
    auto = get_strategy("auto")
    eng = make_engine(setup, scheduler=auto,
                      spec=_spec(tserve, "ngram", "auto"))
    ks = []
    pick = eng._pick_k
    eng._pick_k = lambda: ks.append(pick()) or ks[-1]
    got = run_outputs(eng, trace())
    assert got == plain_greedy["dense"]
    st = eng.stats
    assert st["spec_steps"] > 0
    assert ks[:3] == [2, 4, 8]                 # explores every candidate
    obs = auto.policy._spec_obs
    assert sum(rec["steps"] for rec in obs.values()) == st["spec_steps"]
    assert set(st["spec_builds"]) <= {(t, k) for t in eng.tiers
                                      for k in (2, 4, 8)}


def test_spec_auto_k_matches_the_jax_engine(setup):
    """Under k='auto' the draft lengths depend on measured step times,
    so the two packages may choose differently: the tokens are held to
    the reference's, the counters where the draft lengths agree."""
    eng = make_engine(setup, scheduler=get_strategy("auto"),
                      spec=_spec(tserve, "ngram", "auto"))
    got = run_outputs(eng, trace())
    ref = make_reference(setup, scheduler=jget_strategy("auto"),
                         spec=_spec(jserve, "ngram", "auto"))
    want = run_outputs(ref, trace(jserve))
    assert_matches_reference(setup, trace(), got, want)
    assert eng.stats["spec_steps"] > 0 and ref.stats["spec_steps"] > 0


# -- guard rails -------------------------------------------------------------


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_spec_rejects_recurrent_state_models(arch):
    prog = tcompile(arch, smoke=True, device="cpu", policy="sequential")
    params = prog.init_params(0)
    with pytest.raises(ValueError, match="positional"):
        prog.serve(params, tserve.ServeConfig(
            max_batch=2, s_max=64, prefill_buckets=(32,),
            spec=_spec(tserve, "ngram", 2)))


def test_self_spec_refuses_a_model_of_two_stacks():
    prog = tcompile("deepseek-moe-16b", smoke=True, device="cpu",
                    policy="sequential")
    params = prog.init_params(0)
    cfg = dict(CFG, spec=_spec(tserve, "self", 2))
    with pytest.raises(ValueError, match="single layer stack"):
        prog.serve(params, tserve.ServeConfig(**cfg))
    eng = prog.serve(params, tserve.ServeConfig(
        **dict(CFG, spec=_spec(tserve, "ngram", 2))))
    plain = prog.serve(params, tserve.ServeConfig(**CFG))
    assert run_outputs(eng, trace(n=3)) == run_outputs(plain, trace(n=3))
    assert eng.stats["spec_steps"] > 0


def test_spec_k_must_fit_smallest_bucket(setup):
    with pytest.raises(ValueError, match="verify width"):
        make_engine(setup, spec=_spec(tserve, "ngram", 16))
    with pytest.raises(ValueError, match="verify width"):
        make_engine(setup, prefill_buckets=(4, 32),
                    spec=_spec(tserve, "ngram", "auto"))
