"""The port's on-device sampling (src/repro_torch/serve/sampling.py and
the sampled branches of serve/engine.py) against the JAX package's
contract, and the synchronous host loop.

JAX draws with threefry (``jax.random.categorical``); the port draws
with Philox4x32-10 in plain torch integer ops, so sampled tokens cannot
match across the packages.  What the two share, and what is held here,
is the contract of the JAX package's ``tests/test_spec_decode.py``
sampling tests: greedy is a pure argmax (bitwise the engine's greedy
tokens); a token depends only on ``(seed, rid, position)`` — not on the
batch, a preemption's resume or a restart; the policy salts the graph
keys, a seed never; ``Request.seed`` overrides ``ServeConfig.seed``.
The filter's ``-inf`` mask equals the JAX package's on the same f32
logits; the generator meets Philox4x32-10's known-answer vectors and a
pure-Python integer implementation; a seeded chi-square test holds the
sampled frequencies to the softmax of the filtered logits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import repro.serve as jserve
import repro.serve.sampling as jsamp
import repro_torch.core.plan_store as tstore
import repro_torch.serve as tserve
import repro_torch.serve.sampling as tsamp
from repro.configs import get_smoke_config as jget_smoke
from repro.models.layers import MeshInfo as JMeshInfo
from repro.models.registry import build_model as jbuild_model
from repro_torch.api import Program
from repro_torch.api import compile as tcompile
from repro_torch.convert import params_from_numpy

CFG = dict(max_batch=4, s_max=64, prefill_buckets=(16, 32))
SAMPLED = tserve.SamplingConfig(temperature=0.8, top_k=20)


@pytest.fixture(scope="module")
def setup():
    jm = jbuild_model(jget_smoke("chatglm3-6b"), JMeshInfo())
    jparams = jm.init_params(jax.random.PRNGKey(0), phase="prefill")
    prog = tcompile("chatglm3-6b", smoke=True, device="cpu",
                    policy="sequential")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jm, jparams, prog, tparams


def make_engine(setup, store=None, **kw):
    _, _, prog, tparams = setup
    if store is not None:
        prog = Program(prog.model, prog.policy, device="cpu", store=store)
    return prog.serve(tparams, tserve.ServeConfig(**{**CFG, **kw}))


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


def sampled_reqs(n=4, seed=5, max_new=8, **kw):
    return [tserve.Request(rid=i, prompt=pr.copy(), max_new_tokens=max_new,
                           seed=100 + i, **kw)
            for i, pr in enumerate(prompts_for(n, seed=seed))]


# -- the generator -----------------------------------------------------------

KAT = [  # Random123's kat_vectors, philox4x32 with 10 rounds
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT, ids=["zeros", "ones", "pi"])
def test_philox_known_answer(ctr, key, want):
    got = tsamp.philox4x32([torch.tensor(c, dtype=torch.int64) for c in ctr],
                           [torch.tensor(k, dtype=torch.int64) for k in key])
    assert tuple(int(w) for w in got) == want


def _philox_py(ctr, key):
    """Philox4x32-10 on Python integers (the specification)."""
    m = 0xFFFFFFFF
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & m, (k1 + 0xBB67AE85) & m
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & m,
                          (p0 >> 32) ^ c3 ^ k1, p0 & m)
    return c0, c1, c2, c3


def test_random_bits_equal_python_integers_over_a_seeded_grid():
    """``random_bits`` keyed by ``(seed, rid, position)``: vocabulary
    entry ``v`` is word ``v % 4`` at counter ``(v // 4, position, 0, 0)``,
    key ``(seed, rid)`` — seeds across the whole unsigned range (passed
    as int32 bit patterns, as the engine stages them)."""
    rng = np.random.default_rng(0)
    seeds = rng.integers(0, 1 << 32, 6, dtype=np.uint64).astype(np.uint32)
    seeds[0] = 0xFFFFFFFF
    rids = rng.integers(0, 1 << 31, 6)
    pos = rng.integers(0, 1 << 20, 6)
    vocab = 23
    bits = tsamp.random_bits(torch.from_numpy(seeds.view(np.int32)),
                             torch.from_numpy(rids), torch.from_numpy(pos),
                             vocab)
    for i in range(6):
        for v in range(vocab):
            want = _philox_py((v // 4, int(pos[i]), 0, 0),
                              (int(seeds[i]), int(rids[i])))[v % 4]
            assert int(bits[i, v]) == want, (i, v)


def test_uniform_stays_inside_the_open_interval():
    u = tsamp.uniform(torch.tensor([0, 511, 512, 0xFFFFFFFF],
                                   dtype=torch.int64))
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    assert u[0] == u[1] == 2.0 ** -24 and u[3] == 1 - 2.0 ** -24


# -- the policy --------------------------------------------------------------


def test_greedy_sample_tokens_is_argmax():
    logits = np.random.default_rng(0).standard_normal((4, 7, 50)) \
        .astype(np.float32)
    want = np.argmax(logits, axis=-1)
    t = torch.from_numpy(logits)
    toks = tsamp.sample_tokens(t, tsamp.GREEDY,
                               seeds=torch.zeros((4, 1), dtype=torch.int32),
                               rids=torch.zeros((4, 1), dtype=torch.int32),
                               positions=torch.zeros((4, 7),
                                                     dtype=torch.int32))
    np.testing.assert_array_equal(toks.numpy(), want)
    assert toks.dtype == torch.int32
    # None resolves to greedy, as in the JAX package
    np.testing.assert_array_equal(
        tsamp.sample_tokens(t, None, seeds=0, rids=0, positions=0).numpy(),
        np.asarray(jsamp.sample_tokens(jnp.asarray(logits), None, seeds=0,
                                       rids=0, positions=0)))


def test_sampled_tokens_depend_only_on_seed_rid_position():
    cfg = tserve.SamplingConfig(temperature=0.7, top_k=30)
    logits = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 200)).astype(np.float32))
    seeds = torch.tensor([1, 1, 2, 2], dtype=torch.int32)
    rids = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
    pos = torch.tensor([5, 5, 9, 9], dtype=torch.int32)
    full = tsamp.sample_tokens(logits, cfg, seeds=seeds, rids=rids,
                               positions=pos)
    perm = torch.tensor([2, 0, 3, 1])
    shuf = tsamp.sample_tokens(logits[perm], cfg, seeds=seeds[perm],
                               rids=rids[perm], positions=pos[perm])
    assert torch.equal(full[perm], shuf)
    for i in range(4):
        solo = tsamp.sample_tokens(logits[i:i + 1], cfg,
                                   seeds=seeds[i:i + 1], rids=rids[i:i + 1],
                                   positions=pos[i:i + 1])
        assert int(solo[0]) == int(full[i])
    many = tsamp.sample_tokens(
        logits[0].expand(16, 200), cfg,
        seeds=torch.full((16,), 1, dtype=torch.int32),
        rids=torch.zeros((16,), dtype=torch.int32),
        positions=torch.arange(16, dtype=torch.int32))
    assert len(set(many.tolist())) > 1
    # the rid and the seed enter the key too
    for kw in (dict(seeds=seeds[:1] + 1, rids=rids[:1]),
               dict(seeds=seeds[:1], rids=rids[:1] + 1)):
        draws = {int(tsamp.sample_tokens(logits[:1], cfg, positions=p, **kw))
                 for p in pos.new_tensor(range(12))[:, None]}
        base = {int(tsamp.sample_tokens(logits[:1], cfg, seeds=seeds[:1],
                                        rids=rids[:1], positions=p))
                for p in pos.new_tensor(range(12))[:, None]}
        assert draws != base


def test_sampling_salt_and_validation():
    cases = (None, tsamp.GREEDY, tserve.SamplingConfig(temperature=0.8,
                                                       top_k=20, top_p=0.9),
             tserve.SamplingConfig(temperature=1.0),
             tserve.SamplingConfig(temperature=0.5, top_p=0.25))
    for cfg in cases:
        jcfg = None if cfg is None else jsamp.SamplingConfig(
            **{f: getattr(cfg, f) for f in ("temperature", "top_k",
                                             "top_p")})
        assert tsamp.sampling_salt(cfg) == jsamp.sampling_salt(jcfg)
        assert tsamp.resolve_sampling(cfg).identity() \
            == jsamp.resolve_sampling(jcfg).identity()
    assert tsamp.sampling_salt(None) == "greedy"
    assert tsamp.sampling_salt(cases[2]) == "t0.8k20p0.9"
    for bad in (dict(temperature=-1.0), dict(top_p=0.0), dict(top_p=1.5),
                dict(top_k=-1)):
        with pytest.raises(ValueError):
            tserve.SamplingConfig(**bad)
        with pytest.raises(ValueError):
            jsamp.SamplingConfig(**bad)


@pytest.mark.parametrize("t,k,p", [(1.0, 0, 1.0), (0.8, 20, 1.0),
                                   (0.8, 0, 0.9), (0.7, 50, 0.95),
                                   (1.3, 5, 0.5), (0.5, 0, 0.3),
                                   (2.0, 199, 0.999)])
def test_filter_mask_equals_the_jax_packages(t, k, p):
    """The kept set after temperature, top-k and top-p — ties at the k-th
    value kept, the top token always kept — is the JAX package's on the
    same f32 logits (ties planted in the last row)."""
    rng = np.random.default_rng(int(t * 100) + k)
    logits = (rng.standard_normal((6, 200)) * 3).astype(np.float32)
    logits[5, :40] = np.round(logits[5, :40])        # many exact ties
    jcfg = jsamp.SamplingConfig(temperature=t, top_k=k, top_p=p)
    want = np.asarray(jsamp._filter_logits(jnp.asarray(logits), jcfg))
    got = tsamp._filter_logits(torch.from_numpy(logits),
                               tserve.SamplingConfig(t, k, p)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_array_equal(got[~np.isneginf(got)],
                                  want[~np.isneginf(want)])
    assert (~np.isneginf(got)).sum(-1).min() >= 1


def test_sampled_frequencies_follow_the_filtered_softmax():
    """Seeded chi-square: 20000 draws (one position each) of one row of
    logits follow softmax(filtered logits) over the kept tokens."""
    cfg = tserve.SamplingConfig(temperature=0.9, top_k=12, top_p=0.95)
    logits = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, 64)).astype(np.float32) * 2)
    n = 20000
    toks = tsamp.sample_tokens(logits.expand(n, 64), cfg,
                               seeds=torch.full((n,), 11, dtype=torch.int32),
                               rids=torch.full((n,), 3, dtype=torch.int32),
                               positions=torch.arange(n, dtype=torch.int32))
    filt = tsamp._filter_logits(logits, cfg)[0]
    kept = torch.nonzero(~torch.isneginf(filt))[:, 0]
    probs = torch.softmax(filt[kept].double(), 0).numpy()
    counts = np.bincount(toks.numpy(), minlength=64)
    assert counts[np.setdiff1d(np.arange(64), kept.numpy())].sum() == 0
    chi2 = stats.chisquare(counts[kept.numpy()], probs * n)
    assert chi2.pvalue > 1e-3, chi2


# -- the engine --------------------------------------------------------------


def test_greedy_config_is_the_default_engine_bitwise(setup):
    """``SamplingConfig()`` is greedy: the default engine's tokens, and
    the same ``greedy`` salt in the graph keys."""
    reqs = lambda: [tserve.Request(rid=i, prompt=pr.copy(),  # noqa: E731
                                   max_new_tokens=8)
                    for i, pr in enumerate(prompts_for(4, seed=2))]
    base = make_engine(setup)
    want = run_outputs(base, reqs())
    for cfg in (tserve.SamplingConfig(), tserve.SamplingConfig(top_k=5)):
        eng = make_engine(setup, sampling=cfg)
        assert eng._samp_salt == base._samp_salt == "greedy"
        assert run_outputs(eng, reqs()) == want


def test_sampled_runs_reproducible_across_batches_preemption_and_restart(
        setup):
    """Fixed (seed, rid, position) pin every sampled token: the same
    requests give the same streams submitted together, in waves, into a
    fresh engine, on the paged cache, and through a preemption's resume
    (a pressure window shrinks the pool from 4 rows to 1)."""
    eng = make_engine(setup, sampling=SAMPLED)
    together = run_outputs(eng, sampled_reqs())
    assert any(together[i] != together[j]
               for i in together for j in together if i != j)
    eng2 = make_engine(setup, sampling=SAMPLED)           # a restart
    waves = {}
    rs = sampled_reqs()
    waves.update(run_outputs(eng2, rs[:1]))               # other batch
    waves.update(run_outputs(eng2, rs[1:]))               # compositions
    assert waves == together
    paged = make_engine(setup, sampling=SAMPLED, cache="paged")
    assert run_outputs(paged, sampled_reqs()) == together
    faults = tserve.FaultInjector(pressure=((2, 5, 3),))
    pre = make_engine(setup, sampling=SAMPLED, faults=faults)
    assert run_outputs(pre, sampled_reqs()) == together
    assert pre.stats["preempted"] >= 1 and pre.stats["resumed"] >= 1


def test_engine_seed_default_and_request_override(setup):
    pr = prompts_for(1, seed=8)[0]

    def run_one(engine_seed, req_seed):
        eng = make_engine(setup, sampling=SAMPLED, seed=engine_seed)
        return run_outputs(eng, [tserve.Request(rid=0, prompt=pr.copy(),
                                                max_new_tokens=6,
                                                seed=req_seed)])[0]

    assert run_one(11, None) == run_one(0, 11) == run_one(11, 11)
    assert run_one(11, None) != run_one(12, None)
    # seeds past 2^31 are unsigned, as the JAX package reads them
    big = run_one(0, 0xFFFFFFF0)
    assert big == run_one(0xFFFFFFF0, None)


def test_seed_never_salts_a_key(setup, monkeypatch):
    """Engines that differ only in seed form the same plan keys and graph
    keys (graph keys recorded by a spy store: nothing is captured on the
    CPU); the policy does salt the graph keys."""
    def keys(seed, sampling):
        store = tstore.PlanStore()
        eng = make_engine(setup, store=store, sampling=sampling, seed=seed)
        run_outputs(eng, [tserve.Request(rid=0, prompt=prompts_for(1)[0],
                                         max_new_tokens=4, seed=seed)])
        plans = sorted(map(repr, store._plans.keys()))
        graphs = []
        with monkeypatch.context() as mp:
            mp.setattr(eng.store, "get_or_build",
                       lambda key, build: graphs.append(key[:1] + key[2:]))
            eng._graph(1)
            eng._group_graph("prefill", 1, 16)
            eng._group_graph("chunk", 1, 16)
        return plans, graphs
    a, b = keys(0, SAMPLED), keys(123, SAMPLED)
    assert a == b
    assert a[1][0] == ("decode", eng_tag(), "t0.8k20p1", 1)
    greedy = keys(0, None)
    assert greedy[0] == a[0]                 # plans: the policy is no plan
    assert greedy[1] != a[1] and greedy[1][2] == a[1][2]   # chunks unsalted


def eng_tag():
    from repro_torch.serve.kv_cache import DenseCache, cache_backend_salt
    return cache_backend_salt(DenseCache())


# -- the synchronous host loop -----------------------------------------------


def test_sync_host_loop_gives_the_async_tokens_and_the_jax_counters(setup):
    """``async_host=False`` harvests each step right after its dispatch:
    the default loop's tokens (greedy and sampled), and the JAX engine's
    synchronous loop's counters and dispatch order."""
    jm, jparams, _, _ = setup
    reqs = lambda mod: [mod.Request(rid=i, prompt=pr.copy(),  # noqa: E731
                                    max_new_tokens=6 + 2 * i)
                        for i, pr in enumerate(prompts_for(4, seed=3))]
    for sampling in (None, SAMPLED):
        want = run_outputs(make_engine(setup, sampling=sampling),
                           reqs(tserve))
        sync = make_engine(setup, sampling=sampling, async_host=False)
        assert run_outputs(sync, reqs(tserve)) == want
    ref = jserve.ServeEngine(jm, jparams, "sequential", jserve.ServeConfig(
        lowered=False, async_host=False, **CFG))
    run_outputs(ref, reqs(jserve))
    for k in ("prefill_steps", "decode_steps", "decode_tokens",
              "host_syncs", "finished", "row_moves", "peak_active"):
        assert sync.stats[k] == ref.stats[k], k
    assert sync.stats["tier_steps"] == ref.stats["tier_steps"]
    assert sync.dispatch_log == ref.dispatch_log
    default = make_engine(setup)
    run_outputs(default, reqs(tserve))
    assert sync.stats["decode_steps"] <= default.stats["decode_steps"]
