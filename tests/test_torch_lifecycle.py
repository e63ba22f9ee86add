"""The port's request lifecycle against the JAX package's.

Every case of ``tests/test_serve_faults.py`` has a counterpart here:
admission control, deadlines, preempt-and-requeue, fault isolation,
drain / shutdown / ``run(max_iters)`` stranding and the chaos soup.  The
contract is the reference's: every submitted request terminates in
exactly one of Finished / Shed / Failed with matching counters, no KV
row leaks, and a preempted request resumes with bitwise-identical
tokens.

Where a case serves tokens, the same scenario also runs through the JAX
engine (``ServeConfig(lowered=False)``) on the same parameters (smoke
chatglm3-6b, ``params_from_numpy`` of the reference's), and the port must
end every request the same way (result kind, reason, termination
order), with the same lifecycle counters and dispatch log, and the same
greedy tokens — or tokens that first differ where the reference's
top-1/top-2 margin is a near tie (``test_torch_serve.reference_margin``).
The warmup and stranding repairs are held here too.
"""
import jax
import numpy as np
import pytest

import repro.serve as jserve
from repro.configs import get_smoke_config as jget_smoke
from repro.core.strategies import get_strategy as jget_strategy
from repro.models.layers import MeshInfo as JMeshInfo
from repro.models.registry import build_model as jbuild_model
import repro_torch.serve as tserve
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.strategies import get_strategy
from repro_torch.models.layers import MeshInfo
from repro_torch.models.registry import build_model
from repro_torch.serve import (
    BoundedQueue,
    CacheRowError,
    ChunkingDisabled,
    EmptyPrompt,
    EngineDraining,
    Failed,
    Finished,
    KVCacheManager,
    Overloaded,
    PagePressure,
    PromptOverflow,
    RejectedRequest,
    Request,
    ServeConfig,
    ServeEngine,
    Shed,
    UnchunkablePrompt,
)
from repro_torch.serve.admission import (
    AdmissionContext,
    AdmitAll,
    DeadlineGate,
    PriorityFloor,
    admission_chain,
    resolve_admission,
)
from test_torch_serve import reference_margin

ARCH = "chatglm3-6b"
COUNTERS = ("submitted", "admitted", "finished", "shed", "failed",
            "preempted", "resumed", "deadline_missed", "alloc_denied",
            "stranded", "drains", "prefill_steps", "prefill_reqs",
            "chunk_steps", "decode_steps", "decode_tokens", "peak_active")


@pytest.fixture(scope="module")
def setup():
    jm = jbuild_model(jget_smoke(ARCH), JMeshInfo(tp=1, dp=1))
    segs, _ = jm.build_segments("prefill", 1, 32, s_max=64)
    jparams = jm._init_from_segments(segs, jax.random.PRNGKey(0))
    model = build_model(get_smoke_config(ARCH), MeshInfo(tp=1, dp=1))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    return jm, jparams, model, params


def _cfg(**kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("s_max", 64)
    kw.setdefault("prefill_buckets", (16, 32))
    return kw


def make_engine(model, params, **kw):
    return ServeEngine(model, params, get_strategy("sequential"),
                       ServeConfig(**_cfg(**kw)), device="cpu")


def make_reference(jm, jparams, **kw):
    return jserve.ServeEngine(jm, jparams, jget_strategy("sequential"),
                              jserve.ServeConfig(lowered=False, **_cfg(**kw)))


def both(setup, scenario, cfg=lambda mod: {}):
    """Run ``scenario(engine, serve_module)`` on the port and on the JAX
    engine, each configured by ``cfg(serve_module)`` (so a policy or an
    injector is each package's own); returns (port, reference)."""
    jm, jparams, model, params = setup
    eng = make_engine(model, params, **cfg(tserve))
    scenario(eng, tserve)
    ref = make_reference(jm, jparams, **cfg(jserve))
    scenario(ref, jserve)
    return eng, ref


def assert_parity(setup, eng, ref, monkeypatch):
    """Same terminations (order, kind, reason), counters and dispatch
    log; the same tokens up to a near tie of the reference's."""
    jm, jparams = setup[:2]
    assert [r.rid for r in eng.finished] == [r.rid for r in ref.finished]
    for got, want in zip(eng.finished, ref.finished):
        assert type(got.result).__name__ == type(want.result).__name__
        if isinstance(got.result, Shed):
            assert type(got.result.reason).__name__ \
                == type(want.result.reason).__name__
            assert str(got.result.reason) == str(want.result.reason)
        elif isinstance(got.result, Failed):
            assert got.result.reason == want.result.reason
        assert got.preemptions == want.preemptions
        a, b = got.output, list(want.output)
        assert len(a) == len(b), (got.rid, a, b)
        first = next((i for i in range(len(a)) if a[i] != b[i]), None)
        if first is not None:
            margin, bound, _ = reference_margin(
                jm, jparams, list(want.prompt) + b[:first], monkeypatch)
            assert margin < bound, (
                f"request {got.rid}: token {first} differs "
                f"({a[first]} vs {b[first]}); margin {margin:.4f} > "
                f"bound {bound:.4f}")
    st, rst = eng.stats, ref.stats
    assert {k: st[k] for k in COUNTERS} == {k: rst[k] for k in COUNTERS}
    assert eng.dispatch_log == ref.dispatch_log


def prompts_for(n, seed=0, lo=4, hi=14):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 100, int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def assert_lifecycle_clean(eng, submitted):
    """Every submitted request reached exactly one terminal state, the
    counters agree, and the KV pool leaked nothing."""
    st = eng.stats
    assert len(eng.finished) == submitted, (len(eng.finished), submitted)
    assert len({id(r) for r in eng.finished}) == submitted
    for r in eng.finished:
        assert isinstance(r.result, (Finished, Shed, Failed)), r
        assert r.done_s > 0, r
        assert r.row == -1, r
    kinds = {"finished": 0, "shed": 0, "failed": 0}
    for r in eng.finished:
        kinds[{Finished: "finished", Shed: "shed",
               Failed: "failed"}[type(r.result)]] += 1
    assert kinds["finished"] == st["finished"], (kinds, st)
    assert kinds["shed"] == st["shed"], (kinds, st)
    assert kinds["failed"] == st["failed"], (kinds, st)
    assert st["submitted"] == submitted
    assert st["finished"] + st["shed"] + st["failed"] == submitted
    assert len(eng.cache.free_rows) == eng.cfg.max_batch
    assert eng.cache.row_owner == {}
    assert not eng.active and not eng._chunking and not eng.waiting


# -- typed submit rejects ---------------------------------------------------

def test_rejected_request_hierarchy(setup):
    *_, model, params = setup
    eng = make_engine(model, params)
    with pytest.raises(EmptyPrompt):
        eng.submit(Request(rid=0, prompt=np.zeros(0, np.int32)))
    with pytest.raises(ValueError, match="s_max"):
        eng.submit(Request(rid=1, prompt=np.zeros(64, np.int32)))
    with pytest.raises(PromptOverflow):
        eng.submit(Request(rid=2, prompt=np.zeros(64, np.int32)))
    eng2 = make_engine(model, params, chunked_prefill=False)
    with pytest.raises(ValueError, match="largest prefill bucket"):
        eng2.submit(Request(rid=3, prompt=np.arange(40, dtype=np.int32)))
    with pytest.raises(ChunkingDisabled):
        eng2.submit(Request(rid=4, prompt=np.arange(40, dtype=np.int32)))
    # no chunk schedule fits: 60 tokens need (0,32),(32,32) past s_max 60
    eng3 = make_engine(model, params, s_max=62)
    with pytest.raises(UnchunkablePrompt):
        eng3.submit(Request(rid=5, prompt=np.arange(60, dtype=np.int32)))
    assert issubclass(Overloaded, RejectedRequest)
    assert issubclass(RejectedRequest, ValueError)
    assert not eng.waiting and not eng2.waiting and not eng3.waiting
    # the reference refuses the same prompts with the same classes
    jm, jparams = setup[:2]
    for kw, n in (({}, 0), ({}, 64), ({"chunked_prefill": False}, 40),
                  ({"s_max": 62}, 60)):
        with pytest.raises(RejectedRequest) as ours:
            make_engine(model, params, **kw).submit(
                Request(rid=9, prompt=np.arange(n, dtype=np.int32)))
        with pytest.raises(jserve.RejectedRequest) as theirs:
            make_reference(jm, jparams, **kw).submit(
                jserve.Request(rid=9, prompt=np.arange(n, dtype=np.int32)))
        assert type(ours.value).__name__ == type(theirs.value).__name__
        assert str(ours.value) == str(theirs.value)


# -- admission policies -----------------------------------------------------

def test_bounded_queue_sheds_typed_overloaded(setup, monkeypatch):
    n = 8
    decisions = {}

    def scenario(eng, mod):
        decisions[mod] = [
            eng.submit(mod.Request(rid=i, prompt=pr, max_new_tokens=3))
            for i, pr in enumerate(prompts_for(n, seed=1))]
        eng.run()

    eng, ref = both(setup, scenario, lambda mod: dict(
        admission=mod.BoundedQueue(3), prefill_batch=2))
    assert_lifecycle_clean(eng, n)
    shed = [d for d in decisions[tserve] if isinstance(d, Shed)]
    assert shed and all(isinstance(d.reason, Overloaded) for d in shed)
    st = eng.stats
    assert st["shed"] == len(shed) > 0
    assert st["finished"] == n - len(shed)
    for r in eng.finished:
        if isinstance(r.result, Shed):
            assert isinstance(r.result.reason, Overloaded)
            assert r.output == []
        else:
            assert len(r.output) == 3
    assert_parity(setup, eng, ref, monkeypatch)


def test_priority_floor_and_chain_identity():
    chain = admission_chain(DeadlineGate(), BoundedQueue(4),
                            PriorityFloor(2, when_queue_over=1))
    chain2 = admission_chain(DeadlineGate(), BoundedQueue(4),
                             PriorityFloor(2, when_queue_over=1))
    assert chain.identity() == chain2.identity()
    assert chain.identity() != admission_chain(BoundedQueue(5)).identity()
    ctx = AdmissionContext(queue_depth=2, active=0, chunking=0,
                           free_rows=0, max_batch=4, prompt_len=8,
                           priority=0, waited_s=0.0,
                           deadline_left_s=None, ttft_left_s=None)
    assert isinstance(chain(ctx), Shed)          # below the priority floor
    assert AdmitAll()(ctx).ok
    assert isinstance(resolve_admission(None), AdmitAll)
    # PagePressure bites on the row-granular signals a dense cache gives,
    # and declines where none is reported, as the reference's does
    jctx = jserve.admission.AdmissionContext(
        queue_depth=2, active=0, chunking=0, free_rows=0, max_batch=4,
        prompt_len=8, priority=0, waited_s=0.0, deadline_left_s=None,
        ttft_left_s=None)
    for pol, jpol in ((chain, jserve.admission.admission_chain(
            jserve.admission.DeadlineGate(), jserve.BoundedQueue(4),
            jserve.PriorityFloor(2, when_queue_over=1))),
            (PagePressure(0.5), jserve.PagePressure(0.5))):
        for c, jc in ((ctx, jctx), (
                AdmissionContext(**{**vars(ctx), "free_tokens": 64,
                                    "capacity_tokens": 256}),
                jserve.admission.AdmissionContext(
                    **{**vars(jctx), "free_tokens": 64,
                       "capacity_tokens": 256}))):
            ours, theirs = pol(c), jpol(jc)
            assert type(ours).__name__ == type(theirs).__name__
            assert str(ours) == str(theirs)
    assert PagePressure().identity() == jserve.PagePressure().identity()


def test_deadline_expired_in_queue_sheds(setup, monkeypatch):
    def scenario(eng, mod):
        eng.submit(mod.Request(rid=0, prompt=prompts_for(1, seed=2)[0],
                               max_new_tokens=8))
        eng.submit(mod.Request(rid=1, prompt=prompts_for(1, seed=3)[0],
                               max_new_tokens=2, deadline_s=0.0))
        eng.run()

    eng, ref = both(setup, scenario,
                    lambda mod: dict(max_batch=1, prefill_batch=1))
    assert_lifecycle_clean(eng, 2)
    live, dead = sorted(eng.finished, key=lambda r: r.rid)
    assert isinstance(live.result, Finished)
    assert isinstance(dead.result, Shed)
    assert eng.stats["deadline_missed"] == 1
    assert_parity(setup, eng, ref, monkeypatch)


# -- chaos: allocation failures -----------------------------------------------

def test_injected_alloc_failures_delay_but_never_lose(setup, monkeypatch):
    n = 5

    def scenario(eng, mod):
        for i, pr in enumerate(prompts_for(n, seed=4)):
            eng.submit(mod.Request(rid=i, prompt=pr, max_new_tokens=4))
        eng.run()

    eng, ref = both(setup, scenario, lambda mod: dict(
        faults=mod.FaultInjector(alloc_fail=(0, 1, 3))))
    assert_lifecycle_clean(eng, n)
    assert all(isinstance(r.result, Finished) for r in eng.finished)
    assert eng.stats["alloc_denied"] == 3
    assert eng.faults.counts.get("alloc_fail") == 3
    # denial only delays: the tokens equal a fault-free engine's exactly
    *_, model, params = setup
    clean = make_engine(model, params)
    scenario(clean, tserve)
    assert {r.rid: r.output for r in eng.finished} \
        == {r.rid: r.output for r in clean.finished}
    assert_parity(setup, eng, ref, monkeypatch)


# -- chaos: dispatch faults and isolation -----------------------------------

def test_poisoned_prefill_isolated_to_one_request(setup, monkeypatch):
    n = 4

    def scenario(eng, mod):
        for i, pr in enumerate(prompts_for(n, seed=5)):
            eng.submit(mod.Request(rid=i, prompt=pr, max_new_tokens=3))
        eng.run()

    eng, ref = both(setup, scenario, lambda mod: dict(
        faults=mod.FaultInjector(poison={1: "prefill"}), prefill_batch=4))
    assert_lifecycle_clean(eng, n)
    done = {r.rid: r for r in eng.finished}
    assert isinstance(done[1].result, Failed)
    assert "poisoned" in done[1].result.reason
    *_, model, params = setup
    clean = make_engine(model, params)
    for i, pr in enumerate(prompts_for(n, seed=5)):
        if i != 1:
            clean.submit(Request(rid=i, prompt=pr, max_new_tokens=3))
    for r in clean.run():
        assert done[r.rid].output == r.output, r.rid
    assert_parity(setup, eng, ref, monkeypatch)


@pytest.mark.parametrize("site", ["decode", "harvest"])
def test_poisoned_decode_and_harvest_isolated(setup, site, monkeypatch):
    n = 4

    def scenario(eng, mod):
        for i, pr in enumerate(prompts_for(n, seed=6)):
            eng.submit(mod.Request(rid=i, prompt=pr, max_new_tokens=4))
        eng.run()

    eng, ref = both(setup, scenario, lambda mod: dict(
        faults=mod.FaultInjector(poison={2: site})))
    assert_lifecycle_clean(eng, n)
    done = {r.rid: r for r in eng.finished}
    assert isinstance(done[2].result, Failed)
    survivors = [r for rid, r in done.items() if rid != 2]
    assert all(isinstance(r.result, Finished) for r in survivors)
    assert all(len(r.output) == 4 for r in survivors)
    assert_parity(setup, eng, ref, monkeypatch)


def test_generic_dispatch_fault_fails_only_that_dispatch(setup, monkeypatch):
    def scenario(eng, mod):
        for i, pr in enumerate(prompts_for(2, seed=7)):
            eng.submit(mod.Request(rid=i, prompt=pr, max_new_tokens=3))
        eng.run()
        assert all(isinstance(r.result, mod.Failed) for r in eng.finished)
        for i, pr in enumerate(prompts_for(2, seed=8), start=2):
            eng.submit(mod.Request(rid=i, prompt=pr, max_new_tokens=3))
        eng.run()

    eng, ref = both(setup, scenario, lambda mod: dict(
        faults=mod.FaultInjector(dispatch_fail=(("prefill", 0),)),
        prefill_batch=2))
    assert_lifecycle_clean(eng, 4)
    done = {r.rid: r for r in eng.finished}
    assert isinstance(done[2].result, Finished)
    assert isinstance(done[3].result, Finished)
    assert_parity(setup, eng, ref, monkeypatch)


def test_real_dispatch_error_is_not_a_quiet_failure(setup):
    """Only the injector's faults are caught: an error of the step itself
    (here, the forward raising) leaves the engine, not as ``Failed``."""
    *_, model, params = setup
    eng = make_engine(model, params)
    eng.submit(Request(rid=0, prompt=prompts_for(1, seed=7)[0],
                       max_new_tokens=3))

    def boom(*a, **k):
        raise RuntimeError("device fault")
    eng._prefill_run = boom
    with pytest.raises(RuntimeError, match="device fault"):
        eng.run()
    assert eng.stats["failed"] == 0


def test_poisoned_chunked_prefill_releases_row(setup, monkeypatch):
    def scenario(eng, mod):
        long_pr = (np.arange(40, dtype=np.int32) * 7 + 3) % 100
        eng.submit(mod.Request(rid=0, prompt=long_pr, max_new_tokens=3))
        eng.submit(mod.Request(rid=1, prompt=prompts_for(1, seed=9)[0],
                               max_new_tokens=3))
        eng.run()

    eng, ref = both(setup, scenario, lambda mod: dict(
        faults=mod.FaultInjector(poison={0: "chunk"})))
    assert_lifecycle_clean(eng, 2)
    done = {r.rid: r for r in eng.finished}
    assert isinstance(done[0].result, Failed)
    assert isinstance(done[1].result, Finished)
    assert_parity(setup, eng, ref, monkeypatch)


# -- preempt-and-requeue ----------------------------------------------------

def _solo(setup, prompt, new_tokens):
    *_, model, params = setup
    solo = make_engine(model, params, max_batch=1)
    solo.submit(Request(rid=0, prompt=prompt.copy(),
                        max_new_tokens=new_tokens))
    return solo.run()[0].output


def test_priority_preemption_resumes_bitwise_identical(setup, monkeypatch):
    pr_low = prompts_for(1, seed=10)[0]
    pr_high = prompts_for(1, seed=11)[0]
    want = _solo(setup, pr_low, 10)

    def scenario(eng, mod):
        eng.submit(mod.Request(rid=0, prompt=pr_low.copy(),
                               max_new_tokens=10, priority=0))
        for _ in range(4):                  # let the victim produce tokens
            eng.step()
        eng.submit(mod.Request(rid=1, prompt=pr_high.copy(),
                               max_new_tokens=3, priority=5))
        eng.run()

    eng, ref = both(setup, scenario, lambda mod: dict(max_batch=1))
    assert_lifecycle_clean(eng, 2)
    done = {r.rid: r for r in eng.finished}
    assert done[0].preemptions >= 1
    assert eng.stats["preempted"] >= 1 and eng.stats["resumed"] >= 1
    assert isinstance(done[0].result, Finished)
    assert isinstance(done[1].result, Finished)
    assert done[0].output == want, "preempted run diverged"
    assert done[1].first_token_s < done[0].done_s
    assert_parity(setup, eng, ref, monkeypatch)


def test_preempted_long_resume_goes_chunked(setup, monkeypatch):
    pr_low = prompts_for(1, seed=12, lo=28, hi=31)[0]    # near the bucket
    want = _solo(setup, pr_low, 12)

    def scenario(eng, mod):
        eng.submit(mod.Request(rid=0, prompt=pr_low.copy(),
                               max_new_tokens=12))
        for _ in range(8):                  # > bucket - len(prompt) tokens
            eng.step()
        eng.submit(mod.Request(rid=1, prompt=prompts_for(1, seed=13)[0],
                               max_new_tokens=2, priority=9))
        eng.run()

    eng, ref = both(setup, scenario, lambda mod: dict(max_batch=1))
    assert_lifecycle_clean(eng, 2)
    low = next(r for r in eng.finished if r.rid == 0)
    assert low.preemptions >= 1
    assert len(low.prompt) + 12 > eng.cfg.prefill_buckets[-1]
    assert low.output == want
    assert eng.stats["chunk_steps"] > 0    # the resume chunked
    assert_parity(setup, eng, ref, monkeypatch)


def test_pressure_window_preempts_and_recovers(setup, monkeypatch):
    n = 4

    def scenario(eng, mod):
        for i, pr in enumerate(prompts_for(n, seed=14)):
            eng.submit(mod.Request(rid=i, prompt=pr, max_new_tokens=6))
        eng.run()

    *_, model, params = setup
    clean = make_engine(model, params)
    scenario(clean, tserve)
    want = {r.rid: r.output for r in clean.finished}
    eng, ref = both(setup, scenario, lambda mod: dict(
        faults=mod.FaultInjector(pressure=((2, 5, 3),))))   # capacity 4->1
    assert_lifecycle_clean(eng, n)
    assert eng.stats["preempted"] >= 1
    assert all(isinstance(r.result, Finished) for r in eng.finished)
    assert {r.rid: r.output for r in eng.finished} == want
    assert_parity(setup, eng, ref, monkeypatch)


# -- stranded work: run(max_iters), drain, shutdown -------------------------

def test_run_max_iters_surfaces_stranded_rows(setup, tmp_path, monkeypatch):
    """The repaired fault: ``run(max_iters)`` strands the survivors as
    ``Failed`` naming ``max_iters``, releases their rows, counts them
    and still checkpoints the path-bound store."""
    path = tmp_path / "strand.dfps"

    def scenario(eng, mod):
        for i, pr in enumerate(prompts_for(3, seed=15)):
            eng.submit(mod.Request(rid=i, prompt=pr, max_new_tokens=50))
        eng.run(max_iters=2)

    eng, ref = both(setup, scenario, lambda mod: dict(
        plan_store_path=str(path) if mod is tserve else None))
    assert_lifecycle_clean(eng, 3)
    st = eng.stats
    assert st["stranded"] + st["shed"] == 3
    assert st["stranded"] > 0
    assert any(isinstance(r.result, Failed)
               and "max_iters" in r.result.reason for r in eng.finished)
    assert path.exists() and not eng.store.dirty       # checkpointed
    assert_parity(setup, eng, ref, monkeypatch)


def test_drain_finishes_inflight_sheds_queue(setup, monkeypatch):
    reports = {}

    def scenario(eng, mod):
        for i, pr in enumerate(prompts_for(4, seed=16)):
            eng.submit(mod.Request(rid=i, prompt=pr, max_new_tokens=4))
        eng.step()                          # two admitted, two queued
        reports[mod] = eng.drain()

    eng, ref = both(setup, scenario,
                    lambda mod: dict(max_batch=2, prefill_batch=2))
    assert_lifecycle_clean(eng, 4)
    report = reports[tserve]
    assert report["stranded"] == [] and report["free_rows"] == 2
    assert eng.stats["finished"] == 2 and eng.stats["shed"] == 2
    assert {k: v for k, v in report.items() if k != "checkpointed"} == \
        {k: v for k, v in reports[jserve].items() if k != "checkpointed"}
    assert_parity(setup, eng, ref, monkeypatch)
    with pytest.raises(EngineDraining):
        eng._draining = True
        eng.submit(Request(rid=9, prompt=prompts_for(1, seed=17)[0]))
    eng._draining = False
    eng.submit(Request(rid=10, prompt=prompts_for(1, seed=17)[0],
                       max_new_tokens=2))
    eng.run()
    assert eng.stats["finished"] == 3


def test_drain_timeout_reports_and_releases_stranded(setup, monkeypatch):
    reports = {}

    def scenario(eng, mod):
        eng.submit(mod.Request(rid=0, prompt=prompts_for(1, seed=18)[0],
                               max_new_tokens=500))   # cannot finish
        eng.step()
        reports[mod] = eng.drain(timeout=0.0)

    eng, ref = both(setup, scenario)
    assert reports[tserve]["stranded"] == reports[jserve]["stranded"] == [0]
    assert_lifecycle_clean(eng, 1)
    assert eng.stats["stranded"] == 1
    assert_parity(setup, eng, ref, monkeypatch)


def test_shutdown_mid_chunked_prefill_releases_and_checkpoints(
        setup, tmp_path):
    *_, model, params = setup
    path = str(tmp_path / "chaos.dfps")
    eng = make_engine(model, params, plan_store_path=path)
    long_pr = (np.arange(40, dtype=np.int32) * 5 + 1) % 100
    eng.submit(Request(rid=0, prompt=long_pr, max_new_tokens=3))
    eng._admit()                        # stages and dispatches one chunk
    assert eng._chunking, "precondition: a chunked prefill is in flight"
    wrote = eng.shutdown()
    assert wrote >= 1                   # the chunk lowering checkpointed
    assert (tmp_path / "chaos.dfps").exists()
    assert_lifecycle_clean(eng, 1)
    assert isinstance(eng.finished[0].result, Failed)
    assert eng.finished[0].result.reason == "engine shutdown"
    assert eng.shutdown() == 0          # clean store: no rewrite


# -- cache row bookkeeping ----------------------------------------------------

def test_release_and_move_row_typed_errors(setup):
    *_, model, params = setup
    cache = KVCacheManager(model, 4, 64, device="cpu")
    row = cache.allocate(7)
    cache.release(row)
    with pytest.raises(CacheRowError, match="double release|not allocated"):
        cache.release(row)
    with pytest.raises(CacheRowError):
        cache.release(99)
    r0 = cache.allocate(1)
    with pytest.raises(CacheRowError, match="src == dst"):
        cache.move_row(r0, r0)
    with pytest.raises(CacheRowError, match="not an active row"):
        cache.move_row(3, 2)
    cache.allocate(2)                   # row 1 now owned -> not free
    with pytest.raises(CacheRowError, match="not free"):
        cache.move_row(r0, 1)
    assert cache.kv_stats() == {"backend": "dense",
                                "capacity_tokens": 256, "free_tokens": 128,
                                "resident_tokens": 0}


# -- the full chaos soup ------------------------------------------------------

def test_chaos_soup_every_request_terminates_exactly_once(setup,
                                                          monkeypatch):
    n = 10

    def scenario(eng, mod):
        rng = np.random.default_rng(19)
        for i in range(n):
            if i == 4:
                pr = (np.arange(44, dtype=np.int32) * 3 + 1) % 100
            else:
                pr = rng.integers(0, 100, int(rng.integers(4, 14))) \
                    .astype(np.int32)
            eng.submit(mod.Request(rid=i, prompt=pr,
                                   max_new_tokens=int(rng.integers(2, 7)),
                                   priority=int(rng.integers(0, 3)),
                                   deadline_s=None if i % 4 else 30.0))
        eng.run()

    eng, ref = both(setup, scenario, lambda mod: dict(
        admission=mod.BoundedQueue(6), prefill_batch=2,
        faults=mod.FaultInjector(alloc_fail=(2,), poison={5: "decode"},
                                 dispatch_fail=(("chunk", 1),),
                                 slow_iters=(3,), slow_s=0.01,
                                 pressure=((6, 8, 2),))))
    assert_lifecycle_clean(eng, n)
    st = eng.stats
    assert st["failed"] >= 1
    assert st["alloc_denied"] >= 1
    assert eng.faults.counts.get("slow") == 1
    assert st["faults"] == ref.stats["faults"]
    assert_parity(setup, eng, ref, monkeypatch)
    for i, pr in enumerate(prompts_for(3, seed=20), start=n):
        eng.submit(Request(rid=i, prompt=pr, max_new_tokens=3))
    eng.run()
    assert_lifecycle_clean(eng, n + 3)


# -- the warmup repair --------------------------------------------------------

@pytest.mark.parametrize("tiers", [(), None])
def test_warmup_empty_tiers_warms_every_tier(setup, tiers):
    """``warmup(())`` warms every tier, as ``tiers or self.tiers`` does in
    the reference; ``warmup(chunks=...)`` builds a chunk step ahead."""
    jm, jparams, model, params = setup
    eng = make_engine(model, params, lowered=True)
    eng.warmup(tiers, chunks=((1, 32),))
    ref = make_reference(jm, jparams)
    ref.warmup(tiers)
    assert sorted(eng.stats["tier_builds"]) == list(eng.tiers) \
        == sorted(ref.stats["tier_builds"]) == [1, 2, 4]
    assert ("chunk", 1, 32, True, False) in eng._steps
    with pytest.raises(ValueError, match="no chunk group"):
        eng.warmup((1,), chunks=((3, 32),))


def test_program_serve_passes_the_lifecycle_through(setup):
    """``Program.serve`` takes the lifecycle fields as overrides, and
    ``Program.close`` strands an engine's in-flight work."""
    from repro_torch.api import Program
    *_, model, params = setup
    prog = Program(model, get_strategy("sequential"), device="cpu")
    faults = tserve.FaultInjector(alloc_fail=(0,))
    eng = prog.serve(params, ServeConfig(**_cfg()),
                     admission=BoundedQueue(1), faults=faults,
                     chunked_prefill=False)
    assert eng.faults is faults and not eng.cfg.chunked_prefill
    assert eng.admission.identity() == admission_chain(
        DeadlineGate(), BoundedQueue(1)).identity()
    pr = prompts_for(2, seed=21)
    eng.submit(Request(rid=0, prompt=pr[0], max_new_tokens=30))
    assert isinstance(eng.submit(Request(rid=1, prompt=pr[1])), Shed)
    eng.step()                          # allocation 0 denied
    eng.step()
    assert eng.stats["alloc_denied"] == 1 and eng.active
    prog.close()
    assert_lifecycle_clean(eng, 2)
    assert eng.finished[-1].result.reason == "engine shutdown"
