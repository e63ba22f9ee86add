"""The port's paged KV cache (src/repro_torch/serve/kv_cache.py, the
paged branches of serve/engine.py) against the JAX package's.

Each case of the JAX package's ``tests/test_paged_kv.py`` has a
counterpart here that runs the same scenario on both packages where the
scenario is deterministic (backend resolution and identities, page-size
validation, the unpageable refusal, page bookkeeping under fuzzed
operations, page-capacity admission, page pressure, plan keys salted by
the backend), and requires the same observations.  Served tokens: on
smoke chatglm3-6b and deepseek-moe-16b, the port's paged engine gives
its own dense engine's greedy tokens bitwise (a trace with batched,
padded and chunked prefill, decode tiers and compaction), and the JAX
engine's (``ServeConfig(lowered=False, cache="paged")``, the same
converted params) wherever the reference's choice is not a near tie
(``test_torch_serve.reference_margin``).  The device helpers —
gather, frontier, span and row-page scatters — are held to the JAX
package's on the same numpy pools and page tables, exactly.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.serve as jserve
import repro.serve.kv_cache as jkv
import repro_torch.core.plan_store as tstore
import repro_torch.serve as tserve
import repro_torch.serve.kv_cache as tkv
from repro.configs import get_smoke_config as jget_smoke
from repro.models.layers import MeshInfo as JMeshInfo
from repro.models.registry import build_model as jbuild_model
from repro_torch.api import Program
from repro_torch.api import compile as tcompile
from repro_torch.convert import params_from_numpy
from repro_torch.serve.admission import AdmissionContext
from test_torch_serve import reference_margin

CFG = dict(max_batch=4, s_max=64, prefill_buckets=(16, 32))
ARCHS = ["chatglm3-6b", "deepseek-moe-16b"]


class Pair:
    """One smoke arch on both packages: the JAX model and params, the
    port's program and the same params converted."""

    def __init__(self, arch):
        self.arch = arch
        self.jm = jbuild_model(jget_smoke(arch), JMeshInfo())
        self.jparams = self.jm.init_params(jax.random.PRNGKey(0),
                                           phase="prefill")
        self.prog = tcompile(arch, smoke=True, device="cpu",
                             policy="sequential")
        self.tparams = params_from_numpy(
            jax.tree_util.tree_map(np.asarray, self.jparams), device="cpu")

    def engines(self, **kw):
        """(JAX engine at ``lowered=False``, the port's engine); a callable
        value is called with the package's ``serve`` module (a backend or
        an admission policy of each package's own)."""
        def cfg(mod):
            return {**CFG, **{k: v(mod) if callable(v) else v
                              for k, v in kw.items()}}
        return (jserve.ServeEngine(self.jm, self.jparams, "sequential",
                                   jserve.ServeConfig(lowered=False,
                                                      **cfg(jserve))),
                self.prog.serve(self.tparams,
                                tserve.ServeConfig(**cfg(tserve))))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return Pair(request.param)


@pytest.fixture(scope="module")
def glm():
    return Pair("chatglm3-6b")


def _trace(mod, vocab, seed, n_reqs, max_new=8, chunk_last=True):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_reqs):
        n = 40 if (chunk_last and i == n_reqs - 1) \
            else int(rng.integers(4, 30))
        out.append(mod.Request(rid=i, prompt=rng.integers(
            0, vocab, n, dtype=np.int32), max_new_tokens=max_new))
    return out


def _serve(eng, mod, vocab, seed=0, n_reqs=6, **kw):
    for r in _trace(mod, vocab, seed, n_reqs, **kw):
        eng.submit(r)
    done = eng.run()
    return {r.rid: r for r in done}


def _assert_near_tie(p, got, want, monkeypatch):
    """The port's tokens equal the reference's, or first differ where the
    reference's choice is a near tie."""
    for rid, w in want.items():
        a, b = got[rid].output, list(w.output)
        assert len(a) == len(b), rid
        first = next((i for i in range(len(a)) if a[i] != b[i]), None)
        if first is None:
            continue
        context = list(w.prompt) + b[:first]
        margin, bound, route_tie = reference_margin(p.jm, p.jparams, context,
                                                    monkeypatch)
        assert margin < bound or route_tie, (rid, a, b, margin, bound)


# -- backend resolution ------------------------------------------------------


def test_backend_resolution():
    for mod in (jkv, tkv):
        assert isinstance(mod.resolve_cache_backend(None), mod.DenseCache)
        assert isinstance(mod.resolve_cache_backend("dense"), mod.DenseCache)
        assert isinstance(mod.resolve_cache_backend("paged"), mod.PagedCache)
        custom = mod.PagedCache(page_size=8, num_pages=7)
        assert mod.resolve_cache_backend(custom) is custom
        with pytest.raises(ValueError, match="unknown cache backend"):
            mod.resolve_cache_backend("ring")
        with pytest.raises(TypeError):
            mod.resolve_cache_backend(3)


@pytest.mark.parametrize("make", [
    lambda m: m.DenseCache(), lambda m: m.PagedCache(),
    lambda m: m.PagedCache(page_size=8),
    lambda m: m.PagedCache(page_size=16, num_pages=5)],
    ids=["dense", "paged", "paged-8", "paged-16-5"])
def test_backend_identity_round_trip(make):
    b, jb = make(tkv), make(jkv)
    again = tkv.backend_from_identity(b.identity())
    assert again == b and b.identity() == jb.identity()
    # the salt is the reference's, character for character
    assert tkv.cache_backend_salt(again) == tkv.cache_backend_salt(b) \
        == jkv.cache_backend_salt(jb)
    salts = {tkv.cache_backend_salt(x) for x in
             (tkv.DenseCache(), tkv.PagedCache(), tkv.PagedCache(page_size=8))}
    assert len(salts) == 3, "backend salts must be distinct"
    with pytest.raises(ValueError, match="unknown cache backend identity"):
        tkv.backend_from_identity(("bogus",))


@pytest.mark.parametrize("backend,buckets,match", [
    (dict(page_size=24), (16, 32), "divide s_max"),
    (dict(page_size=16), (24,), "prefill bucket"),
    (dict(page_size=0), (16, 32), "page_size")])
def test_page_size_validation(glm, backend, buckets, match):
    cfg = dict(max_batch=4, s_max=64, prefill_buckets=buckets)
    with pytest.raises(ValueError, match=match):
        jkv.PagedCache(**backend).build(glm.jm, jserve.ServeConfig(**cfg))
    with pytest.raises(ValueError, match=match):
        tkv.PagedCache(**backend).build(glm.prog.model,
                                        tserve.ServeConfig(**cfg), "cpu")


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_unpageable_arch_rejected(arch):
    jm = jbuild_model(jget_smoke(arch), JMeshInfo())
    prog = tcompile(arch, smoke=True, device="cpu")
    cfg = dict(max_batch=2, s_max=64, prefill_buckets=(16, 32))
    with pytest.raises(jkv.UnpageableCache, match="DenseCache"):
        jkv.PagedCache(page_size=16).build(jm, jserve.ServeConfig(**cfg))
    with pytest.raises(tkv.UnpageableCache, match="DenseCache"):
        tkv.PagedCache(page_size=16).build(
            prog.model, tserve.ServeConfig(**cfg), "cpu")
    # from the engine's constructor, as the reference raises it
    with pytest.raises(tkv.UnpageableCache):
        prog.serve(prog.init_params(0), tserve.ServeConfig(cache="paged",
                                                           **cfg))
    assert tkv.PagedCache(page_size=16).build(
        tcompile("chatglm3-6b", smoke=True, device="cpu").model,
        tserve.ServeConfig(**cfg), "cpu").paged


# -- page bookkeeping (property fuzz) ----------------------------------------


def _check_invariants(mgr):
    mapped = [int(p) for p in mgr.page_table.ravel() if p]
    assert len(mapped) == len(set(mapped)), "a page is aliased by 2 rows"
    assert 0 not in mapped, "trash page 0 leaked into a page table"
    assert len(mgr.free_pages) + len(mapped) == mgr.num_pages, \
        "pages leaked or double-freed"
    for row in range(mgr.max_batch):
        used = int(mgr.blocks_used[row])
        assert all(mgr.page_table[row, :used] > 0), "hole in mapped run"
        assert not mgr.page_table[row, used:].any(), \
            "mapped block beyond blocks_used"
        if row in mgr.row_owner:
            assert used >= mgr.pages_needed(int(mgr.lengths[row]))
        else:
            assert used == 0
    assert set(mgr.free_rows) | set(mgr.row_owner) == set(
        range(mgr.max_batch))
    assert not set(mgr.free_rows) & set(mgr.row_owner)


def _book(mgr):
    return (mgr.page_table.tolist(), sorted(mgr.free_pages),
            mgr.blocks_used.tolist(), mgr.lengths.tolist(),
            list(mgr.free_rows), dict(mgr.row_owner), mgr.peak_pages_used)


@given(seed=st.integers(min_value=0, max_value=10_000))
@settings(max_examples=15, deadline=None)
def test_page_bookkeeping_fuzz(glm, seed):
    """Random allocate / reserve / rollback / release / move_row
    interleavings on both packages' managers: the same page tables, free
    pages and rows after every operation, and never an aliased, leaked or
    trash page."""
    scfg = dict(max_batch=4, s_max=64, prefill_buckets=(16, 32))
    backend = dict(page_size=16, num_pages=10)
    mgrs = (jkv.PagedCache(**backend).build(glm.jm,
                                            jserve.ServeConfig(**scfg)),
            tkv.PagedCache(**backend).build(glm.prog.model,
                                            tserve.ServeConfig(**scfg),
                                            "cpu"))
    rng = np.random.default_rng(seed)
    for step in range(120):
        op = int(rng.integers(5))
        mgr = mgrs[1]
        active = sorted(mgr.row_owner)
        pick = int(rng.integers(1 << 30))
        new_len = int(rng.integers(1, mgr.s_max + 8))
        seen = []
        for m in mgrs:
            if op == 0 and m.free_rows:
                seen.append(m.allocate(step))
            elif op == 1 and active:
                row = active[pick % len(active)]
                before = len(m.free_pages)
                ok = m.reserve(row, new_len)
                if ok:
                    m.lengths[row] = max(int(m.lengths[row]), new_len)
                else:   # a denial must not leak a partial allocation
                    assert len(m.free_pages) == before
                seen.append(ok)
            elif op == 2 and active:
                row = active[pick % len(active)]
                keep = min(int(m.lengths[row]), new_len)
                m.lengths[row] = keep
                seen.append(m.rollback(row, keep))
            elif op == 3 and active:
                m.release(active[pick % len(active)])
            elif op == 4 and active and m.free_rows:
                src = active[pick % len(active)]
                dst = m.free_rows[pick % len(m.free_rows)]
                pages = sorted(int(p) for p in m.page_table[src] if p)
                m.move_row(src, dst)
                # a handoff: the same physical pages, now under dst
                assert sorted(int(p) for p in m.page_table[dst]
                              if p) == pages
            _check_invariants(m)
        assert len(set(map(repr, seen))) <= 1, seen
        assert _book(mgrs[0]) == _book(mgrs[1])
        assert mgrs[0].kv_stats() == mgrs[1].kv_stats()
    for m in mgrs:
        for row in sorted(m.row_owner):
            m.release(row)
        assert len(m.free_pages) == m.num_pages
        assert not m.page_table.any()


def test_rollback_and_reserve_past_s_max(glm):
    mgr = tkv.PagedCache(page_size=16, num_pages=8).build(
        glm.prog.model, tserve.ServeConfig(**CFG), "cpu")
    row = mgr.allocate(7)
    assert mgr.reserve(row, 40) and mgr.pages_used() == 3
    assert mgr.rollback(row, 17) == 1 and mgr.pages_used() == 2
    assert mgr.rollback(row, 30) == 0
    assert not mgr.reserve(row, 65)              # past s_max: refused
    assert mgr.pages_used() == 2 and mgr.peak_pages_used == 3
    with pytest.raises(tkv.CacheRowError):
        mgr.rollback(row + 1, 0)
    with pytest.raises(tkv.CacheRowError):
        mgr.reserve(row + 1, 1)


# -- the device helpers against the reference's ------------------------------


def _pools(glm, num_pages, seed):
    """The same random pool on both packages, and both managers."""
    scfg = dict(max_batch=4, s_max=64, prefill_buckets=(16, 32))
    backend = dict(page_size=16, num_pages=num_pages)
    jm = jkv.PagedCache(**backend).build(glm.jm, jserve.ServeConfig(**scfg))
    tm = tkv.PagedCache(**backend).build(glm.prog.model,
                                         tserve.ServeConfig(**scfg), "cpu")
    rng = np.random.default_rng(seed)
    np_pools = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
                for k, v in tm.caches.items()}
    tm.caches = {k: torch.from_numpy(v).to(tm.caches[k].dtype)
                 for k, v in np_pools.items()}
    jm.caches = {k: jnp.asarray(tm.caches[k].float().numpy(),
                                jm.caches[k].dtype) for k in np_pools}
    for m in (jm, tm):
        for rid, n in enumerate((40, 17, 64)):
            row = m.allocate(rid)
            assert m.reserve(row, n)
            m.lengths[row] = n - 1
    return jm, tm, rng


def _same(jtree, ttree):
    assert jtree.keys() == ttree.keys()
    for k in jtree:
        want = np.asarray(jnp.asarray(jtree[k], jnp.float32))
        np.testing.assert_array_equal(ttree[k].float().numpy(), want, k)


def _views(mgr, rng, tier):
    """Random ``(tier, s_max, ...)`` views (stacked ``(L, tier, ...)``)."""
    out = {}
    for k, pool in mgr.caches.items():
        bd = mgr.batch_dims[k]
        shape = pool.shape[:bd] + (tier, mgr.s_max) + pool.shape[bd + 2:]
        out[k] = rng.standard_normal(tuple(shape)).astype(np.float32)
    return out


@pytest.mark.parametrize("tier", [2, 4])
def test_gather_and_frontier_scatter_equal_the_reference(glm, tier):
    jm, tm, rng = _pools(glm, 12, seed=tier)
    jpt = jnp.asarray(jm.page_table)
    tpt = torch.from_numpy(tm.page_table.copy())
    _same(jm.gather_rows(jm.caches, jpt, tier),
          tm.gather_rows(tm.caches, tpt, tier))
    rows = torch.from_numpy(np.array([2, 0], np.int32))
    _same(jm.gather_row_batch(jm.caches, jpt[jnp.asarray(rows.numpy())]),
          tm.gather_row_batch(tm.caches, tpt[rows.long()]))
    views = _views(tm, rng, tier)
    clen = np.array([39, 16, 63, 5][:tier], np.int32)
    jout = jm.scatter_frontier(jm.caches, {k: jnp.asarray(v, jnp.bfloat16)
                                           for k, v in views.items()},
                               jpt, jnp.asarray(clen), tier)
    tm.scatter_frontier(tm.caches, {k: torch.from_numpy(v).bfloat16()
                                    for k, v in views.items()},
                        tpt, torch.from_numpy(clen), tier)
    # the trash page takes the unmapped frontiers in no defined order
    _same({k: v[..., 1:, :, :, :] if tm.batch_dims[k] else v[1:]
           for k, v in jout.items()},
          {k: v[:, 1:] if tm.batch_dims[k] else v[1:]
           for k, v in tm.caches.items()})


@pytest.mark.parametrize("width", [1, 5, 17])
def test_span_scatter_equals_the_reference(glm, width):
    jm, tm, rng = _pools(glm, 12, seed=width)
    tier = 4
    views = _views(tm, rng, tier)
    clen = np.array([30, 16, 60, 0], np.int32)
    jout = jm.scatter_span(jm.caches, {k: jnp.asarray(v, jnp.bfloat16)
                                       for k, v in views.items()},
                           jnp.asarray(jm.page_table), jnp.asarray(clen),
                           tier, width)
    tm.scatter_span(tm.caches, {k: torch.from_numpy(v).bfloat16()
                                for k, v in views.items()},
                    torch.from_numpy(tm.page_table.copy()),
                    torch.from_numpy(clen), tier, width)
    _same({k: v[:, 1:] if tm.batch_dims[k] else v[1:]
           for k, v in jout.items()},
          {k: v[:, 1:] if tm.batch_dims[k] else v[1:]
           for k, v in tm.caches.items()})


def test_row_page_scatter_equals_the_reference(glm):
    """A prefill slot's bucket (blocks 0.. of a shorter view, past its
    pages into the trash page) and a chunk's blocks from an offset given
    as a device tensor."""
    jm, tm, rng = _pools(glm, 12, seed=3)
    for first, nblk, seq in ((0, 2, 32), (2, 1, 64)):
        views = {}
        for k, pool in tm.caches.items():
            bd = tm.batch_dims[k]
            shape = pool.shape[:bd] + (2, seq) + pool.shape[bd + 2:]
            views[k] = rng.standard_normal(tuple(shape)).astype(np.float32)
        row = 1                       # slot 1 of the view, table row 0
        jslab = {k: jnp.asarray(v, jnp.bfloat16)[
            (slice(None),) * tm.batch_dims[k] + (slice(row, row + 1),)]
            for k, v in views.items()}
        jout = jm.scatter_row_pages(
            jm.caches, jslab, jnp.asarray(jm.page_table[0]), first, nblk,
            first * 16, nblk * 16)
        jm.caches = jout
        tm.scatter_row_pages(tm.caches, {k: torch.from_numpy(v).bfloat16()
                                         for k, v in views.items()},
                             torch.from_numpy(tm.page_table[0].copy()),
                             torch.tensor([first]), nblk, row=row)
        _same({k: v[:, 1:] if tm.batch_dims[k] else v[1:]
               for k, v in jout.items()},
              {k: v[:, 1:] if tm.batch_dims[k] else v[1:]
               for k, v in tm.caches.items()})


def test_check_unaliased_refuses_a_page_mapped_twice(glm):
    jm, tm, _ = _pools(glm, 12, seed=0)
    tm.check_unaliased(tm.page_table)
    table = tm.page_table.copy()
    table[1, 2] = table[0, 0]
    with pytest.raises(tkv.CacheRowError, match="mapped by two blocks"):
        tm.check_unaliased(table)


# -- dense vs paged, and the JAX paged engine --------------------------------


@pytest.fixture(scope="module")
def served(pair):
    """The mixed trace on the port's dense and paged engines and on the
    JAX paged engine."""
    vocab = pair.jm.cfg.vocab
    jeng, peng = pair.engines(cache=lambda m: m.PagedCache(page_size=16))
    want = _serve(jeng, jserve, vocab)
    got = _serve(peng, tserve, vocab)
    _, deng = pair.engines()
    dense = _serve(deng, tserve, vocab)
    return pair, jeng, peng, deng, want, got, dense


def test_dense_paged_bitwise(served):
    """Greedy decode on the paged backend is bitwise the dense backend's
    on a trace with batched prefill, chunked prefill, decode tiers and
    compaction; every page is back in the pool."""
    _, _, peng, deng, _, got, dense = served
    assert all(r.ok for r in got.values())
    assert {k: r.output for k, r in got.items()} \
        == {k: r.output for k, r in dense.items()}
    assert peng.cache.row_owner == {}
    assert len(peng.cache.free_pages) == peng.cache.num_pages
    assert peng.cache.pages_used() == 0
    assert not peng.cache.page_table.any()
    assert peng.stats["chunk_steps"] > 0, "trace must exercise chunking"
    assert peng.dispatch_log == deng.dispatch_log


def test_paged_tokens_and_counters_match_jax_paged_engine(served,
                                                          monkeypatch):
    pair, jeng, peng, _, want, got, _ = served
    _assert_near_tie(pair, got, want, monkeypatch)
    assert peng.dispatch_log == jeng.dispatch_log
    for k in ("prefill_steps", "chunk_steps", "decode_steps",
              "decode_tokens", "finished", "peak_active", "page_denied",
              "row_moves"):
        assert peng.stats[k] == jeng.stats[k], k
    tk, jk = peng.stats["kv"], jeng.stats["kv"]
    assert tk == jk


# -- capacity and admission --------------------------------------------------


@pytest.fixture(scope="module")
def oversubscribed(glm):
    engines = glm.engines(max_batch=8, cache=lambda m: m.PagedCache(
        page_size=16, num_pages=6))
    return [(eng, _serve(eng, mod, glm.jm.cfg.vocab, seed=3, n_reqs=10,
                         max_new=12, chunk_last=False))
            for eng, mod in zip(engines, (jserve, tserve))]


def test_oversubscribed_pool_drains(oversubscribed):
    """More rows than pages' worth of tokens: the engine degrades through
    page denials and preemption, every request still finishes, no page
    leaks, and the counters are the JAX engine's."""
    (jeng, _), (teng, done) = oversubscribed
    assert len(done) == 10
    assert all(r.ok for r in done.values()), [r.result for r in done.values()]
    st = teng.stats
    assert st["page_denied"] > 0, "pool was never under pressure"
    assert st["preempted"] > 0
    assert teng.cache.row_owner == {}
    assert len(teng.cache.free_pages) == teng.cache.num_pages
    for k in ("page_denied", "preempted", "resumed", "finished",
              "prefill_steps", "chunk_steps", "decode_steps",
              "peak_active"):
        assert st[k] == jeng.stats[k], k
    assert teng.dispatch_log == jeng.dispatch_log


def test_oversubscribed_tokens_match_jax(glm, oversubscribed, monkeypatch):
    (_, want), (_, got) = oversubscribed
    _assert_near_tie(glm, got, want, monkeypatch)


def test_prompt_overflow_on_page_capacity(glm):
    engines = glm.engines(cache=lambda m: m.PagedCache(page_size=16,
                                                       num_pages=2))
    for eng, mod in zip(engines, (jserve, tserve)):
        with pytest.raises(mod.PromptOverflow, match="KV pages"):
            eng.submit(mod.Request(rid=0, prompt=np.arange(
                40, dtype=np.int32) % 100, max_new_tokens=4))
        assert not eng.waiting


def test_page_pressure_policy(glm):
    """The policy alone, then through the engines: the paged engine feeds
    page-granular capacity signals, so PagePressure sheds what the JAX
    paged engine sheds."""
    def ctx(free, cap, prompt):
        return AdmissionContext(queue_depth=0, active=1, chunking=0,
                                free_rows=4, max_batch=8,
                                prompt_len=prompt, priority=0,
                                waited_s=0.0, deadline_left_s=None,
                                ttft_left_s=None, free_tokens=free,
                                capacity_tokens=cap)
    pol = tserve.PagePressure(max_util=0.75)
    assert isinstance(pol(ctx(free=8, cap=64, prompt=16)), tserve.Shed)
    assert pol(ctx(free=48, cap=64, prompt=16)) is None
    # the backend reported nothing: decline
    assert pol(ctx(free=-1, cap=-1, prompt=16)) is None
    assert pol.identity() == ("page_pressure", 0.75)
    results = []
    engines = glm.engines(
        cache=lambda m: m.PagedCache(page_size=16, num_pages=8),
        admission=lambda m: m.PagePressure(max_util=0.6))
    for eng, mod in zip(engines, (jserve, tserve)):
        shed = []
        for i, n in enumerate((30, 30, 20, 5, 40)):
            eng.submit(mod.Request(rid=i, prompt=np.arange(
                n, dtype=np.int32) % 100, max_new_tokens=3))
            eng.step()              # admission reserves the prompt's pages
            shed.append(isinstance(eng.finished[-1].result, mod.Shed)
                        if eng.finished and eng.finished[-1].rid == i
                        else False)
        eng.run()
        results.append((shed, eng.stats["shed"], eng.stats["kv"]))
    assert results[0] == results[1]
    assert any(results[1][0]) and not all(results[1][0])


# -- plan persistence --------------------------------------------------------


def _keys_of(eng, monkeypatch):
    """The graph keys the engine forms for a decode tier, a prefill group
    and a chunk group (recorded without capturing: the store's
    ``get_or_build`` is a spy)."""
    keys = []
    monkeypatch.setattr(eng.store, "get_or_build",
                        lambda key, build: keys.append(key))
    eng._graph(2)
    eng._group_graph("prefill", 2, 16)
    eng._group_graph("chunk", 1, 32)
    monkeypatch.undo()
    return keys


def test_backend_salts_plan_keys(glm, monkeypatch):
    """Dense and paged engines sharing one PlanStore never share a plan:
    a dense engine after a paged run pays its own misses (the
    cache-backend identity in every outer key), and a second paged engine
    replays every plan for free.  The graph keys carry the backend's
    salt (and, prefill and decode, the sampling policy's) after the
    engine's name, as the JAX engine's exec keys do."""
    store = tstore.PlanStore()
    vocab = glm.jm.cfg.vocab

    def run(cache):
        eng = Program(glm.prog.model, glm.prog.policy, device="cpu",
                      store=store).serve(
            glm.tparams, tserve.ServeConfig(cache=cache, **CFG))
        done = _serve(eng, tserve, vocab, seed=1, n_reqs=4,
                      chunk_last=False)
        assert all(r.ok for r in done.values())
        return store.stats["misses"], eng

    paged_misses, peng = run(tserve.PagedCache(page_size=16))
    assert paged_misses > 0
    dense_misses = run(None)[0] - paged_misses
    assert dense_misses > 0, \
        "dense engine replayed paged plans: backend salt missing"
    again, _ = run(tserve.PagedCache(page_size=16))
    assert again == paged_misses + dense_misses, \
        "same-backend engine should hit every plan"
    _, deng = glm.engines()
    pkeys, dkeys = _keys_of(peng, monkeypatch), _keys_of(deng, monkeypatch)
    ptag = tkv.cache_backend_salt(tkv.PagedCache(page_size=16))
    dtag = tkv.cache_backend_salt(tkv.DenseCache())
    assert pkeys == [("decode", ("engine", peng._serial), ptag, "greedy", 2),
                     ("prefill", ("engine", peng._serial), ptag, "greedy",
                      2, 16),
                     ("chunk", ("engine", peng._serial), ptag, 1, 32)]
    assert [k[2] for k in dkeys] == [dtag] * 3


def test_paged_store_checkpoints_and_restores_without_lowering(
        glm, tmp_path, monkeypatch):
    """A path-bound paged engine checkpoints its plans when the queue
    drains, every outer key formed under the paged backend's identity,
    and a fresh program opened on the file serves the same tokens with
    no ``lower`` call.  (The bytes are not the reference's: the port's
    op-closure config names its kernels where the JAX package's names
    its attention implementation, so every outer key differs, dense or
    paged.)"""
    path = str(tmp_path / "paged.dfps")
    vocab = glm.jm.cfg.vocab
    backends = []
    orig = tstore.outer_key

    def spy(graph, plan, salt="", op_config=(), struct_key_=None):
        backends.append(dict(op_config)["cache_backend"])
        return orig(graph, plan, salt=salt, op_config=op_config,
                    struct_key_=struct_key_)
    monkeypatch.setattr(tstore, "outer_key", spy)
    prog = tcompile("chatglm3-6b", smoke=True, device="cpu",
                    policy="sequential", plan_store_path=path, cache="paged")
    eng = prog.serve(glm.tparams, tserve.ServeConfig(**CFG))
    assert isinstance(eng.backend, tserve.PagedCache)
    got = _serve(eng, tserve, vocab)
    assert not eng.store.dirty
    outer = _outer_keys(path)
    assert len(outer) == len(set(outer)) == eng.store.stats["misses"] > 0
    assert set(backends) == {("paged", 16, None)}
    monkeypatch.setattr(tstore, "lower", _no_lower)
    warm = tcompile("chatglm3-6b", smoke=True, device="cpu",
                    policy="sequential", plan_store_path=path)
    weng = warm.serve(glm.tparams, tserve.ServeConfig(cache="paged", **CFG))
    again = _serve(weng, tserve, vocab)
    assert {k: r.output for k, r in again.items()} \
        == {k: r.output for k, r in got.items()}
    snap = weng.stats["plan_store"]
    assert snap["misses"] == 0 and snap["restore_hits"] == len(outer)


def _outer_keys(path):
    with open(path) as f:
        lines = f.read().splitlines()
    assert json.loads(lines[0])["entries"] == len(lines) - 1
    return [ln.split(" ", 4)[2] for ln in lines[1:]]


def _no_lower(*a, **k):
    raise AssertionError("lower() called on a warm-started store")


# -- drain, preemption, bundles ----------------------------------------------


def test_preempted_rows_release_their_pages_and_drain_leaves_none(glm):
    """A priority preemption under pages: the victim's pages go back,
    its seed/rid/ids move with compaction, and after ``drain()`` no page
    or row is held.  The JAX engine makes the same decisions."""
    outs = []
    for eng, mod in zip(glm.engines(cache="paged", max_batch=2),
                        (jserve, tserve)):
        for i, n in enumerate((30, 20)):
            eng.submit(mod.Request(rid=i, prompt=np.arange(
                n, dtype=np.int32) % 100, max_new_tokens=10))
        for _ in range(3):
            eng.step()
        eng.submit(mod.Request(rid=9, prompt=np.arange(
            12, dtype=np.int32) % 100, max_new_tokens=4, priority=5))
        eng.step()                  # preempts a row for the new request
        report = eng.drain()
        st = eng.stats
        assert eng.cache.pages_used() == 0 and eng.cache.row_owner == {}
        assert report["free_rows"] == 2
        outs.append((st["preempted"], st["resumed"], st["finished"],
                     st["kv"]["pages_used"], eng.dispatch_log))
    assert outs[0] == outs[1] and outs[1][0] == 1


def test_paged_bundle_round_trip(tmp_path):
    """``save`` records the cache backend's identity and ``load`` rebuilds
    it, then serves through it with no ``lower`` call."""
    path = str(tmp_path / "prog.dfpb")
    p1 = tcompile("chatglm3-6b", policy="sequential", smoke=True,
                  device="cpu", cache="paged")
    p1.prefill(1, 16)
    assert p1.save(path) > 0
    misses1 = p1.stats["misses"]
    assert misses1 > 0
    p2 = Program.load(path, device="cpu")
    assert isinstance(p2.cache_backend, tserve.PagedCache)
    assert p2.cache_backend == tserve.PagedCache()
    assert p2.policy_spec == "sequential"
    assert p2.model.cfg.name == p1.model.cfg.name
    p2.prefill(1, 16)
    assert p2.stats["misses"] == 0, f"loaded program re-lowered: {p2.stats}"
    eng = p2.serve(p2.init_params(0), tserve.ServeConfig(**CFG))
    assert isinstance(eng.cache, tserve.PagedKVCacheManager)
    assert Program.load(path, device="cpu", cache="dense") \
        .cache_backend == tserve.DenseCache()
