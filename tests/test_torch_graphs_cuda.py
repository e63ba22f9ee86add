"""CUDA Graph capture and replay on the card: each Hopper kernel captured
alone, and the serve engine's decode graphs on a depth-cut model of each
family.  Every case carries the ``cuda`` marker and skips without a CUDA
device; the file imports neither JAX nor the JAX package, so it runs on
the GPU machine too:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        tests/test_torch_graphs_cuda.py

A kernel's pipeline waits have no watchdog, so a fault hangs it instead
of failing the launch: every case runs under ``faulthandler``'s timer,
which ends the process with a traceback after ``TIMEOUT_S``.

  * A kernel is captured at a main path's shape (``core.capture.
    GraphStep``: warmed once on copies of its inputs, then captured);
    new values are copied into its inputs, and a replay must give
    bitwise the eager call's output on those values.  That covers
    flash's per-call tile counter and the SSD scan's and decode
    attention's workspaces cached per stream.  The capture adds nothing
    to the launch counts; every replay adds the kernel's one launch.
  * Engines: chatglm3-6b, deepseek-moe-16b, mamba2-2.7b and zamba2-1.2b
    at full width, cut in depth, serve one mix of requests whose tiers
    shrink 4 -> 2 -> 1: with graphs (``ServeConfig()``) the greedy
    tokens equal those of ``lowered=False`` (the interpreter, eagerly),
    every decode step and every prefill group is one replay, the launch
    counts equal the eager run's, and ``warmup()`` — decode tiers and
    prefill groups — leaves every cache, id and length bitwise as it
    found them.
  * A prefill group replayed as a graph writes bitwise the caches, next
    ids and first tokens of the same group run eagerly through the slot
    IR, with a padded slot (3 requests in a group of 4) whose alias of
    row 0 must lose to slot 0.  Two engines of one Program, stepped in
    turns, each serve their own interpreter's tokens (their graphs share
    the Program's store, never buffers or graph pools).
    An evicted graph is freed, and its next use captures anew.
  * A chunk group (chunked prefill through the decode graph) replayed as
    a graph writes bitwise the caches and next ids of the same group run
    eagerly through the slot IR — a packed group with a padded slot, then
    a prompt's final chunk, whose sentinel token lands in ``_last_ids``
    — and a mix with prompts longer than the largest bucket serves the
    interpreter's tokens and launch counts with every chunk step one
    replay.
"""
import gc
import weakref
import dataclasses
import faulthandler

import numpy as np
import pytest
import torch

from repro_torch.core.capture import GraphStep
from repro_torch.kernels import LAUNCHES, launch_counts, reset_launch_counts
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import grouped_matmul as tgm
from repro_torch.kernels import rmsnorm as trn
from repro_torch.kernels import ssd_scan as tssd

TIMEOUT_S = 600


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    faulthandler.dump_traceback_later(TIMEOUT_S, exit=True)
    yield torch.device("cuda")
    faulthandler.cancel_dump_traceback_later()


def _randn(g, *shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=g, device=g.device).to(dtype)


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _replay_equals_eager(name, fn, inputs, fresh):
    """Capture ``fn(*inputs)``; copy ``fresh`` into ``inputs``; a replay
    must give bitwise ``fn(*fresh)``, counting one launch of ``name``."""
    stream = torch.cuda.Stream()
    step = GraphStep(lambda: fn(*inputs),
                     lambda: fn(*[t.clone() for t in inputs]), stream=stream)
    assert dict(step.launches) == {name: 1}
    for t, new in zip(inputs, fresh):
        t.copy_(new)
    before = LAUNCHES[name]
    got = tuple(t.clone() for t in _as_tuple(step.replay()))
    assert LAUNCHES[name] == before + 1
    want = _as_tuple(fn(*fresh))
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # and again: the graph reads its inputs anew on every replay
    for t, new in zip(inputs, fresh):
        t.copy_(new * 0.5)
    got = _as_tuple(step.replay())
    want = _as_tuple(fn(*[new * 0.5 for new in fresh]))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _inputs_twice(make):
    return make(1), make(2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hk", [(2, 2048, 32, 2), (4, 2048, 16, 16)])
def test_flash_kernel_replays_bitwise(cuda, B, S, H, Hk):
    def make(seed):
        g = torch.Generator(device=cuda).manual_seed(seed)
        return [_randn(g, B, S, H, 128), _randn(g, B, S, Hk, 128),
                _randn(g, B, S, Hk, 128)]
    kvh = (torch.arange(H, device=cuda) // (H // Hk)).to(torch.int32)
    _replay_equals_eager(
        "flash_attention",
        lambda q, k, v: tfa.flash_attention(q, k, v, causal=True,
                                            kv_head=kvh),
        *_inputs_twice(make))


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hk", [(32, 2), (16, 16), (32, 32)])
def test_decode_kernel_replays_bitwise(cuda, H, Hk):
    B, S = 4, 4096
    kvh = (torch.arange(H, device=cuda) // (H // Hk)).to(torch.int32)

    def make(seed):
        g = torch.Generator(device=cuda).manual_seed(seed)
        lens = torch.randint(1, S + 1, (B,), generator=g, device=cuda,
                             dtype=torch.int32)
        return [_randn(g, B, 1, H, 128), _randn(g, B, S, Hk, 128),
                _randn(g, B, S, Hk, 128), lens]
    inputs, fresh = _inputs_twice(make)

    def fn(q, kc, vc, clen):
        return tdec.decode_attention(q, kc, vc, clen, kv_head=kvh)

    stream = torch.cuda.Stream()
    step = GraphStep(lambda: fn(*inputs),
                     lambda: fn(*[t.clone() for t in inputs]), stream=stream)
    for t, new in zip(inputs, fresh):
        t.copy_(new)
    got = step.replay().clone()
    want = fn(*fresh)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert dict(step.launches) == {"decode_attention": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(4, 4096), (4, 2048), (4, 2560),
                                 (8192, 4096)])
def test_rmsnorm_kernel_replays_bitwise(cuda, n, d):
    def make(seed):
        g = torch.Generator(device=cuda).manual_seed(seed)
        return [_randn(g, n, d), _randn(g, d)]
    _replay_equals_eager("rmsnorm", trn.rmsnorm, *_inputs_twice(make))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 8192])
def test_fused_add_rmsnorm_kernel_replays_bitwise(cuda, n):
    d = 4096

    def make(seed):
        g = torch.Generator(device=cuda).manual_seed(seed)
        return [_randn(g, n, d), _randn(g, n, d), _randn(g, d)]
    _replay_equals_eager(
        "fused_add_rmsnorm",
        lambda x, y, gw: trn.fused_add_rmsnorm(x, y, gw, block_rows=256),
        *_inputs_twice(make))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [4, 480])
def test_grouped_ffn_kernel_replays_bitwise(cuda, N):
    E, D, Fd = 64, 2048, 1408

    def make(seed):
        g = torch.Generator(device=cuda).manual_seed(seed)
        return [_randn(g, E, N, D),
                (_randn(g, E, D, Fd).float() * D ** -0.5).bfloat16(),
                (_randn(g, E, D, Fd).float() * D ** -0.5).bfloat16(),
                (_randn(g, E, Fd, D).float() * Fd ** -0.5).bfloat16()]
    _replay_equals_eager("grouped_ffn", tgm.grouped_ffn, *_inputs_twice(make))


@pytest.mark.cuda
@pytest.mark.parametrize("b,H,N", [(2, 80, 128), (2, 64, 64)])
def test_ssd_scan_kernel_replays_bitwise(cuda, b, H, N):
    L, P = 2048, 64

    def make(seed):
        g = torch.Generator(device=cuda).manual_seed(seed)
        x = _randn(g, b, L, H, P, dtype=torch.float32) * 0.5
        Bm = _randn(g, b, L, 1, N, dtype=torch.float32) * 0.5
        C = _randn(g, b, L, 1, N, dtype=torch.float32) * 0.5
        dt = torch.nn.functional.softplus(
            _randn(g, b, L, H, dtype=torch.float32) - 3.0)
        A = -torch.exp(torch.rand((H,), generator=g, device=cuda) * 5.1
                       - 2.3)
        D = 1.0 + 0.1 * _randn(g, H, dtype=torch.float32)
        return [x.bfloat16(), dt, A, Bm.bfloat16(), C.bfloat16(), D]
    _replay_equals_eager("ssd_scan", tssd.ssd_scan, *_inputs_twice(make))


# ---------------------------------------------------------------------------
# the serve engine's decode graphs
# ---------------------------------------------------------------------------

# (arch, layers kept): zamba2-1.2b keeps one group of 6 Mamba2 layers and
# its shared attention block
ENGINES = [("chatglm3-6b", 2), ("deepseek-moe-16b", 2), ("mamba2-2.7b", 2),
           ("zamba2-1.2b", 6)]
PROMPTS = (17, 40, 100, 250)
NEW_TOKENS = (3, 6, 12, 9)          # rows finish apart: tiers 4 -> 2 -> 1


def _engine_cfg(**kw):
    from repro_torch.serve import ServeConfig
    return ServeConfig(max_batch=4, s_max=512, prefill_batch=4,
                       prefill_buckets=(32, 64, 128, 256), **kw)


def _submit_mix(engine, vocab, seed=0, new_tokens=NEW_TOKENS):
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    for i, (n, new) in enumerate(zip(PROMPTS, new_tokens)):
        engine.submit(Request(i, rng.integers(0, vocab, n).astype(np.int32),
                              max_new_tokens=new))


def _serve(prog, params, lowered, warm_first=True):
    """Run the mix; returns (engine, tokens by rid, launch counts)."""
    engine = prog.serve(params, _engine_cfg(lowered=lowered))
    if warm_first:
        engine.warmup()
    _submit_mix(engine, prog.model.cfg.vocab)
    torch.cuda.synchronize()
    reset_launch_counts()
    done = engine.run()
    torch.cuda.synchronize()
    counts = launch_counts()
    return engine, {r.rid: list(r.output) for r in done}, counts


@pytest.fixture(scope="module", params=ENGINES, ids=[a for a, _ in ENGINES])
def served(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    faulthandler.dump_traceback_later(TIMEOUT_S, exit=True)
    from repro_torch.api import compile as tcompile
    from repro_torch.configs import get_config
    arch, layers = request.param
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    prog = tcompile(cfg, policy="sequential")
    params = prog.init_params(0)
    eager = _serve(prog, params, lowered=False)
    graphed = _serve(prog, params, lowered=True)
    faulthandler.cancel_dump_traceback_later()
    yield prog, params, eager, graphed
    del params
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_graphed_engine_serves_the_interpreters_tokens(cuda, served):
    _, _, (_, want, _), (engine, got, _) = served
    assert got == want
    assert all(len(got[i]) == n for i, n in enumerate(NEW_TOKENS))


@pytest.mark.cuda
def test_every_decode_step_is_one_replay(cuda, served):
    _, _, (eager, _, _), (engine, _, _) = served
    st = engine.stats
    assert st["decode_steps"] > 0
    assert st["graph_replays"] == st["decode_steps"]
    assert st["graph_captures"] == len(engine.tiers)   # warmup built all
    assert st["capture_s"] > 0
    assert st["prefill_graph_replays"] == st["prefill_steps"] > 0
    assert st["prefill_graph_captures"] == 1           # one (4, 256) group
    assert st["prefill_capture_s"] > 0
    assert st["plan_store"]["n_execs"] >= len(engine.tiers) + 1
    used = [t for t, n in st["tier_steps"].items() if n]
    assert len(used) >= 3, st["tier_steps"]            # 4 -> 2 -> 1
    assert eager.stats["graph_replays"] == eager.stats["graph_captures"] == 0
    assert eager.stats["prefill_graph_replays"] == 0
    assert eager.stats["tier_steps"] == st["tier_steps"]


@pytest.mark.cuda
def test_replayed_launch_counts_equal_the_eager_runs(cuda, served):
    _, _, (_, _, want), (_, _, got) = served
    assert got == want
    assert got.get("rmsnorm", 0) > 0


@pytest.mark.cuda
def test_warmup_changes_no_state(cuda, served):
    from repro_torch.serve import Request
    prog, params, _, _ = served
    engine = prog.serve(params, _engine_cfg())
    rng = np.random.default_rng(1)
    for i, n in enumerate(PROMPTS):
        engine.submit(Request(i, rng.integers(0, prog.model.cfg.vocab, n)
                              .astype(np.int32), max_new_tokens=8))
    engine.step()                   # prefill and the tier-4 graph
    engine.step()
    torch.cuda.synchronize()
    assert engine.stats["graph_captures"] == 1
    before = {k: v.clone() for k, v in engine.cache.caches.items()}
    ids, step_in = engine._last_ids.clone(), engine._step_in.clone()
    lengths = engine.cache.lengths.copy()
    engine.warmup(prefill=((2, 64), (1, 32)))   # tiers 1, 2 and two groups
    torch.cuda.synchronize()
    assert engine.stats["graph_captures"] == len(engine.tiers)
    assert engine.stats["prefill_graph_captures"] == 3
    for k, v in engine.cache.caches.items():
        assert torch.equal(v, before[k]), k
    assert torch.equal(engine._last_ids, ids)
    assert torch.equal(engine._step_in, step_in)
    assert np.array_equal(engine.cache.lengths, lengths)
    engine.run()


# ---------------------------------------------------------------------------
# prefill groups as graphs, engines sharing a store, eviction
# ---------------------------------------------------------------------------


def _group_state(engine, bp, bucket, lens, seed):
    """Admit ``lens`` requests as one group at ``(bp, bucket)`` (rows 0..);
    returns the engine's caches, next ids and first tokens after it."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    vocab = engine.model.cfg.vocab
    for i, n in enumerate(lens):
        p = rng.integers(1, vocab, n).astype(np.int32)
        engine.submit(Request(i, p, max_new_tokens=4))
    engine._admit()
    assert engine.stats["prefill_steps"] == 1
    (fetch, _slots), = engine._pending_prefill
    tok = torch.from_numpy(fetch.wait().copy())
    torch.cuda.synchronize()
    return ({k: v.clone() for k, v in engine.cache.caches.items()},
            engine._last_ids.clone(), tok,
            [r.prompt for r in engine.active.values()])


@pytest.mark.cuda
@pytest.mark.parametrize("lens", [(200, 256, 130, 90), (100, 256, 37)],
                         ids=["full-group", "padded-slot"])
def test_prefill_group_replays_the_eager_slot_ir_bitwise(cuda, served, lens):
    prog, params, _, _ = served
    graphed = prog.serve(params, _engine_cfg())
    eager = prog.serve(params, _engine_cfg())
    eager._graphed = False              # the same lowered step, eagerly
    caches_g, ids_g, tok_g, prompts = _group_state(graphed, 4, 256, lens,
                                                   seed=3)
    caches_e, ids_e, tok_e, _ = _group_state(eager, 4, 256, lens, seed=3)
    assert graphed.stats["prefill_graph_replays"] == 1
    assert eager.stats["prefill_graph_replays"] == 0
    assert torch.equal(tok_g, tok_e)
    assert torch.equal(ids_g, ids_e)
    for k in caches_g:
        assert torch.equal(caches_g[k], caches_e[k]), k
    # slot 0's request holds row 0: its first token (its own last prompt
    # token where the prompt is shorter than the bucket) is there, not a
    # padded slot's
    first0 = int(prompts[0][-1]) if lens[0] < 256 else int(tok_g[0])
    assert int(ids_g[0, 0]) == first0


@pytest.mark.cuda
def test_two_engines_of_one_program_in_turns(cuda, served):
    prog, params, (_, want, _), _ = served
    a = prog.serve(params, _engine_cfg())
    b = prog.serve(params, _engine_cfg())
    vocab = prog.model.cfg.vocab
    _submit_mix(a, vocab)
    _submit_mix(b, vocab, seed=5, new_tokens=(4, 4, 7, 5))
    busy = True
    while busy:
        busy = False
        for e in (a, b):
            busy = e.step() or busy
    got_a = {r.rid: list(r.output) for r in a.finished}
    got_b = {r.rid: list(r.output) for r in b.finished}
    ref_b = prog.serve(params, _engine_cfg(lowered=False))
    _submit_mix(ref_b, vocab, seed=5, new_tokens=(4, 4, 7, 5))
    want_b = {r.rid: list(r.output) for r in ref_b.run()}
    assert got_a == want
    assert got_b == want_b
    for e in (a, b):
        assert e.stats["prefill_graph_replays"] == e.stats["prefill_steps"]
    assert a.store is b.store is prog.store


@pytest.mark.cuda
def test_evicted_graph_is_freed_and_recaptured(cuda, served):
    prog, params, (_, want, _), _ = served
    capacity = prog.store.exec_capacity
    try:
        _evict_and_recapture(prog, params, want)
    finally:
        prog.store.exec_capacity = capacity


def _evict_and_recapture(prog, params, want):
    engine = prog.serve(params, _engine_cfg(exec_capacity=1))
    g4 = weakref.ref(engine._graph(4))
    assert g4() is not None
    before = engine.store.stats["exec_evictions"]
    engine._graph(2)                    # capacity 1: tier 4's graph goes
    gc.collect()
    assert g4() is None
    assert engine.store.stats["exec_evictions"] == before + 1
    captures = engine.stats["graph_captures"]
    engine._graph(4)
    assert engine.stats["graph_captures"] == captures + 1
    _submit_mix(engine, prog.model.cfg.vocab)
    got = {r.rid: list(r.output) for r in engine.run()}
    assert got == want                  # recaptured graphs, same tokens



# ---------------------------------------------------------------------------
# chunked prefill as graphs
# ---------------------------------------------------------------------------

LONG_PROMPTS = (400, 300, 280)      # > the largest bucket (256): chunked


def _chunk_states(engine, seed):
    """Submit the long prompts and run two admission passes (the packed
    first chunks, then the oldest prompt's final chunk); returns the
    caches and next ids after each."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    vocab = engine.model.cfg.vocab
    for i, n in enumerate(LONG_PROMPTS):
        engine.submit(Request(i, rng.integers(1, vocab, n).astype(np.int32),
                              max_new_tokens=4))
    states = []
    for _ in range(2):
        engine._admit()
        torch.cuda.synchronize()
        states.append(({k: v.clone() for k, v in engine.cache.caches.items()},
                       engine._last_ids.clone()))
    return states


@pytest.mark.cuda
def test_chunk_group_replays_the_eager_slot_ir_bitwise(cuda, served):
    prog, params, _, _ = served
    graphed = prog.serve(params, _engine_cfg())
    eager = prog.serve(params, _engine_cfg())
    eager._graphed = False              # the same lowered step, eagerly
    got = _chunk_states(graphed, seed=4)
    want = _chunk_states(eager, seed=4)
    # (4, 256): three first chunks and a padded slot; then (1, 256): the
    # 400-token prompt's final chunk
    assert graphed.dispatch_log == eager.dispatch_log == [
        ("chunk", (0, 1, 2)), ("chunk", (0,))]
    assert graphed.stats["chunk_graph_replays"] == 2
    assert graphed.stats["chunk_graph_captures"] == 2
    assert eager.stats["chunk_graph_replays"] == 0
    for (caches_g, ids_g), (caches_e, ids_e) in zip(got, want):
        assert torch.equal(ids_g, ids_e)
        for k in caches_g:
            assert torch.equal(caches_g[k], caches_e[k]), k
    row = next(r for r, q in graphed.active.items() if q.rid == 0)
    assert int(got[1][1][row, 0]) == int(graphed.active[row].prompt[-1])
    for e in (graphed, eager):
        e.run()


@pytest.mark.cuda
def test_chunked_serving_with_graphs_matches_the_interpreter(cuda, served):
    from repro_torch.serve import Request
    prog, params, _, _ = served
    vocab = prog.model.cfg.vocab
    runs = {}
    for lowered in (True, False):
        engine = prog.serve(params, _engine_cfg(lowered=lowered))
        _submit_mix(engine, vocab)
        rng = np.random.default_rng(9)
        for i, n in enumerate(LONG_PROMPTS, start=len(PROMPTS)):
            engine.submit(Request(i, rng.integers(0, vocab, n)
                                  .astype(np.int32), max_new_tokens=5))
        torch.cuda.synchronize()
        reset_launch_counts()
        done = engine.run()
        torch.cuda.synchronize()
        runs[lowered] = (engine, {r.rid: list(r.output) for r in done},
                         launch_counts())
    (g, got, got_n), (e, want, want_n) = runs[True], runs[False]
    assert got == want and got_n == want_n
    assert all(r.ok for r in g.finished)
    st = g.stats
    assert st["chunk_steps"] >= len(LONG_PROMPTS)
    assert st["chunk_graph_replays"] == st["chunk_steps"]
    assert st["graph_replays"] == st["decode_steps"]
    assert st["prefill_graph_replays"] == st["prefill_steps"]
    assert g.dispatch_log == e.dispatch_log
