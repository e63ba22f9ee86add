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
  * The paged cache (chatglm3-6b and deepseek-moe-16b, cut in depth):
    the mix, and the long prompts chunked, served with graphs give the
    interpreter's tokens and launch counts and the dense cache's tokens,
    every step one replay, no page held after; a prefill group, the
    decode steps after it and a chunk group replayed as graphs write
    bitwise the pages, next ids and tokens of the same steps run eagerly
    through the slot IR (the trash page aside, whose repeated writes
    have no defined winner).
  * Sampling: Philox's bits on the card equal the CPU's over a grid of
    ``(seed, rid, position)``, as does the filter's mask on the same f32
    logits; a sampled engine's graphs (decode and prefill) write
    bitwise the ids, caches and tokens of the same steps run eagerly,
    and serve the interpreter's tokens.
  * Speculative decode (chatglm3-6b cut in depth, dense and paged,
    ``ngram`` and ``self``): each verify step replayed as a graph (and
    each draft step of ``self``) writes bitwise the next ids, caches
    (pages) and ``(u, n_emit, done)`` of the same steps run eagerly
    through the slot IR; served with graphs, the mix gives the
    interpreter's tokens, spec counters and launch counts, every spec
    step one verify replay (and one draft replay), and no verify or
    draft width lowers anything after ``warmup()``.
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


@pytest.mark.cuda
@pytest.mark.parametrize("causal,Sq", [(False, 1500), (False, 1)])
def test_flash_kernel_replays_bitwise_non_causal(cuda, causal, Sq):
    """whisper-tiny's encoder (1500 keys) and its decode cross-attention
    (one row against 2048 encoder rows)."""
    B, Sk, H, hd = 4, 1500 if Sq > 1 else 2048, 6, 64

    def make(seed):
        g = torch.Generator(device=cuda).manual_seed(seed)
        return [_randn(g, B, Sq, H, hd), _randn(g, B, Sk, H, hd),
                _randn(g, B, Sk, H, hd)]
    _replay_equals_eager(
        "flash_attention",
        lambda q, k, v: tfa.flash_attention(q, k, v, causal=causal),
        *_inputs_twice(make))


@pytest.mark.cuda
def test_whisper_decode_step_replays_the_eager_steps(cuda):
    """whisper-tiny as published (6 heads of 64): its decode step captured
    as one graph — the decode forward with its cross-attention over all
    ``s_max`` encoder rows, the argmax and the advance of ids, positions
    and lengths — replays bitwise the same steps run eagerly, leaves the
    same caches, and counts one flash and one decode launch a layer."""
    from repro_torch.api import compile
    prog = compile("whisper-tiny")
    cfg = prog.model.cfg
    params = prog.init_params(0)
    B, S, s_max = 2, 200, 512
    g = torch.Generator(device=cuda).manual_seed(0)
    batch = {"frames": _randn(g, B, S, cfg.d_model),
             "ids": torch.randint(0, cfg.vocab, (B, S), generator=g,
                                  device=cuda, dtype=torch.int32),
             "positions": torch.arange(S, device=cuda, dtype=torch.int32
                                       ).expand(B, S).contiguous()}
    out = prog.prefill(B, S)(params, batch)
    dec = prog.decode_tiers(B, s_max, tiers=(B,))[B]

    def state():
        st = {"ids": out["logits"][:, -1].argmax(-1, keepdim=True).int(),
              "positions": torch.full((B, 1), S, dtype=torch.int32,
                                      device=cuda),
              "cache_len": torch.full((B,), S, dtype=torch.int32,
                                      device=cuda)}
        for name, src, dim in (("k_cache", "decoder.k", 2),
                               ("v_cache", "decoder.v", 2),
                               ("enc", "enc", 1)):
            t = out[src]
            pad = list(t.shape)
            pad[dim] = s_max - S
            st[name] = torch.cat([t, t.new_zeros(pad)], dim)
        return st

    def step(st):
        o = dec(params, dict(st))
        nxt = o["logits"][:, -1].argmax(-1).int()
        st["ids"].copy_(nxt[:, None])
        st["positions"].add_(1)
        st["cache_len"].add_(1)
        return nxt

    live, ref = state(), state()
    graph = GraphStep(lambda: step(live),
                      lambda: step({k: t.clone() for k, t in live.items()}),
                      stream=torch.cuda.Stream())
    assert graph.launches["flash_attention"] == cfg.n_layers
    assert graph.launches["decode_attention"] == cfg.n_layers
    for _ in range(4):
        got = graph.replay().clone()
        want = step(ref)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    for k in live:
        assert torch.equal(live[k], ref[k]), k


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



# ---------------------------------------------------------------------------
# the paged cache and sampling as graphs
# ---------------------------------------------------------------------------

PAGED = [("chatglm3-6b", 2), ("deepseek-moe-16b", 2)]


def _paged_cfg(**kw):
    from repro_torch.serve import PagedCache
    return _engine_cfg(cache=PagedCache(page_size=16), **kw)


@pytest.fixture(scope="module", params=PAGED, ids=[a for a, _ in PAGED])
def paged(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    faulthandler.dump_traceback_later(TIMEOUT_S, exit=True)
    from repro_torch.api import compile as tcompile
    from repro_torch.configs import get_config
    from repro_torch.serve import Request
    arch, layers = request.param
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    prog = tcompile(cfg, policy="sequential")
    params = prog.init_params(0)
    runs = {}
    for name, mk in (("graphs", lambda: _paged_cfg()),
                     ("interpreter", lambda: _paged_cfg(lowered=False)),
                     ("dense", lambda: _engine_cfg())):
        engine = prog.serve(params, mk())
        engine.warmup()
        _submit_mix(engine, prog.model.cfg.vocab)
        rng = np.random.default_rng(9)
        for i, n in enumerate(LONG_PROMPTS, start=len(PROMPTS)):
            engine.submit(Request(i, rng.integers(0, prog.model.cfg.vocab, n)
                                  .astype(np.int32), max_new_tokens=5))
        torch.cuda.synchronize()
        reset_launch_counts()
        done = engine.run()
        torch.cuda.synchronize()
        runs[name] = (engine, {r.rid: list(r.output) for r in done},
                      launch_counts())
    faulthandler.cancel_dump_traceback_later()
    yield prog, params, runs
    del params
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_paged_serving_with_graphs_matches_interpreter_and_dense(cuda,
                                                                 paged):
    _, _, runs = paged
    (g, got, got_n), (e, want, want_n) = runs["graphs"], runs["interpreter"]
    assert got == want and got_n == want_n
    assert got == runs["dense"][1]
    assert all(r.ok for r in g.finished)
    st = g.stats
    assert st["graph_replays"] == st["decode_steps"] > 0
    assert st["prefill_graph_replays"] == st["prefill_steps"] > 0
    assert st["chunk_graph_replays"] == st["chunk_steps"] >= len(LONG_PROMPTS)
    assert g.dispatch_log == e.dispatch_log == runs["dense"][0].dispatch_log
    for engine in (g, e):
        assert engine.cache.pages_used() == 0
        assert engine.cache.row_owner == {}
        assert engine.stats["kv"]["peak_pages_used"] > 0


def _pool_state(engine):
    """Every cache's real pages (the trash page 0 aside) and next ids."""
    bds = engine.cache.batch_dims
    return ({k: v.narrow(bds[k], 1, v.shape[bds[k]] - 1).clone()
             for k, v in engine.cache.caches.items()},
            engine._last_ids.clone())


def _same_state(a, b):
    (ca, ia), (cb, ib) = a, b
    assert torch.equal(ia, ib)
    for k in ca:
        assert torch.equal(ca[k], cb[k]), k


@pytest.mark.cuda
def test_paged_steps_replay_the_eager_slot_ir_bitwise(cuda, paged):
    """A paged prefill group (a padded slot), the decode steps after it,
    then a paged chunk group and a final chunk: each replayed as a graph
    writes bitwise what the same step writes run eagerly."""
    prog, params, _ = paged
    graphed = prog.serve(params, _paged_cfg())
    eager = prog.serve(params, _paged_cfg())
    eager._graphed = False              # the same lowered steps, eagerly
    lens = (100, 256, 37)
    for e in (graphed, eager):
        _group_state(e, 4, 256, lens, seed=3)
    _same_state(_pool_state(graphed), _pool_state(eager))
    for _ in range(5):
        for e in (graphed, eager):
            e.step()
        torch.cuda.synchronize()
        _same_state(_pool_state(graphed), _pool_state(eager))
    assert graphed.stats["graph_replays"] == graphed.stats["decode_steps"] > 0
    for e in (graphed, eager):
        e.run()
    assert {r.rid: r.output for r in graphed.finished} \
        == {r.rid: r.output for r in eager.finished}
    graphed = prog.serve(params, _paged_cfg())
    eager = prog.serve(params, _paged_cfg())
    eager._graphed = False
    got = _chunk_states(graphed, seed=4)
    want = _chunk_states(eager, seed=4)
    assert graphed.stats["chunk_graph_replays"] == 2
    for a, b in zip(got, want):
        _same_state(({k: v.narrow(graphed.cache.batch_dims[k], 1,
                                  v.shape[graphed.cache.batch_dims[k]] - 1)
                      for k, v in a[0].items()}, a[1]),
                    ({k: v.narrow(eager.cache.batch_dims[k], 1,
                                  v.shape[eager.cache.batch_dims[k]] - 1)
                      for k, v in b[0].items()}, b[1]))
    for e in (graphed, eager):
        e.run()
        assert e.cache.pages_used() == 0


@pytest.mark.cuda
def test_sampler_bits_and_mask_on_the_card_equal_the_cpus(cuda):
    from repro_torch.serve import SamplingConfig
    from repro_torch.serve import sampling as tsamp
    rng = np.random.default_rng(0)
    seeds = torch.from_numpy(rng.integers(0, 1 << 32, 64, dtype=np.uint64)
                             .astype(np.uint32).view(np.int32))
    rids = torch.from_numpy(rng.integers(0, 1 << 31, 64))
    pos = torch.from_numpy(rng.integers(0, 1 << 20, 64))
    cpu = tsamp.random_bits(seeds, rids, pos, 1031)
    gpu = tsamp.random_bits(seeds.to(cuda), rids.to(cuda), pos.to(cuda),
                            1031)
    assert torch.equal(gpu.cpu(), cpu)
    assert torch.equal(tsamp.uniform(gpu).cpu(), tsamp.uniform(cpu))
    logits = torch.from_numpy(rng.standard_normal((8, 4096))
                              .astype(np.float32) * 3)
    for cfg in (SamplingConfig(0.8, 50, 0.95), SamplingConfig(1.0, 0, 0.9),
                SamplingConfig(0.7, 20, 1.0)):
        a = tsamp._filter_logits(logits, cfg)
        b = tsamp._filter_logits(logits.to(cuda), cfg).cpu()
        assert torch.equal(torch.isneginf(a), torch.isneginf(b))


@pytest.mark.cuda
def test_sampled_graphs_replay_the_eager_steps_bitwise(cuda, served):
    """A sampled engine's prefill group and decode steps replayed as
    graphs write bitwise the ids, caches and tokens of the same steps run
    eagerly, and serve the interpreter's sampled tokens."""
    from repro_torch.serve import SamplingConfig
    prog, params, _, _ = served
    sampling = SamplingConfig(temperature=0.8, top_k=50, top_p=0.95)
    graphed = prog.serve(params, _engine_cfg(sampling=sampling, seed=7))
    eager = prog.serve(params, _engine_cfg(sampling=sampling, seed=7))
    eager._graphed = False
    for e in (graphed, eager):
        _submit_mix(e, prog.model.cfg.vocab)
    for _ in range(6):
        for e in (graphed, eager):
            e.step()
        torch.cuda.synchronize()
        assert torch.equal(graphed._last_ids, eager._last_ids)
        for k, v in graphed.cache.caches.items():
            assert torch.equal(v, eager.cache.caches[k]), k
    assert graphed.stats["graph_replays"] == graphed.stats["decode_steps"] > 0
    for e in (graphed, eager):
        e.run()
    got = {r.rid: list(r.output) for r in graphed.finished}
    assert got == {r.rid: list(r.output) for r in eager.finished}
    interp = prog.serve(params, _engine_cfg(sampling=sampling, seed=7,
                                            lowered=False))
    _submit_mix(interp, prog.model.cfg.vocab)
    assert got == {r.rid: list(r.output) for r in interp.run()}
    vocab = prog.model.cfg.vocab
    assert all(0 <= t < vocab for out in got.values() for t in out)


# ---------------------------------------------------------------------------
# speculative decode: the verify and draft steps as graphs
# ---------------------------------------------------------------------------

SPEC = [(cache, proposer, k) for cache in ("dense", "paged")
        for proposer, k in (("ngram", 4), ("self", 2))]
SPEC_COUNTERS = ("spec_steps", "spec_drafted", "spec_accepted",
                 "spec_rollbacks", "spec_fallbacks", "page_denied",
                 "decode_steps", "tier_steps")


def _spec_cfg(cache, proposer, k, **kw):
    from repro_torch.serve import SpecConfig
    if cache == "paged":
        return _paged_cfg(spec=SpecConfig(proposer=proposer, k=k), **kw)
    return _engine_cfg(spec=SpecConfig(proposer=proposer, k=k), **kw)


@pytest.fixture(scope="module")
def spec_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    from repro_torch.api import compile as tcompile
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("chatglm3-6b"), n_layers=2)
    prog = tcompile(cfg, policy="sequential")
    params = prog.init_params(0)
    yield prog, params
    del params
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("cache,proposer,k", SPEC)
def test_spec_steps_replay_the_eager_slot_ir_bitwise(cuda, spec_model, cache,
                                                     proposer, k):
    prog, params = spec_model
    graphed = prog.serve(params, _spec_cfg(cache, proposer, k))
    eager = prog.serve(params, _spec_cfg(cache, proposer, k))
    eager._graphed = False              # the same lowered steps, eagerly
    state = _pool_state if cache == "paged" else (
        lambda e: ({n: v.clone() for n, v in e.cache.caches.items()},
                   e._last_ids.clone()))
    for e in (graphed, eager):
        _submit_mix(e, prog.model.cfg.vocab)
    for _ in range(6):
        for e in (graphed, eager):
            e.step()
        torch.cuda.synchronize()
        _same_state(state(graphed), state(eager))
        assert torch.equal(graphed._drafts, eager._drafts)
    st = graphed.stats
    assert st["verify_graph_replays"] == st["spec_steps"] > 0
    assert st["draft_graph_replays"] == (
        st["spec_steps"] if proposer == "self" else 0)
    for e in (graphed, eager):
        e.run()
    assert {r.rid: r.output for r in graphed.finished} \
        == {r.rid: r.output for r in eager.finished}


@pytest.mark.cuda
@pytest.mark.parametrize("cache,proposer,k", SPEC)
def test_spec_serving_with_graphs_matches_the_interpreter(cuda, spec_model,
                                                          cache, proposer, k):
    prog, params = spec_model
    runs = {}
    for name, lowered in (("graphs", True), ("interpreter", False)):
        engine = prog.serve(params, _spec_cfg(cache, proposer, k,
                                              lowered=lowered))
        engine.warmup()
        misses = engine.store.stats["misses"]
        _submit_mix(engine, prog.model.cfg.vocab)
        torch.cuda.synchronize()
        reset_launch_counts()
        done = engine.run()
        torch.cuda.synchronize()
        runs[name] = (engine, {r.rid: list(r.output) for r in done},
                      launch_counts(), engine.store.stats["misses"] - misses)
    (g, got, got_n, g_miss), (e, want, want_n, _) = (runs["graphs"],
                                                     runs["interpreter"])
    assert got == want and got_n == want_n
    assert all(len(got[i]) == n for i, n in enumerate(NEW_TOKENS))
    gs, es = g.stats, e.stats
    for key in SPEC_COUNTERS:
        assert gs[key] == es[key], key
    assert gs["verify_graph_replays"] == gs["spec_steps"] > 0
    assert gs["draft_graph_replays"] == (
        gs["spec_steps"] if proposer == "self" else 0)
    assert gs["graph_replays"] == gs["decode_steps"] - gs["spec_steps"]
    assert g_miss == 0                  # nothing lowered after warmup
    assert all(b["misses"] == 0 for b in gs["spec_builds"].values())
    assert gs["spec_graph_captures"] == len(g.tiers) * (
        2 if proposer == "self" else 1)
    if cache == "paged":
        assert g.cache.pages_used() == 0
