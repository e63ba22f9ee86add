"""Spans and counters of ``repro_torch.spans`` and the serve engine.

On the CPU: a span accrues its count and self time with nesting, enters
``record_function`` only while a profiler records (and then accrues
nothing), and the engine's ``serve.*`` names lie in a profiler's trace;
the engine's ``prefill_slots`` / ``prefill_tokens`` equal a hand count of
known groups, ``serve.step`` counts the iterations, and
``stats["spans"]`` is a copy.  On the card (``cuda`` marker, skipped
without one): a device span accrues one entry a graph replay with no
sync of its own, its seconds agree with CUDA events around the same
replays, and with the gaps between them they tile the device's
timeline; ``GraphStep``'s three ``graph.*`` spans sum to its
``capture_s``; a served engine times every replay.  The file imports
neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        tests/test_torch_spans.py
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.api import compile as tcompile
from repro_torch.serve import Request, ServeConfig

CFG = dict(max_batch=4, s_max=64, prefill_buckets=(8, 16, 32),
           prefill_batch=2)
# prompt lengths: groups (3, 8) -> (2, 8), (13, 16) -> (2, 16), (30, 5)
# -> (2, 32), then 40 > 32 chunked as (0, 32) and (32, 8) in groups of 1
LENS = (3, 8, 13, 16, 30, 5, 40)
HAND_SLOTS = 2 * 8 + 2 * 16 + 2 * 32 + 1 * 32 + 1 * 8
HAND_TOKENS = (3 + 8) + (13 + 16) + (30 + 5) + 32 + 8


def _delta(before: dict, after: dict) -> dict:
    return {k: [v[0] - before.get(k, (0, 0.0))[0],
                v[1] - before.get(k, (0, 0.0))[1]]
            for k, v in after.items()}


class _Clock:
    """``time`` for the span module: each read advances one second."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t


def test_span_accrues_self_time_and_counts_with_nesting(monkeypatch):
    monkeypatch.setattr(spans, "time", types.SimpleNamespace(
        perf_counter=_Clock().perf_counter))
    before = spans.snapshot()["spans"]
    with spans.span("test.outer"):            # reads 1 ... 8
        with spans.span("test.inner"):        # 2, 3
            pass
        with spans.span("test.inner"):        # 4, 7
            with spans.span("test.leaf"):     # 5, 6
                pass
    got = _delta(before, spans.snapshot()["spans"])
    assert got["test.leaf"] == [1, 1.0]
    assert got["test.inner"] == [2, 1.0 + 2.0]       # 3-2, then 3 less 1
    assert got["test.outer"] == [1, 7.0 - 1.0 - 3.0]  # 7 less 1 + 3
    # self times of different names never overlap: they sum to the outer
    # span's duration
    assert sum(got[n][1] for n in ("test.outer", "test.inner",
                                   "test.leaf")) == 7.0


def test_spanned_and_an_exception_still_close_the_span():
    @spans.spanned("test.fn")
    def fn(x):
        if x:
            raise ValueError(x)
        return 7

    before = spans.snapshot()["spans"]
    assert fn(0) == 7
    with pytest.raises(ValueError):
        fn(1)
    got = _delta(before, spans.snapshot()["spans"])
    assert got["test.fn"][0] == 2
    assert spans._stack() == []


def test_record_function_only_while_a_profiler_records(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    before = spans.snapshot()["spans"]
    for _ in range(5):
        with spans.span("test.guarded"):
            pass
    assert entered == []
    assert _delta(before, spans.snapshot()["spans"])["test.guarded"][0] == 5
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with spans.span("test.guarded"):
                pass
    assert entered == ["test.guarded"] * 3
    assert [e.name for e in prof.events()].count("test.guarded") == 3
    # nothing accrues while the profiler records
    assert _delta(before, spans.snapshot()["spans"])["test.guarded"][0] == 5


@pytest.fixture(scope="module")
def program():
    prog = tcompile("chatglm3-6b", smoke=True, device="cpu")
    return prog, prog.init_params(0)


def _engine(program):
    prog, params = program
    eng = prog.serve(params, ServeConfig(**CFG))
    rng = np.random.default_rng(0)
    for i, n in enumerate(LENS):
        eng.submit(Request(i, rng.integers(0, 100, n).astype(np.int32),
                           max_new_tokens=4))
    return eng


def test_prefill_slots_and_tokens_equal_a_hand_count(program):
    eng = _engine(program)
    eng.run()
    assert eng.dispatch_log == [("prefill", (0, 1)), ("prefill", (2, 3)),
                                ("prefill", (4, 5)), ("chunk", (6,)),
                                ("chunk", (6,))]
    st = eng.stats
    assert (st["prefill_slots"], st["prefill_tokens"]) \
        == (HAND_SLOTS, HAND_TOKENS)


def test_serve_step_counts_iterations_and_stats_copy_the_spans(program):
    eng = _engine(program)
    s0 = eng.stats
    frozen = {k: list(v) for k, v in s0["spans"].items()}
    iters = 0
    while eng._busy():
        eng.step()
        iters += 1
    s1 = eng.stats
    got = _delta(s0["spans"], s1["spans"])
    assert got["serve.step"][0] == iters > 0
    assert got["serve.admit"][0] == iters
    assert got["serve.prefill"][0] == eng.stats["prefill_steps"] == 3
    assert got["serve.chunk"][0] == eng.stats["chunk_steps"] == 2
    assert all(got[n][1] >= 0.0 for n in got)
    # later steps changed neither the earlier copy nor each other's
    assert s0["spans"] == frozen
    assert s1["spans"] is not s0["spans"]
    assert s1["spans"]["serve.step"] is not s0["spans"]["serve.step"]
    assert s1["device_spans"] == s0["device_spans"]   # no graph on the CPU


def test_engine_spans_lie_in_a_profilers_trace(program):
    eng = _engine(program)
    before = eng.stats["spans"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.step()
        eng.step()
    names = {e.name for e in prof.events()}
    assert {"serve.step", "serve.admit", "serve.prefill", "serve.decode",
            "serve.harvest", "serve.sync"} <= names
    assert eng.stats["spans"]["serve.step"] == before["serve.step"]


# -- on the card --------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graphs replay only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_spans_time_each_replay_without_a_sync(cuda, monkeypatch):
    from repro_torch.core.capture import GraphStep
    a = torch.randn(2048, 2048, device=cuda)
    out = torch.empty_like(a)

    def step():
        x = a
        for _ in range(8):
            x = torch.tanh(x @ a) * 0.01
        out.copy_(x)
        return out

    parts = ("graph.warm", "graph.settle", "graph.record")
    s0 = spans.snapshot()["spans"]
    g = GraphStep(step, step, stream=torch.cuda.Stream(cuda))
    built = _delta(s0, spans.snapshot()["spans"])
    # the three spans split the capture's wall time, one each
    assert [built[n][0] for n in parts] == [1, 1, 1]
    assert sum(built[n][1] for n in parts) == pytest.approx(
        g.capture_s, rel=0.01)
    n = 50
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with spans.device_span("test/before"):     # the first gap's origin
        pass
    torch.cuda.synchronize()
    before = {k: list(v) for k, v in spans.snapshot()["device_spans"].items()}
    syncs = []

    def counted(real):
        def call(*args, **kwargs):
            syncs.append(real)
            return real(*args, **kwargs)
        return call

    for owner in (torch.cuda, torch.cuda.Event, torch.cuda.Stream):
        monkeypatch.setattr(owner, "synchronize",
                            counted(owner.synchronize))
    start.record()
    for _ in range(n):
        with spans.device_span("test/replay"):
            g.replay()
    end.record()
    monkeypatch.undo()
    assert syncs == []
    end.synchronize()
    after = spans.snapshot()["device_spans"]["test/replay"]
    got = [v - before.get("test/replay", (0, 0.0, 0.0))[i]
           for i, v in enumerate(after)]
    outer_s = start.elapsed_time(end) / 1e3
    assert got[0] == n
    assert got[1] == pytest.approx(outer_s, rel=0.10)
    # spans and the gaps between them tile the device's timeline
    assert got[2] >= 0.0
    assert got[1] + got[2] == pytest.approx(outer_s, rel=0.02)


@pytest.mark.cuda
def test_a_graphed_engine_times_every_replay(cuda):
    import dataclasses

    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("chatglm3-6b"), n_layers=2)
    prog = tcompile(cfg, device=cuda)
    eng = prog.serve(prog.init_params(0), ServeConfig(
        max_batch=4, s_max=512, prefill_batch=2,
        prefill_buckets=(32, 64, 128, 256)))
    rng = np.random.default_rng(0)
    for i, n in enumerate((17, 40, 100, 250, 300)):   # 300: two chunks
        eng.submit(Request(i, rng.integers(0, 1000, n).astype(np.int32),
                           max_new_tokens=6))
    s0 = eng.stats
    eng.run()
    torch.cuda.synchronize()
    s1 = eng.stats
    by_kind = {}
    for key, (count, seconds) in _delta(s0["device_spans"],
                                        s1["device_spans"]).items():
        kind = key.split("/")[0]
        by_kind[kind] = by_kind.get(kind, 0) + count
        assert count == 0 or seconds > 0.0

    def d(k):
        return s1[k] - s0[k]
    assert by_kind.get("decode", 0) == d("graph_replays") > 0
    assert by_kind.get("prefill", 0) == d("prefill_graph_replays") == 2
    assert by_kind.get("chunk", 0) == d("chunk_graph_replays") == 2
