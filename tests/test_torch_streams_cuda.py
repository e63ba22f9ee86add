"""Per-resource CUDA streams on the card (``core/streams.py``) against
the one-stream program of the same lowered plans.

Every case carries the ``cuda`` marker and skips without a CUDA device;
the file imports neither JAX nor the JAX package, so it runs on a
machine without them.  The models run at full width, cut in depth, with
NanoFlow (DBO for the MoE LM) at a token threshold of 1, so their plans
split into micro-batches and their memory-bound ops run on the side
stream under the other micro-batch's products:

  * an eager prefill and decode step over per-resource streams, over
    random assignments of the instructions to four streams and over one
    stream give the same bits, and the same launch counts;
  * a prefill step captured as a CUDA Graph (``GraphStep``) with the
    side streams forked and joined inside the capture replays the
    one-stream graph's bits;
  * the train step's graph (forward, backward on the forward ops'
    streams, AdamW) with streams gives, step after step, the one-stream
    graph's params, moments and metrics bit for bit, and both equal the
    eager step.
"""
import dataclasses
import faulthandler

import numpy as np
import pytest
import torch

from repro_torch.core import ScheduleContext
from repro_torch.core import streams as tstreams
from repro_torch.core.capture import GraphStep
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models.base import build_forward

TIMEOUT_S = 600
FAMILIES = [("chatglm3-6b", 2), ("deepseek-moe-16b", 2), ("mamba2-2.7b", 2),
            ("zamba2-1.2b", 6)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    faulthandler.dump_traceback_later(TIMEOUT_S, exit=True)
    yield torch.device("cuda")
    faulthandler.cancel_dump_traceback_later()


def _splitting(family: str):
    from repro_torch.core.strategies.dbo import DualBatchOverlap
    from repro_torch.core.strategies.nanoflow import NanoFlow
    return (DualBatchOverlap(min_tokens=1) if family == "moe"
            else NanoFlow(min_tokens=1))


@pytest.fixture(scope="module", params=FAMILIES, ids=[a for a, _ in FAMILIES])
def model(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    from repro_torch.api import compile as tcompile
    from repro_torch.configs import get_config
    arch, layers = request.param
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    prog = tcompile(cfg, policy="sequential")
    params = prog.init_params(0)
    yield prog, params
    del params
    torch.cuda.empty_cache()


def _forward(prog, phase, B, S, lowered=True):
    q = 1 if phase == "decode" else S
    segs, _ = prog.model.build_segments(phase, B, q, s_max=S)
    info = ScheduleContext(local_batch=B, global_batch=B, seq_len=S,
                           phase=phase, arch=prog.model.cfg.name)
    return build_forward(segs, _splitting(prog.model.cfg.family), info,
                         lowered=lowered)


def _batch(prog, phase, B, S, seed=0):
    gen = torch.Generator().manual_seed(seed)
    vocab = prog.model.cfg.vocab
    if phase == "decode":
        clen = torch.tensor([0, 5, 17, S - 1][:B], dtype=torch.int32)
        out = {"ids": torch.randint(0, vocab, (B, 1), generator=gen,
                                    dtype=torch.int32),
               "positions": clen[:, None], "cache_len": clen}
        out.update({k: (torch.randn(v.shape, generator=gen) * 0.5).to(
            v.dtype) for k, v in prog.model.decode_cache_env(B, S).items()})
    else:
        out = {"ids": torch.randint(0, vocab, (B, S), generator=gen,
                                    dtype=torch.int32),
               "positions": torch.arange(S, dtype=torch.int32).expand(B, S)}
    return {k: v.to("cuda") for k, v in out.items()}


def _run(fwd, params, batch):
    """The forward on fresh copies of the batch (a decode step writes its
    caches in place), its launches, synchronized."""
    mine = {k: v.clone() for k, v in batch.items()}
    torch.cuda.synchronize()
    reset_launch_counts()
    out = fwd(params, mine)
    torch.cuda.synchronize()
    return out, launch_counts()


def _assert_bitwise(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), f"{k!r} differs"


def _four(seed, n=4):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, n, 4096)
    return lambda i: int(table[i])


@pytest.mark.cuda
@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_streams_give_the_one_stream_bits(cuda, model, phase):
    prog, params = model
    B, S = 4, 256
    fwd = _forward(prog, phase, B, S)
    assert any(r.lowered.streams.side for r in fwd.realizers.values())
    if phase == "prefill":
        assert any(r.lowered.split_sizes for r in fwd.realizers.values())
    batch = _batch(prog, phase, B, S)
    want, want_n = _run(fwd, params, batch)
    with tstreams.one_stream():
        one, one_n = _run(fwd, params, batch)
    _assert_bitwise(want, one)
    assert want_n == one_n and sum(want_n.values()) > 0
    for seed in range(3):
        with tstreams.assigned(_four(seed)):
            got, n = _run(fwd, params, batch)
        _assert_bitwise(got, want)
        assert n == want_n
    interp, _ = _run(_forward(prog, phase, B, S, lowered=False), params,
                     batch)
    _assert_bitwise(want, interp)


def _graph(fwd, params, batch, pool=None):
    """``fwd`` captured on fixed buffers: (GraphStep, its output)."""
    stream = torch.cuda.Stream()
    step = GraphStep(lambda: fwd(params, batch)["logits"],
                     lambda: fwd(params, batch), stream=stream, pool=pool)
    return step, step.replay()


@pytest.mark.cuda
def test_a_captured_prefill_with_streams_replays_the_one_stream_bits(
        cuda, model):
    prog, params = model
    fwd = _forward(prog, "prefill", 4, 256)
    batch = _batch(prog, "prefill", 4, 256, seed=1)
    g, out = _graph(fwd, params, batch)
    got = out.clone()
    with tstreams.one_stream():
        g1, out1 = _graph(fwd, params, batch)
    want = out1.clone()
    assert torch.equal(got, want)
    assert g.launches == g1.launches
    # replays keep their bits, in turns
    for step, ref in ((g, got), (g1, want), (g, got)):
        assert torch.equal(step.replay(), ref)
    eager, _ = _run(fwd, params, batch)
    assert torch.equal(eager["logits"], got)


@pytest.mark.cuda
def test_the_train_graph_with_streams_gives_the_one_stream_bits(cuda):
    from repro_torch.api import compile as tcompile
    from repro_torch.configs import get_config
    from repro_torch.core.strategies.nanoflow import NanoFlow
    from repro_torch.train import TrainStepConfig
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(get_config("smollm-135m"), n_layers=2)
    B, S = 4, 512
    params0 = tcompile(cfg).init_params(0, phase="train")
    gen = torch.Generator().manual_seed(3)
    batch = {"ids": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                  dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                     dtype=torch.int32),
             "positions": torch.arange(S, dtype=torch.int32).expand(B, S)}
    batch = {k: v.cuda() for k, v in batch.items()}
    runs = {}
    for name in ("streams", "one", "eager"):
        step = tcompile(cfg, policy=NanoFlow(min_tokens=1)).train_step(
            B, S, cfg=TrainStepConfig())
        lp = step.fn.forward.realizers["layers"].lowered
        assert lp.split_sizes and lp.streams.side
        params = {k: v for k, v in _copy(params0).items()}
        opt = step.init_opt(params)
        ms = []
        for j in range(3):
            if name == "eager":
                _, _, m = step.fn.eager(params, opt, batch, j)
            elif name == "one":
                with tstreams.one_stream():
                    _, _, m = step.fn(params, opt, batch, j)
            else:
                _, _, m = step.fn(params, opt, batch, j)
            ms.append({k: v.clone() for k, v in m.items()})
        torch.cuda.synchronize()
        if name != "eager":
            assert step.fn.stats["graph_captures"] == 1
            assert step.fn.stats["graph_replays"] == 2
        runs[name] = (params, opt, ms)
    p, o, m = runs["streams"]
    for other in ("one", "eager"):
        p2, o2, m2 = runs[other]
        for a, b in zip(leaves(p) + leaves(o), leaves(p2) + leaves(o2)):
            assert torch.equal(a, b), other
        for x, y in zip(m, m2):
            for k in x:
                assert torch.equal(x[k], y[k]), (other, k)


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree.detach().clone()
