"""MoE training in the port (deepseek-moe-16b's smoke config) against the
JAX package, and the grouped expert FFN's gradient.

The train-phase trace and plans of the MoE LM equal the reference's
(``MoELM.layer_stacks("train")``, ``make_head("train")``), and two train
steps from the reference's weights, on the same seeded batches, match
its ``_build_train_step(..., TrainStepConfig(lowered=False))`` (jitted)
under ``sequential``, ``sbo``, ``dbo`` and ``dynamic`` (resolved alike in
both packages), with tests/test_torch_train.py's ``_run_both`` /
``_check_step`` and its limits: loss within 2e-3 relative, grad_norm
within 2e-2, each leaf's update within 5e-2 relative L2.  The reference
cannot train under ``comet``: its Pallas grouped FFN has no JVP (its
``program_id`` asserts outside a grid), so the port's comet step is held
to the port's sequential one instead.

The forward is not the reference's.  The reference's einsums round
h1 = x w1 and h3 = x w3 to bf16 before the gate and h to bf16 after it;
the port's kernel (and its plain version, which the CPU runs) keeps the
gate in f32 and rounds only h.  That moves the expert output by about a
bf16 ulp of h, the same size as the roundings the dense parity already
absorbs (the attention probabilities, dh * g): the losses agree within
1e-3 and the grad norms within 5e-3.

One leaf is held to its own limit: the embedding table's update within
1e-1.  Its update differs from the reference's by 4.5e-2 after one step
and 6.7e-2 after two under every policy.  The cause is one route: the
two packages' routers pick a different second expert for one token of
the first batch, whose second and third probabilities the reference has
at 0.10408 and 0.10306, a near tie inside the bf16 rounding (~0.8% of
the router's input) the two forwards differ by from the first layer on.
Every op's cotangent agrees within 4.3e-2 up to the expert buffer,
where the flipped token moves every later token of its two experts to
another slot; the embedding's gradient sums dx over every occurrence of
a token, so the flipped token's dx reaches its row.  With the
reference's routes given to the port, every leaf's update, the
embedding's included, agrees within 1.9e-2 (the dense chatglm3-6b smoke
model's embedding: 1.7e-2): ``test_embedding_gap_is_a_near_tie_route_flip``
pins it.  Every other leaf stays within 1.4e-2.

The gradient checks hold ``GroupedFFN``'s backward (recompute, the
seven grouped products, the gate's backward) to torch.autograd of
``grouped_ffn_plain`` at odd shapes (f32 within 1e-5 relative; bf16
within 1e-2 relative L2: the backward's products round h1, h3, dh, dh1,
dh3 and h to bf16 where autograd of the f32 plain version keeps f32), and
``grouped_ffn_gate_bwd_plain`` to autograd of the gate in f64 (one bf16
rounding of each output, or f32 round-off).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.core as jcore
from repro.configs import get_smoke_config as jget_smoke
from repro.core.strategies.dbo import DualBatchOverlap as JDualBatchOverlap
from repro.models.layers import MeshInfo as JMeshInfo
from repro.models.registry import build_model as jbuild_model
import repro_torch.core as tcore
from repro_torch.api import compile as tcompile
from repro_torch.configs import get_smoke_config as tget_smoke
from repro_torch.core.plan import dtype_name
from repro_torch.core.strategies.dbo import DualBatchOverlap
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.models.base import TrainHead
from repro_torch.models.layers import MeshInfo as TMeshInfo
from repro_torch.models.registry import build_model as tbuild_model
from repro_torch.train import TrainStepConfig

import test_torch_train as tt
from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe
from test_torch_core import _jdtype, graph_summary, plan_summary
from test_torch_moe import BF16

ARCH = "deepseek-moe-16b"
B, S = 4, 16
EMBED = ("embed", "emb", "w")
EMBED_LIMIT = 1e-1          # the embedding table's update (see above)
_TRAIN_POLICY = tt._policy


def _policy(name, jax_side):
    """The test's strategies: DBO splits from 16 tokens (the smoke
    batch has 64); the rest as test_torch_train.py's."""
    if name == "dbo":
        return (JDualBatchOverlap if jax_side else DualBatchOverlap)(
            min_tokens=16)
    return _TRAIN_POLICY(name, jax_side)


def _reference_strategies(policy):
    """Segment name -> the strategy the reference's policy resolves to
    for the train step's segments."""
    jm, _ = tt._reference(ARCH)
    segs, _ = jm.build_segments("train", B, S)
    info = jcore.ScheduleContext(local_batch=B, global_batch=B, seq_len=S,
                                 phase="train", arch=jm.cfg.name)
    pol = jcore.as_policy(_policy(policy, True))
    return {s.name: jcore.resolve_strategy(pol, info, graph=s.graph).name
            for s in segs}


# ---------------------------------------------------------------------------
# the train phase's structure
# ---------------------------------------------------------------------------


def test_train_phase_traces_and_plans_match_reference():
    """``layer_stacks("train")``: the dense first layer and the MoE
    layers without K/V outputs, then ``TrainHead``; every segment's trace
    and its DBO plan equal the reference's."""
    jm = jbuild_model(jget_smoke(ARCH), JMeshInfo())
    tm = tbuild_model(tget_smoke(ARCH), TMeshInfo())
    assert isinstance(tm.make_head("train"), TrainHead)
    jsegs, jbin = jm.build_segments("train", B, S)
    tsegs, tbin = tm.build_segments("train", B, S)
    assert [s.name for s in tsegs] == [s.name for s in jsegs] == \
        ["embed", "dense0", "layers", "head"]
    jinfo = jcore.ScheduleContext(local_batch=B, global_batch=B, seq_len=S,
                                  phase="train")
    tinfo = tcore.ScheduleContext(local_batch=B, global_batch=B, seq_len=S,
                                  phase="train")
    for js, ts in zip(jsegs, tsegs):
        assert (js.count, js.scan_inputs, js.scan_outputs, js.carry) == \
            (ts.count, ts.scan_inputs, ts.scan_outputs, ts.carry)
        assert graph_summary(js.graph, _jdtype) == \
            graph_summary(ts.graph, dtype_name)
        jplan = jcore.record_plan(js.graph, _policy("dbo", True), jinfo)
        tplan = tcore.record_plan(ts.graph, _policy("dbo", False), tinfo)
        assert plan_summary(jplan) == plan_summary(tplan)
    assert {k: tuple(s.shape) for k, (s, _) in jbin.items()} == \
        {k: tuple(s.shape) for k, (s, _) in tbin.items()}


# ---------------------------------------------------------------------------
# the train step against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["sequential", "sbo", "dbo", "dynamic"])
def test_moe_train_step_matches_reference(policy, monkeypatch):
    monkeypatch.setattr(tt, "_policy", _policy)
    jms, tms, jp0, jp, tp, step = tt._run_both(ARCH, policy, B=B, S=S)
    tt._check_step(jms, tms, jp0, jp, tp, limits={EMBED: EMBED_LIMIT})
    assert step.strategies == _reference_strategies(policy)
    if policy in ("dbo", "dynamic"):
        # the MoE layers split in two micro-batches, the dispatch chain
        # per micro-batch (VBATCH), under autograd
        assert step.strategies["layers"] == "dbo"
        assert step.fn.forward.realizers["layers"].plan.split_sizes == (2, 2)


class _RouteLog:
    """Every router call's probabilities and chosen (virtual) experts,
    off the router op's kernel patched on its class; the reference's
    arrive through an ordered ``jax.debug.callback``, the port's meta
    tracing calls are skipped.  ``force``: expert ids the port's router
    takes instead of its own, each weighted by the port's probability of
    it, renormalized over the k, as its kernel weights its own picks."""

    def __init__(self, monkeypatch, module, force=None):
        self.calls = []
        orig = module.RouterOp.kernel

        def record(x, wr, ve):
            logits = np.asarray(x, np.float64) @ np.asarray(wr, np.float64)
            e = np.exp(logits - logits.max(-1, keepdims=True))
            self.calls.append((e / e.sum(-1, keepdims=True), np.asarray(ve)))

        def kernel(op, p, x):
            w, ve = orig(op, p, x)
            if module is jmoe:
                jax.debug.callback(record, x.astype(jnp.float32), p["wr"], ve,
                                   ordered=True)
                return w, ve
            if x.device.type == "meta":
                return w, ve
            if force is not None:
                ve = torch.from_numpy(np.array(force)).to(ve.dtype)
                probs = torch.softmax(torch.matmul(x.float(), p["wr"]), -1)
                w = probs.gather(-1, ve.long())
                w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
            record(x.detach().float().numpy(), p["wr"].detach().numpy(),
                   ve.numpy())
            return w, ve
        monkeypatch.setattr(module.RouterOp, "kernel", kernel)


def _embed_and_worst(jp0, jp, tp):
    """(the embedding's update's relative L2 against the reference's, the
    largest of every leaf's)."""
    j0 = dict(jax.tree_util.tree_leaves_with_path(jp0))
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        keys = tuple(k.key for k in path)
        t = tp
        for k in keys:
            t = t[k]
        old = tt.np32(j0[path])
        out[keys] = tt.rel(tt.np32(t) - old, tt.np32(leaf) - old)
    return out[EMBED], max(out.values())


def test_embedding_gap_is_a_near_tie_route_flip(monkeypatch):
    """One step under ``sequential``: the two packages' routes differ only
    where the reference's k-th and (k+1)-th probabilities sit within the
    bf16 rounding of each other (``test_torch_moe.py``'s near-tie rule),
    and at least one does; with the reference's routes given to the port,
    every leaf, the embedding's included, is within the 5e-2 every other
    leaf is held to, and the embedding's gap is less than half of what it
    is with the port's own routes."""
    monkeypatch.setattr(tt, "_policy", _policy)
    jr, tr = _RouteLog(monkeypatch, jmoe), _RouteLog(monkeypatch, tmoe)
    jms, tms, jp0, jp, tp, _ = tt._run_both(ARCH, "sequential", B=B, S=S,
                                            steps=1)
    tt._check_step(jms, tms, jp0, jp, tp, limits={EMBED: EMBED_LIMIT})
    assert len(jr.calls) == len(tr.calls) == 1
    (jprob, jve), (_, tve) = jr.calls[0], tr.calls[0]
    k = tget_smoke(ARCH).moe.top_k
    flips = np.argwhere((np.sort(jve, -1) != np.sort(tve, -1)).any(-1))
    assert len(flips) > 0
    for b, s in flips:
        p = np.sort(jprob[b, s])[::-1]
        assert p[k - 1] - p[k] < 2 * (BF16["atol"] + BF16["rtol"] * p[k - 1])
    own, _ = _embed_and_worst(jp0, jp, tp)

    monkeypatch.undo()
    monkeypatch.setattr(tt, "_policy", _policy)
    forced = _RouteLog(monkeypatch, tmoe, force=jve)
    jms, tms, jp0, jp, tp, _ = tt._run_both(ARCH, "sequential", B=B, S=S,
                                            steps=1)
    assert len(forced.calls) == 1
    np.testing.assert_array_equal(forced.calls[0][1], jve)
    tt._check_step(jms, tms, jp0, jp, tp)        # 5e-2 for every leaf
    embed, worst = _embed_and_worst(jp0, jp, tp)
    assert embed < 5e-2 and worst < 5e-2
    assert embed < own / 2


def test_comet_trains_like_sequential():
    """The reference's Pallas grouped FFN cannot be differentiated, so
    the port's comet step (the grouped FFN on chunks of the dispatch
    buffer, each chunk through ``GroupedFFN``) is held to the port's
    sequential step: the same products on views, summed alike."""
    _, jp0 = tt._reference(ARCH)
    params = tt.params_from_numpy(tt.jtree(jp0), device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in tt._train_batch(tget_smoke(ARCH).vocab, B, S, 10).items()}
    grads = {}
    for policy in ("sequential", "comet"):
        prog = tcompile(ARCH, policy=policy, smoke=True, device="cpu")
        step = prog.train_step(B, S, cfg=TrainStepConfig())
        grads[policy] = step.fn.grads(params, batch)
    (gs, (ls, cs)), (gc, (lc, cc)) = grads["sequential"], grads["comet"]
    assert float(cc) == float(cs)
    assert float(lc) == pytest.approx(float(ls), rel=1e-3)
    want = dict(tt.leaves_with_paths(gs))
    for path, g in tt.leaves_with_paths(gc):
        assert tt.rel(g, want[path]) < 2e-2, path


# ---------------------------------------------------------------------------
# the grouped FFN's gradient
# ---------------------------------------------------------------------------


def _ffn_inputs(E, N, D, Fd, dtype, seed):
    rng = np.random.default_rng(seed)

    def arr(shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)
    return (arr((E, N, D)), arr((E, D, Fd), D ** -0.5),
            arr((E, D, Fd), D ** -0.5), arr((E, Fd, D), Fd ** -0.5),
            arr((E, N, D)))


SHAPES = [(1, 1, 8, 8), (3, 5, 16, 12), (2, 7, 9, 6), (4, 13, 32, 24)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,N,D,Fd", SHAPES)
def test_grouped_ffn_backward_matches_autograd(E, N, D, Fd, dtype):
    dt = getattr(torch, dtype)
    x, w1, w3, w2, dy = _ffn_inputs(E, N, D, Fd, dt, E * N + D)
    ins = [t.clone().requires_grad_() for t in (x, w1, w3, w2)]
    y = gm.grouped_ffn(*ins)
    assert y.grad_fn is not None and "GroupedFFN" in type(y.grad_fn).__name__
    got = torch.autograd.grad(y, ins, dy)
    ref_in = [t.float().requires_grad_() for t in (x, w1, w3, w2)]
    want = torch.autograd.grad(gm.grouped_ffn_plain(*ref_in), ref_in,
                               dy.float())
    torch.testing.assert_close(y, gm.grouped_ffn_plain(x, w1, w3, w2),
                               atol=0, rtol=0)
    for a, b in zip(got, want):
        assert a.dtype == dt and a.shape == b.shape
        if dtype == "float32":
            torch.testing.assert_close(a, b, atol=1e-5 * b.abs().max(),
                                       rtol=1e-5)
        else:
            assert tt.rel(a, b) < 1e-2


@pytest.mark.parametrize("shape", [(1, 1, 7), (2, 3, 64), (3, 17, 40),
                                   (64, 5, 1408)])
def test_gate_bwd_plain_matches_autograd(shape):
    rng = np.random.default_rng(sum(shape))
    h1, h3, dh = (torch.from_numpy(rng.standard_normal(shape) * 3)
                  .to(torch.float64) for _ in range(3))
    a, b = h1.clone().requires_grad_(), h3.clone().requires_grad_()
    h = F.silu(a) * b
    da, db = torch.autograd.grad(h, (a, b), dh)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -7)):
        got = gm.grouped_ffn_gate_bwd_plain(h1.to(dtype), h3.to(dtype),
                                            dh.to(dtype))
        # the inputs' own rounding to dtype moves the exact values too
        ins = [t.to(dtype).double() for t in (h1, h3, dh)]
        a2, b2 = ins[0].clone().requires_grad_(), ins[1].clone() \
            .requires_grad_()
        h2 = F.silu(a2) * b2
        da2, db2 = torch.autograd.grad(h2, (a2, b2), ins[2])
        for out, want in zip(got, (da2, db2, h2.detach())):
            assert out.dtype == dtype
            torch.testing.assert_close(out.double(), want,
                                       atol=tol * want.abs().max() * 1e-2,
                                       rtol=tol)
    # and at f64 inputs the plain version is the gate's exact gradient
    got = gm.grouped_ffn_gate_bwd_plain(h1, h3, dh)
    torch.testing.assert_close(got[0], da.to(got[0].dtype), rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(got[1], db.to(got[1].dtype), rtol=1e-5,
                               atol=1e-6)
