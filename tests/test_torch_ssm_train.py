"""SSM and hybrid training in the port (mamba2-2.7b's and zamba2-1.2b's
smoke configs) against the JAX package, and the SSD scan's gradient.

The scan's gradient.  The reference trains through XLA's autodiff of
``SSDScanOp._ref`` (its Pallas scan has no VJP); the port's ``SSDScan``
autograd Function saves the scan's inputs and its backward runs
``ssd_scan_bwd`` (the plain version on the CPU).  ``ssd_scan_bwd_plain``
is held to torch.autograd of ``ssd_scan_plain`` (f64 within 1e-10
relative, f32 within 1e-5 relative L2 per output: the same sums in
another order; dA, a cancelling sum, within 3e-5) and to ``jax.vjp``
of the reference's ``_ref`` (f32 inputs from a seeded numpy draw,
within 1e-4 relative L2 per output, the port's gradients mapped
through the op's softplus and ``-exp(A_log)``), at odd
shapes: L not a multiple of the chunk, L below it, G = 2 and 3, b = 3,
x, B and C as column views of one activation.  The reference's
``_ref`` asserts L % Q == 0 (it does not halve the chunk), so its cases
take L a multiple of the chunk or below it.

The train phase.  ``layer_stacks("train")`` is the prefill's stack and
``make_head("train")`` the ``TrainHead``: every segment's trace and its
plan under ``sequential`` and ``nanoflow`` (and ``tokenweave`` on the
hybrid's shared block) equal the reference's.  Two train steps from the
reference's weights, on the same seeded batches, match its
``_build_train_step(..., TrainStepConfig(lowered=False))`` (jitted) under
``sequential``, ``nanoflow`` and ``dynamic`` (remat ``full``, the
default) and with remat off and ``dots``, with
tests/test_torch_train.py's ``_run_both`` / ``_check_step`` and its
limits: loss within 2e-3 relative, grad_norm within 2e-2, each leaf's
update within 5e-2 relative L2 — every leaf, the shared block's
included, holds the common limit.  The hybrid's shared block is one set
of weights used once per group: its gradient is the sum of its uses'.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.core as jcore
import repro.models.mamba2 as jm2
import repro_torch.core as tcore
import repro_torch.models.mamba2 as tm2
from repro.configs import get_smoke_config as jget_smoke
from repro.models.layers import MeshInfo as JMeshInfo
from repro.models.registry import build_model as jbuild_model
from repro_torch.api import compile as tcompile
from repro_torch.configs import get_smoke_config as tget_smoke
from repro_torch.core.plan import dtype_name
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models.base import TrainHead
from repro_torch.models.layers import MeshInfo as TMeshInfo
from repro_torch.models.registry import build_model as tbuild_model
from repro_torch.train import TrainStepConfig
from repro_torch.tree import leaves, tree_map

import test_torch_train as tt
from test_torch_core import _jdtype, graph_summary, plan_summary
from test_torch_train_kernels import ssd_inputs

ARCHS = ["mamba2-2.7b", "zamba2-1.2b"]
B, S = 4, 16
OUTS = ("dx", "ddt", "dA", "dB", "dC", "dD")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().double().numpy()
    return np.asarray(t, np.float64)


# ---------------------------------------------------------------------------
# the scan's gradient
# ---------------------------------------------------------------------------

# (b, L, H, G, N, P, chunk): Q = 32 (L not a multiple of the chunk),
# 37 (L below it), 4 (halved three times), 16 with G = 3
# dA in f32: a sum over (batch, step) of dt times a reverse cumsum that
# cancels; at these shapes autograd's and the plain backward's dA each lie
# 2e-6 to 1e-5 from the f64 value, up to 1.3e-5 from each other
F32_LIMIT = {"dA": 3e-5}
CPU_SHAPES = [(3, 96, 4, 2, 32, 16, 64), (2, 37, 4, 1, 16, 16, 128),
              (1, 60, 2, 2, 16, 8, 16), (2, 48, 6, 3, 16, 8, 16)]


@pytest.mark.parametrize("views", [True, False])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("b,L,H,G,N,P,chunk", CPU_SHAPES)
def test_ssd_scan_bwd_plain_matches_autograd(b, L, H, G, N, P, chunk, dtype,
                                             views):
    dt_ = getattr(torch, dtype)
    ins = ssd_inputs(30, b, L, H, G, N, P=P, dtype=dt_, fdtype=dt_,
                     views=views)
    leaf = [t.detach().clone().requires_grad_() for t in ins[:6]]
    y = ssd.ssd_scan_plain(*leaf, chunk=chunk)
    want = torch.autograd.grad(y, leaf, ins[6])
    got = ssd.ssd_scan_bwd_plain(*ins, chunk=chunk)
    for name, g, w in zip(OUTS, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        limit = 1e-10 if dtype == "float64" else F32_LIMIT.get(name, 1e-5)
        assert _rel(_np(g), _np(w)) < limit, (name, _rel(_np(g), _np(w)))


def _ops(G, chunk, N=16):
    """The reference's and the port's ``SSDScanOp`` of the smoke
    mamba2-2.7b with ``n_groups`` G, ``chunk`` and state N (8 heads of
    P = 8)."""
    jc, tc = jget_smoke("mamba2-2.7b"), tget_smoke("mamba2-2.7b")
    jc = dataclasses.replace(jc, ssm=dataclasses.replace(
        jc.ssm, n_groups=G, chunk=chunk, state=N))
    tc = dataclasses.replace(tc, ssm=dataclasses.replace(
        tc.ssm, n_groups=G, chunk=chunk, state=N))
    return jm2.SSDScanOp(jc, JMeshInfo()), tm2.SSDScanOp(tc, TMeshInfo())


def _op_inputs(seed, top, b, L):
    """f32 (xbc, dt raw, params, cotangent) as numpy arrays."""
    rng = np.random.default_rng(seed)
    H = top.H_loc
    f = np.float32
    return (rng.standard_normal((b, L, top.ch_loc)).astype(f),
            rng.standard_normal((b, L, H)).astype(f),
            {"A_log": np.log(rng.uniform(1, 16, H)).astype(f),
             "D": rng.normal(1, 0.5, H).astype(f),
             "dt_bias": rng.normal(0, 0.5, H).astype(f)},
            rng.standard_normal((b, L, top.d_in_loc)).astype(f))


def _reference_vjp(jop, xbc, dt, p, dy):
    """jax.vjp of the reference's ``_ref`` at (params, xbc, dt)."""
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(
            lambda pp, xx, dd: jop._ref(pp, xx, dd),
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(xbc),
            jnp.asarray(dt))
        dp, dxbc, ddt = vjp(jnp.asarray(dy))
    return ({k: np.asarray(v) for k, v in dp.items()}, np.asarray(dxbc),
            np.asarray(ddt))


def _split_xbc(top, dxbc):
    """d(xbc) as (dx, dB, dC), each flattened."""
    d, gn = top.d_in_loc, top.s.n_groups * top.s.state
    return dxbc[..., :d], dxbc[..., d:d + gn], dxbc[..., d + gn:]


# (b, L, G, chunk): L a multiple of the chunk, L below it, G = 2, b = 3
REF_SHAPES = [(3, 64, 2, 16), (2, 12, 1, 16), (1, 32, 2, 8)]


@pytest.mark.parametrize("b,L,G,chunk", REF_SHAPES)
def test_ssd_scan_bwd_plain_matches_reference_vjp(b, L, G, chunk):
    """``ssd_scan_bwd_plain`` on the op's operands, its dt and A gradients
    taken through softplus(dt + dt_bias) and -exp(A_log), against the
    reference's autodiff at the op's own inputs and parameters."""
    jop, top = _ops(G, chunk)
    xbc, dt, p, dy = _op_inputs(31, top, b, L)
    jdp, jdxbc, jddt = _reference_vjp(jop, xbc, dt, p, dy)
    xt = torch.from_numpy(xbc)
    x, Bm, Cm = top._split(xt)
    pre = torch.from_numpy(dt) + torch.from_numpy(p["dt_bias"])
    A = -torch.exp(torch.from_numpy(p["A_log"]))
    dx, ddtv, dA, dB, dC, dD = ssd.ssd_scan_bwd_plain(
        x, F.softplus(pre), A, Bm, Cm, torch.from_numpy(p["D"]),
        torch.from_numpy(dy).unflatten(-1, x.shape[-2:]), chunk=chunk)
    ddt_raw = ddtv * torch.sigmoid(pre)
    got = {"dx": dx.flatten(2), "dB": dB.flatten(2), "dC": dC.flatten(2),
           "d(dt)": ddt_raw, "dA_log": dA * A, "dD": dD,
           "d(dt_bias)": ddt_raw.sum((0, 1))}
    jx, jB, jC = _split_xbc(top, jdxbc)
    want = {"dx": jx, "dB": jB, "dC": jC, "d(dt)": jddt,
            "dA_log": jdp["A_log"], "dD": jdp["D"],
            "d(dt_bias)": jdp["dt_bias"]}
    for k in want:
        assert _rel(_np(got[k]), want[k]) < 1e-4, (k, _rel(_np(got[k]),
                                                        want[k]))


@pytest.mark.parametrize("b,L,G,chunk", REF_SHAPES)
def test_ssd_scan_op_autograd_matches_reference_vjp(b, L, G, chunk):
    """The port's ``SSDScanOp`` through torch.autograd (``SSDScan``, whose
    backward is ``ssd_scan_bwd`` and on the CPU its plain version) against
    the reference op's VJP, every input and parameter."""
    jop, top = _ops(G, chunk)
    xbc, dt, p, dy = _op_inputs(32, top, b, L)
    jdp, jdxbc, jddt = _reference_vjp(jop, xbc, dt, p, dy)
    xt = torch.from_numpy(xbc).requires_grad_()
    dtt = torch.from_numpy(dt).requires_grad_()
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    y = top.kernel(pt, xt, dtt)
    assert type(y.grad_fn).__name__ != "NoneType"
    got = torch.autograd.grad(y, [xt, dtt, *pt.values()],
                              torch.from_numpy(dy))
    want = [jdxbc, jddt, *(jdp[k] for k in pt)]
    for name, g, w in zip(["xbc", "dt", *pt], got, want):
        assert _rel(_np(g), w) < 1e-4, (name, _rel(_np(g), w))


def test_scan_takes_the_function_only_where_a_gradient_flows():
    """Grad mode on and an operand that requires a gradient: ``SSDScan``;
    otherwise (the serve path) the plain forward with no graph."""
    x, dt, A, Bm, Cm, D, _ = ssd_inputs(33, 1, 32, 2, 1, 16, P=8,
                                        dtype=torch.float32)
    y = ssd.ssd_scan(x, dt, A, Bm, Cm, D, chunk=16)
    assert y.grad_fn is None
    a = A.clone().requires_grad_()
    y = ssd.ssd_scan(x, dt, a, Bm, Cm, D, chunk=16)
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    with torch.no_grad():
        assert ssd.ssd_scan(x, dt, a, Bm, Cm, D, chunk=16).grad_fn is None
    assert torch.equal(y.detach(),
                       ssd.ssd_scan_plain(x, dt, A, Bm, Cm, D, chunk=16))


# ---------------------------------------------------------------------------
# the train phase's structure
# ---------------------------------------------------------------------------


def _names(arch):
    return (["embed", "layers", "head"] if arch == "mamba2-2.7b" else
            ["embed", "mamba_g0", "shared_attn", "mamba_g1", "shared_attn",
             "head"])


def _plan(core, seg, policy, jax_side, info):
    """``build_forward``'s recording half for one segment."""
    pol = core.as_policy(tt._policy(policy, jax_side))
    rules = pol.partition_rules()
    g = core.partition(seg.graph, rules, default_depth=2) if rules \
        else seg.graph
    sched = core.resolve_strategy(pol, info, graph=seg.graph)
    return core.record_plan(g, sched, info)


@pytest.mark.parametrize("policy", ["sequential", "nanoflow"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_phase_traces_and_plans_match_reference(arch, policy):
    """``layer_stacks("train")``: the prefill's Mamba2 stacks (and the
    shared block, uid ``shared_attn@i``), then ``TrainHead``; every
    segment's trace and plan equal the reference's, the shared block's
    under ``tokenweave`` too."""
    jm = jbuild_model(jget_smoke(arch), JMeshInfo())
    tm = tbuild_model(tget_smoke(arch), TMeshInfo())
    assert isinstance(tm.make_head("train"), TrainHead)
    jsegs, jbin = jm.build_segments("train", B, S)
    tsegs, tbin = tm.build_segments("train", B, S)
    assert [s.name for s in tsegs] == [s.name for s in jsegs] == \
        _names(arch)
    assert [s.key for s in tsegs] == [s.key for s in jsegs]
    jinfo = jcore.ScheduleContext(local_batch=B, global_batch=B, seq_len=S,
                                  phase="train")
    tinfo = tcore.ScheduleContext(local_batch=B, global_batch=B, seq_len=S,
                                  phase="train")
    for js, ts in zip(jsegs, tsegs):
        assert (js.count, js.scan_inputs, js.scan_outputs, js.carry) == \
            (ts.count, ts.scan_inputs, ts.scan_outputs, ts.carry)
        assert graph_summary(js.graph, _jdtype) == \
            graph_summary(ts.graph, dtype_name)
        policies = [policy]
        if ts.name == "shared_attn":
            policies.append("tokenweave")
        for pol in policies:
            assert plan_summary(_plan(jcore, js, pol, True, jinfo)) == \
                plan_summary(_plan(tcore, ts, pol, False, tinfo))
    assert {k: tuple(s.shape) for k, (s, _) in jbin.items()} == \
        {k: tuple(s.shape) for k, (s, _) in tbin.items()}


# ---------------------------------------------------------------------------
# the train step against the reference
# ---------------------------------------------------------------------------


def _reference_strategies(arch, policy):
    """Segment key -> the strategy the reference's policy resolves to."""
    jm, _ = tt._reference(arch)
    segs, _ = jm.build_segments("train", B, S)
    info = jcore.ScheduleContext(local_batch=B, global_batch=B, seq_len=S,
                                 phase="train", arch=jm.cfg.name)
    pol = jcore.as_policy(tt._policy(policy, True))
    return {s.key: jcore.resolve_strategy(pol, info, graph=s.graph).name
            for s in segs}


@pytest.mark.parametrize("policy", ["sequential", "nanoflow", "dynamic"])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_train_step_matches_reference(arch, policy):
    jms, tms, jp0, jp, tp, step = tt._run_both(arch, policy, B=B, S=S)
    tt._check_step(jms, tms, jp0, jp, tp)
    assert step.strategies == _reference_strategies(arch, policy)
    assert step.fn.forward.remat and step.fn.forward.remat_policy == "full"
    if policy == "dynamic":
        # the Mamba2 stacks split (NanoFlow); the shared block fuses its
        # [all-reduce -> add -> norm] chains (TokenWeave)
        want = {"mamba2-2.7b": {"layers": "nanoflow"},
                "zamba2-1.2b": {"mamba_g0": "nanoflow",
                                "shared_attn@0": "tokenweave"}}[arch]
        for k, v in want.items():
            assert step.strategies[k] == v


@pytest.mark.parametrize("remat,remat_policy", [(False, "full"),
                                                (True, "dots")])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_train_step_remat_variants_match_reference(arch, remat,
                                                       remat_policy):
    jms, tms, jp0, jp, tp, step = tt._run_both(
        arch, "nanoflow", B=B, S=S, remat=remat, remat_policy=remat_policy)
    tt._check_step(jms, tms, jp0, jp, tp)
    assert step.fn.forward.remat is remat
    assert step.fn.forward.remat_policy == remat_policy


class _PerUse(dict):
    """A params tree that hands the shared block's segment a leaf copy of
    its own at each use (``Forward`` reads ``params.get(name)`` once a
    use)."""

    def __init__(self, tree, copies):
        super().__init__(tree)
        self.copies = iter(copies)

    def get(self, key, default=None):
        if key == "shared_attn":
            return next(self.copies)
        return super().get(key, default)


def test_shared_block_gradient_is_the_sum_of_its_uses():
    prog = tcompile("zamba2-1.2b", policy="sequential", smoke=True,
                    device="cpu")
    step = prog.train_step(B, S, cfg=TrainStepConfig(remat=False))
    p = prog.init_params(0, device="cpu", phase="train")
    batch = {k: torch.from_numpy(v) for k, v in tt._train_batch(
        prog.model.cfg.vocab, B, S, 7).items()}
    grads, _ = step.fn.grads(p, batch)
    uses = prog.model.n_groups
    assert uses == 2
    copies = [tree_map(lambda t: t.detach().clone().requires_grad_(),
                       p["shared_attn"]) for _ in range(uses)]
    with torch.enable_grad():
        out = step.fn.forward(_PerUse(p, copies), batch)
        loss = out["loss_sum"].sum() / out["token_count"].sum()
        per_use = [torch.autograd.grad(loss, leaves(c), retain_graph=True)
                   for c in copies]
    for g, *use in zip(leaves(grads["shared_attn"]), *per_use):
        assert all(float(u.float().norm()) > 0 for u in use)
        assert not torch.equal(use[0], use[1])
        want = (use[0].float() + use[1].float()).to(g.dtype)
        torch.testing.assert_close(g, want, rtol=2 ** -7, atol=1e-6)
