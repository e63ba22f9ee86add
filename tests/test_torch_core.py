"""The port's scheduling core (src/repro_torch/core) against the JAX
package's.

For the traced smoke graphs of smollm-135m and chatglm3-6b, in the
prefill and decode phases, under sequential / sbo / nanoflow /
tokenweave / dynamic, the port must produce the same trace (node names,
resources, edges, shapes, dtypes, batch dims, cost estimates), the same
partitioned graph, the same plan (step kinds, handles, micro-batches,
split sizes, fused groups) and the same Alg. 1 analysis (prealloc,
death sites, reads) as ``repro``.  Below that, the cases of
tests/test_algorithm1.py and tests/test_scheduler_property.py that apply
to the interpreter, on the port's own graphs.
"""
import hashlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as jcore
from repro.configs import get_smoke_config as jget_smoke
from repro.models.layers import MeshInfo as JMeshInfo
from repro.models.registry import build_model as jbuild_model
import repro_torch.core as tcore
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_smoke_config as tget_smoke
from repro_torch.core import (FULL, OpSchedulerBase, ScheduleContext,
                              partition, realize, record_plan,
                              sequential_plan, static_analysis, trace)
from repro_torch.core.analysis import BUF
from repro_torch.core.module import Module, Op, Param, TensorSpec
from repro_torch.core.plan import OpHandle, dtype_name
from repro_torch.models.layers import MeshInfo as TMeshInfo
from repro_torch.models.registry import build_model as tbuild_model

ARCHS = ["smollm-135m", "chatglm3-6b"]
POLICIES = ["sequential", "sbo", "nanoflow", "tokenweave", "dynamic"]
# (phase, local batch, seq) — contexts that reach every dynamic branch:
# sequential (< 64 tokens), SBO (< 2048), and the split/fuse branch
CONTEXTS = [("prefill", 4, 1024), ("prefill", 1, 256), ("prefill", 2, 16),
            ("decode", 4, 64)]


def _jdtype(dt):
    return np.dtype(dt).name


def graph_summary(g, dname):
    nodes = []
    for oid in g.topo_order():
        n = g.nodes[oid]
        nodes.append((oid, n.name, n.inputs, n.outputs, n.resource, n.scope,
                      tuple(sorted(n.tags)), n.param_paths, n.flops,
                      n.bytes_moved, n.param_bytes, len(n.members)))
    tensors = {t: (r.shape, dname(r.dtype), r.batch_dim, r.name)
               for t, r in g.tensors.items()}
    return (nodes, tensors, dict(g.inputs), dict(g.outputs),
            {t: sorted(c) for t, c in g.consumers.items()},
            dict(g.producer))


def normalized_fingerprint(g, dname):
    """``graph_fingerprint`` with dtypes spelled by name (the port's)."""
    h = hashlib.sha256()
    for oid in g.topo_order():
        n = g.nodes[oid]
        h.update(f"{n.name}|{n.inputs}|{n.outputs}|{n.resource}".encode())
    for name, t in sorted(g.inputs.items()):
        ref = g.tensors[t]
        h.update(f"in:{name}:{ref.shape}:{dname(ref.dtype)}".encode())
    return h.hexdigest()[:16]


def plan_summary(plan):
    return ([(s.kind, tuple((h.oid, h.mb, h.name) for h in s.handles),
              s.replace_name) for s in plan.steps], plan.split_sizes)


def analysis_summary(a):
    return (a.prealloc, a.death, a.reads, a.writes, a.buffer_bytes,
            a.n_steps)


def schedule_both(core, model, policy_name, phase, B, S):
    """``build_forward``'s recording half, for either package."""
    if phase == "decode":
        segs, _ = model.build_segments("decode", B, 1, s_max=S)
    else:
        segs, _ = model.build_segments("prefill", B, S, s_max=S)
    info = core.ScheduleContext(local_batch=B, global_batch=B, seq_len=S,
                                phase=phase, arch=model.cfg.name)
    policy = core.as_policy(policy_name)
    rules = policy.partition_rules()
    out = []
    for seg in segs:
        sched = core.resolve_strategy(policy, info, graph=seg.graph)
        g = core.partition(seg.graph, rules, default_depth=2) if rules \
            else seg.graph
        plan = core.record_plan(g, sched, info)
        out.append((seg, sched.name, g, plan, core.static_analysis(g, plan)))
    return out


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    j = jbuild_model(jget_smoke(request.param), JMeshInfo())
    t = tbuild_model(tget_smoke(request.param), TMeshInfo())
    return j, t


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match(arch):
    import dataclasses

    from repro.configs import get_config as jget
    for j, t in ((jget(arch), tget_config(arch)),
                 (jget_smoke(arch), tget_smoke(arch))):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.param_count() == t.param_count()
        assert j.hd == t.hd


@pytest.mark.parametrize("ctx", CONTEXTS, ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}")
def test_trace_matches_reference(models, ctx):
    jm, tm = models
    phase, B, S = ctx
    q = 1 if phase == "decode" else S
    jsegs, jbin = jm.build_segments(phase, B, q, s_max=S)
    tsegs, tbin = tm.build_segments(phase, B, q, s_max=S)
    assert [s.name for s in jsegs] == [s.name for s in tsegs]
    for js, ts in zip(jsegs, tsegs):
        assert (js.count, js.scan_inputs, js.scan_outputs, js.carry) == \
            (ts.count, ts.scan_inputs, ts.scan_outputs, ts.carry)
        assert graph_summary(js.graph, _jdtype) == \
            graph_summary(ts.graph, dtype_name)
        assert normalized_fingerprint(js.graph, _jdtype) == \
            tcore.graph_fingerprint(ts.graph)
    assert {k: (tuple(s.shape), _jdtype(s.dtype), b)
            for k, (s, b) in jbin.items()} == \
        {k: (s.shape, dtype_name(s.dtype), b) for k, (s, b) in tbin.items()}


def reference_chain_rule(monkeypatch):
    """Restrict the port's TokenWeave to the JAX package's chain rule:
    all-reduce chains only.  The port also fuses the reduce-scatter chains
    of sequence-parallel graphs (``test_tokenweave_fuses_sequence_parallel
    _chains``); everything else must match the reference as it is."""
    from repro_torch.core.strategies.fused import reduce_scatter_chain
    from repro_torch.core.strategies.tokenweave import TokenWeave
    port_rule = TokenWeave.triples

    def ar_only(self, g):
        return [t for t in port_rule(self, g)
                if not reduce_scatter_chain(g.nodes[t[0]])]
    monkeypatch.setattr(TokenWeave, "triples", ar_only)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("ctx", CONTEXTS, ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}")
def test_plan_and_analysis_match_reference(models, policy, ctx, monkeypatch):
    jm, tm = models
    reference_chain_rule(monkeypatch)
    jout = schedule_both(jcore, jm, policy, *ctx)
    tout = schedule_both(tcore, tm, policy, *ctx)
    for (jseg, jname, jg, jplan, jana), (tseg, tname, tg, tplan, tana) in \
            zip(jout, tout):
        assert jname == tname, (jseg.name, jname, tname)
        assert graph_summary(jg, _jdtype) == graph_summary(tg, dtype_name)
        assert plan_summary(jplan) == plan_summary(tplan)
        assert analysis_summary(jana) == analysis_summary(tana)
        assert tplan.graph_fingerprint == \
            normalized_fingerprint(jg, _jdtype)


def test_tokenweave_fuses_sequence_parallel_chains():
    """chatglm3-6b is sequence-parallel: its prefill layer's chain is
    [reduce-scatter -> add -> RMSNorm].  The port fuses it where the JAX
    package finds no chain; every other step of the plan is the
    reference's, in the reference's order."""
    jm = jbuild_model(jget_smoke("chatglm3-6b"), JMeshInfo())
    tm = tbuild_model(tget_smoke("chatglm3-6b"), TMeshInfo())
    for ctx in (("prefill", 2, 16), ("prefill", 4, 1024)):
        (_, _, _, jplan, _), = [o for o in schedule_both(
            jcore, jm, "tokenweave", *ctx) if o[0].name == "layers"]
        (_, tname, tg, tplan, tana), = [o for o in schedule_both(
            tcore, tm, "tokenweave", *ctx) if o[0].name == "layers"]
        assert tname == "tokenweave"
        fused = [s for s in tplan.steps if s.kind == "fused"]
        assert [s.replace_name for s in fused] == ["tokenweave"]
        chain = [h.name.split("/")[-1] for h in fused[0].handles]
        assert chain == ["rs_attn", "add_attn", "ln_mlp"]
        assert not [s for s in jplan.steps if s.kind == "fused"]
        rest = plan_summary(tplan)[0]
        rest = [st for st in rest if st[2] != "tokenweave"]
        want = [st for st in plan_summary(jplan)[0]
                if st[1][0][2].split("/")[-1] not in chain]
        assert rest == want
        assert tplan.split_sizes == jplan.split_sizes
        assert tana.n_steps == len(tplan.steps)


def test_dynamic_branches_on_the_reference_graphs():
    """Which strategy ``dynamic`` picks for the layer stack, by context.
    chatglm3-6b is sequence-parallel: its prefill layer's chain starts at a
    reduce-scatter, which the port's TokenWeave fuses (the JAX package's
    does not, and picks NanoFlow there); with ``seq_parallel=False`` the
    chain starts at an all-reduce."""
    import dataclasses

    def pick(cfg, phase, B, S):
        model = tbuild_model(cfg, TMeshInfo())
        return dict((s.name, n) for s, n, *_ in
                    schedule_both(tcore, model, "dynamic", phase, B, S))

    glm = tget_smoke("chatglm3-6b")
    assert pick(glm, "prefill", 2, 2048)["layers"] == "tokenweave"
    jglm = jbuild_model(jget_smoke("chatglm3-6b"), JMeshInfo())
    assert dict((s.name, n) for s, n, *_ in schedule_both(
        jcore, jglm, "dynamic", "prefill", 2, 2048))["layers"] == "nanoflow"
    glm_tp1 = dataclasses.replace(glm, seq_parallel=False)
    assert pick(glm_tp1, "prefill", 2, 2048)["layers"] == "tokenweave"
    assert pick(tget_smoke("smollm-135m"), "prefill", 2, 2048)["layers"] \
        == "tokenweave"
    assert pick(glm, "prefill", 1, 2048)["layers"] == "sbo"
    assert pick(glm, "prefill", 1, 32)["layers"] == "sequential"
    assert pick(glm, "decode", 4, 64)["layers"] == "sequential"


# ---------------------------------------------------------------------------
# Algorithm 1 (tests/test_algorithm1.py) on the port
# ---------------------------------------------------------------------------


class Lin(Op):
    def __init__(self, d_in, d_out, name, act=False):
        super().__init__()
        self.w = Param((d_in, d_out), torch.float32)
        self.act = act
        self.named(name)

    def kernel(self, p, x):
        y = x @ p["w"]
        return torch.tanh(y) if self.act else y


class Chain(Module):
    def __init__(self, d=8, n=3):
        super().__init__()
        for i in range(n):
            setattr(self, f"l{i}", Lin(d, d, f"l{i}"))
        self.n = n

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"l{i}")(x)
        return x


class SplitThenMerge(OpSchedulerBase):
    """l0 per-micro-batch, l1 merged, l2 merged — forces a prealloc
    buffer between l0 (per-part) and l1 (FULL)."""

    def schedule(self, ctx):
        ctx.split([4, 4])
        oids = ctx.graph.topo_order()
        ctx.execute(OpHandle(oids[0], 0, "l0"))
        ctx.execute(OpHandle(oids[0], 1, "l0"))
        ctx.execute(tuple(OpHandle(oids[1], i, "l1") for i in (0, 1)))
        ctx.execute(tuple(OpHandle(oids[2], i, "l2") for i in (0, 1)))


def chain_setup():
    net = Chain()
    g = trace(net, {"x": TensorSpec((8, 8), torch.float32)})
    params = net.init(0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, 8)).astype(np.float32))
    plan = record_plan(g, SplitThenMerge(), ScheduleContext(local_batch=8))
    return net, g, params, x, plan


def test_prealloc_flag_on_merge_point():
    net, g, params, x, plan = chain_setup()
    ana = static_analysis(g, plan)
    l0_out = g.nodes[g.topo_order()[0]].outputs[0]
    assert l0_out in ana.prealloc          # Alg.1 line 5
    assert len(ana.prealloc) == 1
    assert ana.buffer_bytes == 8 * 8 * 4


def test_death_sites_bound_liveness():
    net, g, params, x, plan = chain_setup()
    ana = static_analysis(g, plan)
    oids = g.topo_order()
    l0_out = g.nodes[oids[0]].outputs[0]
    l1_out = g.nodes[oids[1]].outputs[0]
    assert ana.death[(l0_out, BUF)] == 2
    assert ana.death[(l1_out, FULL)] == 3
    assert ana.ref_count((l0_out, FULL)) == 1
    produced = {(t, p) for ws in ana.writes for (t, p) in ws}
    for key in produced:
        assert key in ana.death or key[0] in ana.prealloc


def test_split_then_merge_correct_and_copy_free(monkeypatch):
    """Micro-batch reads are views of the FULL input; the merge buffer is
    written in place by each producer — no ``cat`` anywhere."""
    net, g, params, x, plan = chain_setup()
    want = net.apply(params, x)

    def no_cat(*a, **k):
        raise AssertionError("merge path must not concatenate")

    monkeypatch.setattr(torch, "cat", no_cat)
    rz = tcore.Realizer(g, plan)
    seen = []
    orig_fn = g.nodes[g.topo_order()[0]].fn

    def spy(p, xin):
        seen.append(xin)
        return orig_fn(p, xin)

    g.nodes[g.topo_order()[0]].fn = spy
    got = rz(params, {"x": x})["out"]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    base = x.untyped_storage().data_ptr()
    assert [t.untyped_storage().data_ptr() for t in seen] == [base, base]
    assert [t.data_ptr() for t in seen] == [x.data_ptr(),
                                            x[4:].data_ptr()]


# ---------------------------------------------------------------------------
# the transparency contract (tests/test_scheduler_property.py) on the port
# ---------------------------------------------------------------------------


class CatOp(Op):
    def kernel(self, p, a, b):
        return torch.cat([a, b], -1)


class DiamondExplicit(Module):
    """Two parallel branches re-merging, the concat a schedulable op."""

    def __init__(self, d=8):
        super().__init__()
        self.stem = Lin(d, d, "stem", act=True)
        self.left = Lin(d, d, "left", act=True)
        self.right = Lin(d, d, "right", act=True)
        self.cat = CatOp().named("cat")
        self.out = Lin(2 * d, 4, "out", act=True)

    def forward(self, x):
        h = self.stem(x)
        return self.out(self.cat(self.left(h), self.right(h)))


@pytest.fixture(scope="module")
def diamond():
    net = DiamondExplicit()
    g = trace(net, {"x": TensorSpec((8, 8), torch.float32)})
    params = net.init(0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, 8)).astype(np.float32))
    want = realize(g, sequential_plan(g), params, {"x": x})["out"]
    return g, params, x, want


class RandomScheduler(OpSchedulerBase):
    """Random valid schedule driven by a hypothesis-provided seed."""

    def __init__(self, seed, split_sizes, merge_prob):
        self.rng = np.random.default_rng(seed)
        self.split_sizes = split_sizes
        self.merge_prob = merge_prob

    def schedule(self, ctx):
        if self.split_sizes:
            ctx.split(self.split_sizes)
        parts = (list(range(len(self.split_sizes)))
                 if self.split_sizes else [FULL])
        while True:
            ready = [h for i in parts for h in ctx.get_ready_ops(i)]
            if not ready:
                break
            if self.split_sizes and self.rng.random() < self.merge_prob:
                by_oid = {}
                for h in ready:
                    by_oid.setdefault(h.oid, []).append(h)
                full = [v for v in by_oid.values()
                        if len(v) == len(self.split_sizes)]
                if full:
                    ctx.execute(tuple(full[self.rng.integers(len(full))]))
                    continue
            ctx.execute(ready[self.rng.integers(len(ready))])


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 10_000),
       split=st.sampled_from([(), (4, 4), (2, 6), (3, 5), (2, 2, 4)]),
       merge_prob=st.floats(0.0, 0.9))
def test_random_schedules_match_sequential(diamond, seed, split, merge_prob):
    g, params, x, want = diamond
    plan = record_plan(g, RandomScheduler(seed, split, merge_prob),
                       ScheduleContext(local_batch=8))
    got = realize(g, plan, params, {"x": x})["out"]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_random_schedules_on_partitioned_graph(diamond, seed):
    g, params, x, want = diamond
    coarse = partition(g, [tcore.SplitEveryOp()])
    plan = record_plan(coarse, RandomScheduler(seed, (4, 4), 0.4),
                       ScheduleContext(local_batch=8))
    got = realize(coarse, plan, params, {"x": x})["out"]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_dependency_violation_rejected(diamond):
    g = diamond[0]

    class BadScheduler(OpSchedulerBase):
        def schedule(self, ctx):
            ctx.execute(OpHandle(max(ctx.graph.nodes), FULL, "out"))

    with pytest.raises(RuntimeError, match="dependency violation"):
        record_plan(g, BadScheduler(), ScheduleContext(local_batch=8))


def test_incomplete_schedule_rejected(diamond):
    g = diamond[0]

    class LazyScheduler(OpSchedulerBase):
        def schedule(self, ctx):
            ctx.execute(ctx.get_ready_ops()[0])

    with pytest.raises(RuntimeError, match="incomplete"):
        record_plan(g, LazyScheduler(), ScheduleContext(local_batch=8))


def test_double_execution_rejected(diamond):
    g = diamond[0]

    class DoubleScheduler(OpSchedulerBase):
        def schedule(self, ctx):
            h = ctx.get_ready_ops()[0]
            ctx.execute(h)
            ctx.execute(h)

    with pytest.raises(RuntimeError, match="already executed"):
        record_plan(g, DoubleScheduler(), ScheduleContext(local_batch=8))


def test_lowered_realizer_is_refused_until_ported(diamond):
    g = diamond[0]
    with pytest.raises(NotImplementedError):
        tcore.Realizer(g, sequential_plan(g), lowered=True)
