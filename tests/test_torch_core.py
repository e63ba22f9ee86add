"""The port's scheduling core (src/repro_torch/core) against the JAX
package's.

For the traced smoke graphs of smollm-135m, chatglm3-6b,
deepseek-moe-16b, mamba2-2.7b and zamba2-1.2b, in the prefill and decode
phases, under sequential /
sbo / nanoflow / tokenweave / dbo / comet / dynamic, the port must
produce the same trace (node names,
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

ARCHS = ["smollm-135m", "chatglm3-6b", "deepseek-moe-16b", "mamba2-2.7b",
         "zamba2-1.2b"]
POLICIES = ["sequential", "sbo", "nanoflow", "tokenweave", "dbo", "comet",
            "dynamic"]
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


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("ctx", CONTEXTS, ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}")
def test_plan_and_analysis_match_reference(models, policy, ctx):
    jm, tm = models
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


def test_published_moe_config_counts():
    """deepseek-moe-16b as published: 16,375,726,080 parameters (32.75 GB
    in bf16), the JAX package's count."""
    from repro.configs import get_config as jget
    cfg = tget_config("deepseek-moe-16b")
    assert cfg.param_count()[0] == 16_375_726_080
    assert cfg.param_count() == jget("deepseek-moe-16b").param_count()
    assert cfg.smoke() == tget_smoke("deepseek-moe-16b")


@pytest.mark.parametrize("seq_parallel", [True, False],
                         ids=["published", "seq_parallel_off"])
def test_tokenweave_fused_steps_match_reference(seq_parallel):
    """TokenWeave's chain rule is the JAX package's: [all-reduce -> add ->
    RMSNorm] only.  chatglm3-6b as published is sequence-parallel, its
    prefill chains start at a reduce-scatter, and neither package fuses
    them; with ``seq_parallel=False`` both fuse the same chain."""
    import dataclasses
    jm = jbuild_model(dataclasses.replace(jget_smoke("chatglm3-6b"),
                                          seq_parallel=seq_parallel),
                      JMeshInfo())
    tm = tbuild_model(dataclasses.replace(tget_smoke("chatglm3-6b"),
                                          seq_parallel=seq_parallel),
                      TMeshInfo())
    for ctx in (("prefill", 2, 16), ("prefill", 4, 1024)):
        (_, jname, _, jplan, _), = [o for o in schedule_both(
            jcore, jm, "tokenweave", *ctx) if o[0].name == "layers"]
        (_, tname, _, tplan, _), = [o for o in schedule_both(
            tcore, tm, "tokenweave", *ctx) if o[0].name == "layers"]
        assert jname == tname == "tokenweave"

        def fused(plan):
            return [(s.replace_name,
                     [h.name.split("/")[-1] for h in s.handles])
                    for s in plan.steps if s.kind == "fused"]
        assert fused(tplan) == fused(jplan)
        want = [] if seq_parallel else \
            [("tokenweave", ["ar_attn", "add_attn", "ln_mlp"])]
        assert fused(tplan) == want
        assert plan_summary(tplan) == plan_summary(jplan)


def test_dynamic_branches_on_the_reference_graphs():
    """Which strategy ``dynamic`` picks for each layer stack, by context,
    in both packages.  chatglm3-6b as published is sequence-parallel, so
    TokenWeave finds no [all-reduce -> add -> RMSNorm] chain and a large
    prefill splits under NanoFlow; with ``seq_parallel=False`` it fuses.
    MoE layers take DBO once the step is large enough to split.  The
    Mamba2 stacks split under NanoFlow; zamba2's shared attention block
    fuses under TokenWeave."""
    import dataclasses

    def picks(core, build, cfg, phase, B, S):
        model = build(cfg, JMeshInfo() if core is jcore else TMeshInfo())
        return dict((s.key, n) for s, n, *_ in
                    schedule_both(core, model, "dynamic", phase, B, S))

    # zamba2's shared block is not sequence parallel: its [all-reduce ->
    # add -> RMSNorm] chains fuse under TokenWeave; its Mamba stacks split
    zamba_prefill = {"mamba_g0": "nanoflow", "shared_attn@0": "tokenweave",
                     "mamba_g1": "nanoflow", "shared_attn@1": "tokenweave"}
    cases = [
        ("chatglm3-6b", True, "prefill", 2, 2048, {"layers": "nanoflow"}),
        ("chatglm3-6b", True, "prefill", 4, 2048, {"layers": "nanoflow"}),
        ("chatglm3-6b", False, "prefill", 2, 2048, {"layers": "tokenweave"}),
        ("smollm-135m", False, "prefill", 2, 2048, {"layers": "tokenweave"}),
        ("chatglm3-6b", True, "prefill", 1, 2048, {"layers": "sbo"}),
        ("chatglm3-6b", True, "prefill", 1, 32, {"layers": "sequential"}),
        ("chatglm3-6b", True, "decode", 4, 64, {"layers": "sequential"}),
        ("deepseek-moe-16b", True, "prefill", 2, 2048,
         {"dense0": "nanoflow", "layers": "dbo"}),
        ("deepseek-moe-16b", True, "prefill", 4, 2048, {"layers": "dbo"}),
        ("deepseek-moe-16b", True, "prefill", 1, 2048, {"layers": "sbo"}),
        ("deepseek-moe-16b", True, "decode", 4, 4096,
         {"dense0": "sequential", "layers": "sequential"}),
        ("mamba2-2.7b", False, "prefill", 4, 2048, {"layers": "nanoflow"}),
        ("mamba2-2.7b", False, "prefill", 2, 2048, {"layers": "nanoflow"}),
        ("mamba2-2.7b", False, "prefill", 1, 2048, {"layers": "sbo"}),
        ("mamba2-2.7b", False, "decode", 4, 4096, {"layers": "sequential"}),
        ("zamba2-1.2b", False, "prefill", 4, 2048, zamba_prefill),
        ("zamba2-1.2b", False, "prefill", 2, 2048, zamba_prefill),
        ("zamba2-1.2b", False, "decode", 4, 4096,
         {"mamba_g0": "sequential", "shared_attn@0": "sequential",
          "mamba_g1": "sequential", "shared_attn@1": "sequential"}),
    ]
    for arch, sp, phase, B, S, want in cases:
        jcfg = dataclasses.replace(jget_smoke(arch), seq_parallel=sp)
        tcfg = dataclasses.replace(tget_smoke(arch), seq_parallel=sp)
        got = picks(tcore, tbuild_model, tcfg, phase, B, S)
        assert got == picks(jcore, jbuild_model, jcfg, phase, B, S), arch
        assert {k: got[k] for k in want} == want, (arch, sp, phase, B, S)


# ---------------------------------------------------------------------------
# strategy signatures (tests/test_strategies.py) on the port's MoE graph
# ---------------------------------------------------------------------------


def moe_layer_plan(strat_name, B=4, S=16, **kw):
    """The port's plan of the smoke deepseek-moe-16b MoE layer stack."""
    from repro_torch.core.strategies import get_strategy
    model = tbuild_model(tget_smoke("deepseek-moe-16b"), TMeshInfo())
    segs, _ = model.build_segments("prefill", B, S, s_max=S)
    seg = [x for x in segs if x.name == "layers"][0]
    strat = get_strategy(strat_name, **kw)
    g = seg.graph
    if strat.partition_rules():
        g = partition(g, strat.partition_rules(), default_depth=2)
    return record_plan(g, strat, ScheduleContext(
        local_batch=B, seq_len=S, phase="prefill",
        arch=model.cfg.name)), g


def test_dbo_merges_attention_splits_moe():
    plan, g = moe_layer_plan("dbo", min_tokens=1)
    assert plan.split_sizes == (2, 2)
    kinds = {}
    for st in plan.steps:
        name = g.nodes[st.handles[0].oid].name
        kinds.setdefault(st.kind, []).append(name)
    assert any("attention" in n for n in kinds.get("merged", []))
    assert any("moe" in n for n in kinds.get("exec", []))
    # canonical interleave: a dispatch of one mb precedes the other mb's
    # expert GEMM (the overlap window)
    order = [(st.kind, g.nodes[st.handles[0].oid].name, st.handles[0].mb)
             for st in plan.steps]
    disp = [i for i, (k, n, m) in enumerate(order) if "dispatch" in n]
    ffn = [i for i, (k, n, m) in enumerate(order) if "expert_ffn" in n]
    assert disp and ffn and disp[1] < ffn[-1]


def test_sbo_reorders_independent_compute_behind_network():
    plan, g = moe_layer_plan("sbo")
    res = [g.nodes[st.handles[0].oid].resource for st in plan.steps]
    # at least one network op is directly followed by a non-dependent
    # compute/memory op
    assert any(res[i] == "network" and res[i + 1] != "network"
               and not (set(g.nodes[plan.steps[i].handles[0].oid].outputs)
                        & set(g.nodes[plan.steps[i + 1].handles[0].oid]
                              .inputs))
               for i in range(len(res) - 1))


def test_comet_fuses_dispatch_gemm_combine():
    plan, g = moe_layer_plan("comet")
    fused = [st for st in plan.steps if st.kind == "fused"]
    assert len(fused) == 1 and fused[0].replace_name == "comet"
    assert [g.nodes[h.oid].name.split("/")[-1] for h in fused[0].handles] \
        == ["moe_a2a_dispatch", "expert_ffn", "moe_a2a_combine"]


def test_dynamic_picks_by_context():
    """The MoE branch of ``dynamic``, with the thresholds of
    tests/test_strategies.py (split at 64 tokens, sequential below 8)."""
    from repro_torch.core.scheduler import SchedCtx
    from repro_torch.core.strategies import get_strategy
    dyn = get_strategy("dynamic", split_tokens=64, seq_tokens=8)
    model = tbuild_model(tget_smoke("deepseek-moe-16b"), TMeshInfo())
    segs, _ = model.build_segments("prefill", 4, 16, s_max=16)
    seg = [x for x in segs if x.name == "layers"][0]
    g = partition(seg.graph, dyn.partition_rules(), default_depth=2)
    big = SchedCtx(g, ScheduleContext(local_batch=8, seq_len=512,
                                      phase="prefill"))
    assert dyn.pick(big).name == "dbo"
    small = SchedCtx(g, ScheduleContext(local_batch=1, seq_len=16,
                                        phase="decode"))
    assert dyn.pick(small).name == "sequential"
    mid = SchedCtx(g, ScheduleContext(local_batch=32, seq_len=1,
                                      phase="decode"))
    assert dyn.pick(mid).name == "sbo"


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
    params = net.init(0, device="cpu")
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
    seen = []
    orig_fn = g.nodes[g.topo_order()[0]].fn

    def spy(p, xin):
        seen.append(xin)
        return orig_fn(p, xin)

    # the lowered plan binds each op's callable when it is built
    g.nodes[g.topo_order()[0]].fn = spy
    rz = tcore.Realizer(g, plan)
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
    params = net.init(0, device="cpu")
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


def test_compile_verify_strict_raises_until_the_verifier_is_ported():
    """The verifier is ported: ``verify="strict"`` builds a clean plan and
    raises ``PlanVerificationError`` on a corrupted one (before the
    lowering could trip over it); "warn" warns on the same plan; a
    misspelt mode raises ValueError; every mode but "off" collects one
    report per segment built in ``Program.verify()``."""
    import warnings

    from repro_torch.api import compile as tcompile
    from repro_torch.core.verify import PlanVerificationError

    class Rogue(OpSchedulerBase):
        """A full schedule with its last step dropped behind the
        recorder's bookkeeping: only the verifier can see it."""
        name = "rogue"

        def schedule(self, ctx):
            ctx.run_rest_sequential()
            ctx.steps.pop()

    with pytest.raises(ValueError, match="verify"):
        tcompile("smollm-135m", smoke=True, device="cpu", verify="loud")
    for mode in ("strict", "warn", "off"):
        prog = tcompile("smollm-135m", smoke=True, device="cpu", verify=mode)
        assert prog.prefill(1, 8).fn is not None
        assert prog.verify().ok
        reports = prog.verify_reports()
        assert len(reports) == (0 if mode == "off" else 3), reports
        assert all(lbl.startswith("prefill/") for lbl, _ in reports)
    rogue = tcompile("smollm-135m", policy=Rogue(), smoke=True,
                     device="cpu", verify="strict")
    with pytest.raises(PlanVerificationError) as ei:
        rogue.prefill(1, 8)
    assert "VFY005" in str(ei.value)
    rogue = tcompile("smollm-135m", policy=Rogue(), smoke=True,
                     device="cpu", verify="warn")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        with pytest.raises(KeyError):       # the lowering still fails
            rogue.prefill(1, 8)
    assert any("VFY005" in str(w.message) for w in rec)