"""The port's cost-model autotuner and overlap model against the JAX
package's.

Every case of ``tests/test_autotune.py`` runs on both packages (the
port has no train phase: where the reference tunes a train context, both
packages here tune the prefill one).  For parity the port's hardware
model is set to the JAX package's constants (``hw_like_reference``:
``repro_torch.hw`` patched from ``repro.hw``, the collective latency
passed explicitly, since it is a default argument).  Then, on the smoke
architectures, ``plan_overlap`` reports the same numbers for every
registry strategy's plan, and ``registry.tunable_candidates()``,
``AutoPolicy.identity()``, ``context_fingerprint`` and every verdict —
winner, params, ``t_model``, ``t_sequential``, ``peak_bytes``,
``scores``, ``pruned`` — are the reference's, their ``V`` records
byte-identical.  ``realizer_measurer`` times real plans through the
port's Realizer on the CPU, returns None for a plan that cannot be
lowered and lets any other error through.
"""
import types
import warnings

import pytest
import torch

import repro.api as japi
import repro.core.autotune as jauto
import repro.core.plan as jplan
import repro.core.plan_serde as jserde
import repro.core.plan_store as jstore
import repro.core.policy as jpolicy
import repro.core.scheduler as jsched
import repro.core.strategies as jstrat
import repro.core.strategies.registry as jreg
import repro.hw as jhw
import repro.roofline.overlap as joverlap
import repro_torch.api as tapi
import repro_torch.core.autotune as tauto
import repro_torch.core.plan as tplan
import repro_torch.core.plan_serde as tserde
import repro_torch.core.plan_store as tstore
import repro_torch.core.policy as tpolicy
import repro_torch.core.scheduler as tsched
import repro_torch.core.strategies as tstrat
import repro_torch.core.strategies.registry as treg
import repro_torch.hw as thw
import repro_torch.roofline.overlap as toverlap
from repro.configs import get_smoke_config as jget_smoke
from repro.core.partition import partition as jpartition
from repro.models.layers import MeshInfo as JMeshInfo
from repro.models.registry import build_model as jbuild_model
from repro_torch.configs import get_smoke_config as tget_smoke
from repro_torch.core.partition import partition as tpartition
from repro_torch.models.layers import MeshInfo as TMeshInfo
from repro_torch.models.registry import build_model as tbuild_model

ARCH = "chatglm3-6b"
SMOKE_ARCHS = ["smollm-135m", "chatglm3-6b", "deepseek-moe-16b",
               "mamba2-2.7b", "zamba2-1.2b"]
LAT = jhw.COLL_LATENCY_S            # the reference's collective latency

SIDES = {
    "jax": types.SimpleNamespace(
        name="jax", auto=jauto, plan=jplan, serde=jserde, store=jstore,
        policy=jpolicy, sched=jsched, strat=jstrat, reg=jreg,
        overlap=joverlap, api=japi, partition=jpartition,
        get_smoke=jget_smoke, build_model=jbuild_model, mesh=JMeshInfo,
        compile_kw={}),
    "torch": types.SimpleNamespace(
        name="torch", auto=tauto, plan=tplan, serde=tserde, store=tstore,
        policy=tpolicy, sched=tsched, strat=tstrat, reg=treg,
        overlap=toverlap, api=tapi, partition=tpartition,
        get_smoke=tget_smoke, build_model=tbuild_model, mesh=TMeshInfo,
        compile_kw={"device": "cpu"}),
}
both = pytest.mark.parametrize("side", list(SIDES.values()),
                               ids=list(SIDES))


@pytest.fixture
def hw_like_reference(monkeypatch):
    """The port's hardware model with the JAX package's numbers."""
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "COLL_LATENCY_S"):
        monkeypatch.setattr(thw, name, getattr(jhw, name))
    monkeypatch.setattr(thw, "NVLINK_LINKS", jhw.ICI_LINKS_PER_CHIP)
    monkeypatch.setattr(thw, "NVLINK_BW_PER_LINK", jhw.ICI_BW_PER_LINK)


def _auto(side, **kw):
    kw.setdefault("coll_latency_s", LAT)
    return side.auto.AutoPolicy(**kw)


def _model(side, arch):
    return side.build_model(side.get_smoke(arch), side.mesh(tp=1, dp=1))


def _seg_and_info(side, arch=ARCH, phase="prefill", B=8, S=32):
    model = _model(side, arch)
    segs, _ = model.build_segments(
        phase, B, 1 if phase == "decode" else S, s_max=S)
    pool = [s for s in segs if s.count > 1] or list(segs)
    seg = max(pool, key=lambda s: len(s.graph.nodes))
    info = side.sched.ScheduleContext(local_batch=B, seq_len=S, phase=phase,
                                      arch=model.cfg.name)
    return seg, info


def _tuned(side, arch=ARCH, phase="prefill", B=8, S=32, **kw):
    seg, info = _seg_and_info(side, arch, phase, B, S)
    a = _auto(side, **kw)
    a(side.policy.with_graph(info, seg.graph))
    return a, seg, info, a.lookup(info, seg.graph)


# -- registry ----------------------------------------------------------------


@both
def test_registry_names_and_resolution(side):
    names = side.reg.strategy_names()
    for want in ("sequential", "nanoflow", "dbo", "sbo", "tokenweave",
                 "comet", "flux", "dynamic", "auto", "spec_decode"):
        assert want in names
    assert names == jreg.strategy_names()
    assert side.strat.get_strategy("sbo").name == "sbo"
    assert side.strat.get_strategy("dynamic").identity()[0] == "dynamic"
    assert side.strat.get_strategy("auto").identity()[0] == "auto"
    assert set(side.strat.STRATEGIES) == set(names)
    assert side.strat.STRATEGIES["sequential"]().name == "sequential"
    assert isinstance(side.policy.as_policy("auto"), side.auto.AutoPolicy)


def test_registry_param_spaces_and_candidates_equal_the_reference():
    for name in jreg.strategy_names():
        je, te = jreg.get_entry(name), treg.get_entry(name)
        assert te.param_space == je.param_space, name
        assert te.tunable == je.tunable, name
        assert list(te.candidates()) == list(je.candidates()), name
    assert list(treg.tunable_candidates()) \
        == list(jreg.tunable_candidates())
    assert dict(treg.get_entry("spec_decode").param_space)["draft_k"] \
        == (2, 4, 8)


@both
def test_registry_unknown_name_is_typed_and_lists_choices(side):
    with pytest.raises(side.reg.UnknownStrategyError) as ei:
        side.strat.get_strategy("nope")
    assert isinstance(ei.value, KeyError)
    assert ei.value.unknown_name == "nope"
    msg = str(ei.value)
    for name in side.reg.strategy_names():
        assert name in msg
    with pytest.raises(side.reg.UnknownStrategyError):
        side.policy.as_policy("also-nope")


@both
def test_register_strategy_extends_every_consumer(side):
    class Mine(side.strat.get_strategy("sequential").__class__):
        name = "mine_t"

    side.reg.register_strategy("mine_t", Mine, {"k": (1, 2)},
                               overwrite=True)
    try:
        assert isinstance(side.reg.make_scheduler("mine_t"), Mine)
        assert side.policy.as_policy("mine_t")(
            side.sched.ScheduleContext()).name == "mine_t"
        cands = list(side.reg.tunable_candidates())
        assert ("mine_t", {"k": 1}) in cands
        assert ("mine_t", {"k": 2}) in cands
        with pytest.raises(ValueError):
            side.reg.register_strategy("mine_t", Mine)
    finally:
        side.reg._REGISTRY.pop("mine_t", None)


@both
def test_registry_path_to_dynamic_is_silent(side):
    # the JAX package's deprecated DynamicScheduler shim has no port: the
    # registry path is the only one, and it warns about nothing
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        sched = side.strat.get_strategy("dynamic", split_tokens=64)
    assert not [w for w in rec if issubclass(w.category,
                                             DeprecationWarning)]
    assert sched.identity()[0] == "dynamic"
    assert sched.identity() != side.strat.get_strategy("dynamic").identity()


# -- verdict determinism -----------------------------------------------------


@both
def test_verdict_is_deterministic(side, hw_like_reference):
    seg, info = _seg_and_info(side)
    fp = side.auto.context_fingerprint
    assert fp(info, seg.graph) == fp(info, seg.graph)
    a1, a2 = _auto(side), _auto(side)
    s1 = a1(side.policy.with_graph(info, seg.graph))
    s2 = a2(side.policy.with_graph(info, seg.graph))
    v1, v2 = a1.lookup(info, seg.graph), a2.lookup(info, seg.graph)
    assert (v1.winner, v1.params, v1.scores, v1.t_model) \
        == (v2.winner, v2.params, v2.scores, v2.t_model)
    ident = side.plan.scheduler_identity
    assert ident(s1) == ident(s2)
    a1(side.policy.with_graph(info, seg.graph))
    assert a1.retunes == 1
    assert v1.t_model <= v1.t_sequential * (1 + 1e-9)


@both
def test_verdict_payload_roundtrip_and_line_format(side, hw_like_reference):
    _, _, _, v = _tuned(side)
    TV = side.auto.TuningVerdict
    assert TV.from_payload(v.to_payload()) == v
    fp, payload = side.serde.split_verdict_line(
        side.serde.verdict_line(v.context_fp, v.to_payload()))
    assert fp == v.context_fp
    assert TV.from_payload(payload) == v


@both
def test_auto_policy_identity_salts_and_is_stable(side):
    salt = side.plan.strategy_salt
    s1 = salt(_auto(side))
    assert s1 == salt(_auto(side))
    assert s1.startswith("auto:")
    assert s1 != salt(_auto(side, bw_scale=0.125))
    assert s1 != salt(_auto(side, coll_latency_s=1e-3))
    assert s1 == salt(_auto(side, measure_top_k=3))


def test_auto_policy_identity_and_salt_equal_the_reference():
    assert _auto(SIDES["torch"]).identity() \
        == _auto(SIDES["jax"]).identity()
    assert tplan.strategy_salt(_auto(SIDES["torch"])) \
        == jplan.strategy_salt(_auto(SIDES["jax"]))


# -- persistence: restart inherits every decision ----------------------------


@both
def test_verdict_persistence_zero_retunes_across_restart(side, tmp_path,
                                                         hw_like_reference):
    seg, info = _seg_and_info(side)
    with_graph = side.policy.with_graph
    path = str(tmp_path / "plans.dfps")
    store = side.store.PlanStore()
    a = _auto(side)
    a.bind_store(store)
    a(with_graph(info, seg.graph))
    assert a.retunes == 1
    assert store.stats["verdicts_put"] == 1
    assert store.dirty
    store.save(path)

    store2 = side.store.PlanStore()
    store2.load(path)
    a2 = _auto(side)
    a2.bind_store(store2)
    sched = a2(with_graph(info, seg.graph))
    assert a2.retunes == 0
    assert store2.stats["verdict_hits"] == 1
    v, v2 = a.lookup(info, seg.graph), a2.lookup(info, seg.graph)
    assert v2 == v
    ident = side.plan.scheduler_identity
    assert ident(sched) == ident(a._scheduler_of(v.context_fp, v))
    p2 = str(tmp_path / "plans2.dfps")
    store2.save(p2)
    store3 = side.store.PlanStore()
    store3.load(p2)
    assert store3.get_verdict(v.context_fp) is not None


def test_persisted_verdict_records_are_the_references_bytes(
        tmp_path, hw_like_reference):
    lines = {}
    for side in SIDES.values():
        seg, info = _seg_and_info(side)
        store = side.store.PlanStore()
        a = _auto(side)
        a.bind_store(store)
        a(side.policy.with_graph(info, seg.graph))
        path = tmp_path / f"{side.name}.dfps"
        store.save(str(path))
        lines[side.name] = [ln for ln in path.read_text().splitlines()
                            if ln.startswith("V ")]
    assert lines["torch"] and lines["torch"] == lines["jax"]


@both
def test_corrupt_verdict_falls_back_to_cold_retune(side, tmp_path,
                                                   hw_like_reference):
    seg, info = _seg_and_info(side)
    with_graph = side.policy.with_graph
    path = str(tmp_path / "plans.dfps")
    store = side.store.PlanStore()
    a = _auto(side)
    a.bind_store(store)
    a(with_graph(info, seg.graph))
    store.save(path)
    with open(path) as f:
        lines = f.read().splitlines()
    with open(path, "w") as f:
        for ln in lines:
            if ln.startswith("V "):
                ln = ln[:-3] + "xxx"
            f.write(ln + "\n")
    store2 = side.store.PlanStore()
    store2.load(path)
    assert store2.stats["verdict_rejected"] >= 1
    a2 = _auto(side)
    a2.bind_store(store2)
    a2(with_graph(info, seg.graph))
    assert a2.retunes == 1
    assert a2.lookup(info, seg.graph).winner \
        == a.lookup(info, seg.graph).winner
    store3 = side.store.PlanStore()
    fp = a.lookup(info, seg.graph).context_fp
    store3.put_verdict(fp, {"version": 999, "garbage": True})
    a3 = _auto(side)
    a3.bind_store(store3)
    a3(with_graph(info, seg.graph))
    assert a3.retunes == 1


# -- parity: auto never loses to the hand-written policy ---------------------


@both
@pytest.mark.parametrize("arch", ("chatglm3-6b", "deepseek-moe-16b"))
@pytest.mark.parametrize("phase,B,S", (("prefill", 8, 64),
                                       ("decode", 2, 32)))
def test_auto_never_loses_to_dynamic_policy(side, arch, phase, B, S,
                                            hw_like_reference):
    from importlib import import_module
    dynamic_policy = import_module(
        f"{side.auto.__name__.split('.')[0]}.core.strategies.dynamic"
    ).dynamic_policy
    seg, info = _seg_and_info(side, arch, phase, B, S)
    auto = _auto(side)
    auto(side.policy.with_graph(info, seg.graph))
    v = auto.lookup(info, seg.graph)
    g = auto._tuning_graph(seg.graph)
    dyn = side.policy.resolve_strategy(dynamic_policy(), info, graph=g)
    plan = side.sched.record_plan(g, dyn, info)
    rep, _ = auto._score(g, plan, auto.tp)
    assert v.t_model <= rep.t_overlapped * (1 + 1e-9), (
        f"auto chose {v.winner} ({v.t_model}) but dynamic's "
        f"{dyn.name} is faster ({rep.t_overlapped})")


@both
def test_exhaustive_order_replays_its_best_order(side, hw_like_reference):
    seg, info = _seg_and_info(side)
    auto = _auto(side)
    g = auto._tuning_graph(seg.graph)
    ex = side.auto.ExhaustiveOrder(max_ops=len(g.nodes), max_orders=64,
                                   coll_latency_s=LAT)
    best = ex.best_order(g)
    assert best is not None
    plan = side.sched.record_plan(g, ex, info)
    assert [s.handles[0].oid for s in plan.steps] == list(best[0])
    t_topo = side.overlap.plan_overlap(
        g, side.auto._order_plan(g, tuple(g.topo_order())), tp=ex.tp,
        coll_latency_s=LAT).t_overlapped
    assert best[1] <= t_topo * (1 + 1e-9)
    tiny = side.auto.ExhaustiveOrder(max_ops=1)
    assert tiny.best_order(g) is None
    plan2 = side.sched.record_plan(g, tiny, info)
    assert len(plan2.steps) == len(g.nodes)


@both
def test_pareto_front(side):
    pts = [("a", 1.0, 100), ("b", 2.0, 50), ("c", 2.0, 200),
           ("d", 0.5, 400)]
    assert side.auto.pareto_front(pts) == [0, 1, 3]


# -- end to end through the facade -------------------------------------------


@both
def test_compile_policy_auto_runs_and_explains(side, tmp_path):
    prog = side.api.compile(ARCH, policy="auto", smoke=True,
                            plan_store_path=str(tmp_path / "p.dfps"),
                            **side.compile_kw)
    assert isinstance(prog.policy, side.auto.AutoPolicy)
    assert prog.policy._store is prog.store
    prog.prefill(global_batch=1, seq_len=16)
    assert prog.policy.retunes >= 1
    rows = prog.explain()
    assert rows and all("winner" in r for r in rows)
    assert all(r["speedup"] >= 1.0 - 1e-9 for r in rows)
    prog2 = side.api.compile(ARCH, policy="sequential", smoke=True,
                             **side.compile_kw)
    (row,) = prog2.explain()
    assert row["policy"] == "sequential"


@both
def test_program_save_load_roundtrips_verdicts(side, tmp_path):
    prog = side.api.compile(ARCH, policy="auto", smoke=True,
                            **side.compile_kw)
    prog.prefill(global_batch=1, seq_len=16)
    assert prog.policy.retunes >= 1
    assert prog.store.verdict_count >= 1
    bundle = str(tmp_path / "prog.dfpb")
    prog.save(bundle)

    prog2 = side.api.Program.load(bundle)
    assert isinstance(prog2.policy, side.auto.AutoPolicy)
    assert prog2.store.verdict_count == prog.store.verdict_count
    prog2.prefill(global_batch=1, seq_len=16)
    assert prog2.policy.retunes == 0, \
        "restart re-tuned despite persisted verdicts"
    assert prog2.stats["misses"] == 0, \
        f"loaded program re-lowered: {prog2.stats}"
    assert prog2.explain() == prog.explain()


def test_measuring_auto_policy_saves_as_auto(tmp_path):
    """An AutoPolicy that differs from ``policy="auto"`` only in its
    measurement knobs saves under the name, and loads with its
    verdicts."""
    a = tauto.AutoPolicy(measure_top_k=3, measurer=lambda *a: None)
    prog = tapi.compile(ARCH, policy=a, smoke=True, device="cpu")
    assert prog.policy_spec == "auto"
    prog.prefill(global_batch=1, seq_len=16)
    bundle = str(tmp_path / "prog.dfpb")
    prog.save(bundle)
    prog2 = tapi.Program.load(bundle)
    prog2.prefill(global_batch=1, seq_len=16)
    assert prog2.policy.retunes == 0
    opaque = tauto.AutoPolicy(bw_scale=0.5)
    assert tapi.compile(ARCH, policy=opaque, smoke=True,
                        device="cpu").policy_spec is None


@both
def test_observe_feeds_measured_time_into_verdicts(side, hw_like_reference):
    seg, info = _seg_and_info(side)
    store = side.store.PlanStore()
    a = _auto(side)
    a.bind_store(store)
    a(side.policy.with_graph(info, seg.graph))
    v0 = a.lookup(info, seg.graph)
    assert v0.measured_s == 0.0
    kw = dict(phase=info.phase, arch=info.arch,
              local_batch=info.local_batch, seq_len=info.seq_len)
    a.observe(seconds=1e-3, **kw)
    assert a.lookup(info, seg.graph).measured_s == pytest.approx(1e-3)
    a.observe(seconds=2e-3, **kw)
    assert a.lookup(info, seg.graph).measured_s \
        == pytest.approx(0.8 * 1e-3 + 0.2 * 2e-3)
    assert store.get_verdict(v0.context_fp)["measured_s"] > 0


@both
def test_coll_latency_parameter_threads_from_hw(side):
    hw = thw if side.name == "torch" else jhw
    overlap = side.overlap
    assert overlap.COLL_LATENCY_S == hw.COLL_LATENCY_S
    seg, info = _seg_and_info(side, "deepseek-moe-16b")
    auto = side.auto.AutoPolicy()
    g = auto._tuning_graph(seg.graph)
    plan = side.sched.record_plan(g, side.strat.get_strategy("sequential"),
                                  info)
    rep0 = overlap.plan_overlap(g, plan, tp=16)
    rep1 = overlap.plan_overlap(g, plan, tp=16,
                                coll_latency_s=hw.COLL_LATENCY_S * 100)
    if rep0.coll_total > 0:
        assert rep1.t_sequential > rep0.t_sequential
    else:
        assert rep1.t_sequential == rep0.t_sequential
    slow = side.auto.AutoPolicy(coll_latency_s=hw.COLL_LATENCY_S * 100)
    rep_fast, _ = auto._score(g, plan, 16)
    rep_slow, _ = slow._score(g, plan, 16)
    assert rep_slow.t_sequential >= rep_fast.t_sequential


def test_h100_model_is_the_ports_default():
    """Unpatched, the port ranks with the H100's figures, not a TPU's."""
    assert thw.PEAK_FLOPS_BF16 == 989e12 and thw.HBM_BW == 3.35e12
    assert thw.NVLINK_LINKS == 18
    assert not any(name.startswith(("ICI_", "VMEM", "MXU"))
                   for name in vars(thw))
    assert tauto.AutoPolicy().coll_latency_s == thw.COLL_LATENCY_S


# -- the overlap model and the verdicts against the reference ----------------


def _contexts(side, arch):
    """(phase, segment, info) for the prefill and decode segments."""
    model = _model(side, arch)
    out = []
    for phase, B, S in (("prefill", 8, 64), ("decode", 2, 32)):
        segs, _ = model.build_segments(
            phase, B, 1 if phase == "decode" else S, s_max=S)
        info = side.sched.ScheduleContext(local_batch=B, seq_len=S,
                                          phase=phase, arch=model.cfg.name)
        out.extend((phase, seg, info) for seg in segs)
    return out


def _reports(side, arch):
    out = {}
    for phase, seg, info in _contexts(side, arch):
        for name in side.reg.strategy_names():
            # auto's latency is a default argument, bound at import
            kw = {"coll_latency_s": LAT} if name == "auto" else {}
            sched = side.reg.make_scheduler(name, **kw)
            g = side.partition(seg.graph, sched.partition_rules(),
                               default_depth=2)
            plan = side.sched.record_plan(g, sched, info)
            for tp in (1, 16):
                rep = side.overlap.plan_overlap(
                    g, plan, tp=tp, coll_latency_s=LAT,
                    extra_weight_read_bytes=side.overlap
                    .split_weight_penalty(g, plan.num_mb))
                out[(phase, seg.key, name, tp)] = (
                    rep.t_sequential, rep.t_overlapped, rep.coll_total,
                    rep.coll_exposed)
    return out


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_plan_overlap_equals_the_reference_on_every_strategy(
        arch, hw_like_reference):
    got, want = _reports(SIDES["torch"], arch), _reports(SIDES["jax"], arch)
    assert got.keys() == want.keys()
    assert len(got) >= 2 * 3 * len(jreg.strategy_names()) * 2
    for key in got:
        assert got[key] == want[key], key


def _verdicts(side, arch):
    out = {}
    for phase, seg, info in _contexts(side, arch):
        a = _auto(side)
        a(side.policy.with_graph(info, seg.graph))
        v = a.lookup(info, seg.graph)
        fp = side.auto.context_fingerprint(info, seg.graph)
        out[(phase, seg.key)] = (fp, v, side.serde.verdict_line(
            v.context_fp, v.to_payload()))
    return out


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_verdicts_equal_the_reference(arch, hw_like_reference):
    got, want = _verdicts(SIDES["torch"], arch), _verdicts(SIDES["jax"],
                                                           arch)
    assert got.keys() == want.keys()
    for key, (fp, v, line) in got.items():
        jfp, jv, jline = want[key]
        assert fp == jfp, key
        for field in ("winner", "params", "t_model", "t_sequential",
                      "peak_bytes", "scores", "pruned", "identity"):
            assert getattr(v, field) == getattr(jv, field), (key, field)
        assert line == jline, key


# -- measured refinement -----------------------------------------------------


def _layer_inputs(prog, B=2, S=16):
    from repro_torch.models.base import _layer_slice
    segs, _ = prog.model.build_segments("prefill", B, S, s_max=S)
    seg = next(s for s in segs if s.count > 1)
    params = prog.init_params(0, device="cpu")
    g = torch.Generator().manual_seed(0)
    inputs = {"x": (torch.randn((B, S, prog.model.cfg.d_model), generator=g)
                    .to(torch.bfloat16)),
              "positions": torch.arange(S, dtype=torch.int32).expand(B, S)}
    return seg, _layer_slice(params[seg.name], 0), inputs


def test_realizer_measurer_times_real_plans_on_the_cpu():
    prog = tapi.compile(ARCH, smoke=True, device="cpu")
    seg, params, inputs = _layer_inputs(prog)
    calls = []
    measure = tauto.realizer_measurer(params, inputs, repeats=2)

    def measurer(info, graph, plan):
        calls.append(measure(info, graph, plan))
        return calls[-1]

    a = tauto.AutoPolicy(measure_top_k=2, measurer=measurer)
    info = tsched.ScheduleContext(local_batch=2, seq_len=16, phase="prefill",
                                  arch=prog.model.cfg.name)
    a(tpolicy.with_graph(info, seg.graph))
    v = a.lookup(info, seg.graph)
    assert len(calls) == 2 and all(t is not None and t > 0 for t in calls)
    # as in the reference, measured seconds replace the model's for the
    # refined candidates and the sort then mixes the two; the winner's
    # seconds are the verdict's measured seconds either way
    assert v.provenance == "measured"
    assert v.measured_s == v.t_model > 0
    # params and inputs may be functions of the context and graph
    lazy = tauto.realizer_measurer(lambda i, g: params, lambda i, g: inputs)
    g = a._tuning_graph(seg.graph)
    plan = tsched.record_plan(g, treg.make_scheduler("sequential"), info)
    assert lazy(info, g, plan) > 0


def test_realizer_measurer_skips_unrealizable_plans_and_raises_real_errors():
    prog = tapi.compile(ARCH, smoke=True, device="cpu")
    seg, params, inputs = _layer_inputs(prog)
    info = tsched.ScheduleContext(local_batch=2, seq_len=16, phase="prefill",
                                  arch=prog.model.cfg.name)
    g = tauto.AutoPolicy()._tuning_graph(seg.graph)
    plan = tsched.record_plan(g, treg.make_scheduler("sequential"), info)
    # a plan recorded for another graph cannot be lowered for this one
    foreign = tplan.ExecutionPlan(plan.steps, plan.split_sizes, "0" * 16)
    measure = tauto.realizer_measurer(params, inputs)
    assert measure(info, g, foreign) is None
    bad = tauto.realizer_measurer({}, inputs)   # no params: a real error
    with pytest.raises(KeyError):
        bad(info, g, plan)
