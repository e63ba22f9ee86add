"""The port's plan verifier and linter against the JAX package's.

Every seeded mutation of ``tests/test_verify.py`` (VFY001–VFY009,
VFY101–VFY105, VFY201–VFY203) runs on both packages — the same module,
traced by each package's ``trace``, the same schedule, the same mutation
— and the port must report the same diagnostics, compared by severity,
code, step and op provenance, besides the reference's own assertions.
Then, for every strategy of the port's registry on each smoke arch and
both phases, the plans as recorded and under three seeded mutations give
the same diagnostics on both packages (``verify(..., lint=True)``), and
the lint CLI (``python -m repro_torch.lint``) runs clean.
"""
import dataclasses
import importlib
import types
import warnings

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.configs import get_smoke_config as jget_smoke
from repro.core.strategies import registry as jregistry
from repro.models.layers import MeshInfo as JMeshInfo
from repro.models.registry import build_model as jbuild_model
from repro_torch.configs import get_smoke_config as tget_smoke
from repro_torch.core.strategies import registry as tregistry
from repro_torch.models.layers import MeshInfo as TMeshInfo
from repro_torch.models.registry import build_model as tbuild_model

D = 8


def _side(name):
    if name == "jax":
        core, pkg = jcore, "repro"
        def spec(shape):
            return jax.ShapeDtypeStruct(shape, jnp.float32)
        f32, tanh = jnp.float32, jnp.tanh
        def lower(g, p):
            return jcore.lower(g, p, capture=False)
    else:
        core, pkg = tcore, "repro_torch"
        def spec(shape):
            return tcore.TensorSpec(shape, torch.float32)
        f32, tanh = torch.float32, torch.tanh
        lower = tcore.lower
    side = types.SimpleNamespace(
        name=name, core=core, spec=spec, f32=f32, tanh=tanh, lower=lower,
        verify=importlib.import_module(f"{pkg}.core.verify"),
        plan=importlib.import_module(f"{pkg}.core.plan"),
        graph=importlib.import_module(f"{pkg}.core.graph"),
        module=importlib.import_module(f"{pkg}.core.module"),
        scheduler=importlib.import_module(f"{pkg}.core.scheduler"),
        lint=importlib.import_module(f"{pkg}.lint"))
    side.cls = _classes(side)
    return side


def _classes(side):
    """The modules and schedulers of tests/test_verify.py, built on one
    package's base classes (same class names, so the same op names)."""
    m, s = side.module, side.scheduler
    OpHandle = side.plan.OpHandle

    class Lin(m.Op):
        def __init__(self, name):
            super().__init__()
            self.w = m.Param((D, D), side.f32)
            self.named(name)

        def kernel(self, p, x):
            return side.tanh(x @ p["w"])

    class Chain(m.Module):
        def __init__(self, n=4):
            super().__init__()
            self.n = n
            for i in range(n):
                setattr(self, f"l{i}", Lin(f"l{i}"))

        def forward(self, x):
            for i in range(self.n):
                x = getattr(self, f"l{i}")(x)
            return x

    class Dead(m.Module):
        def __init__(self):
            super().__init__()
            self.live = Lin("live")
            self.dead = Lin("dead")

        def forward(self, x):
            self.dead(x)                       # traced, never consumed
            return self.live(x)

    class TwoColl(m.Module):
        def __init__(self):
            super().__init__()
            self.n1 = m.FnOp(lambda x: x * 1.0, "coll1", resource="network")
            self.n2 = m.FnOp(lambda x: x * 2.0, "coll2", resource="network")
            self.c1 = Lin("c1")
            self.c2 = Lin("c2")
            self.join = m.FnOp(lambda a, b: a + b, "join")

        def forward(self, x):
            return self.join(self.c1(self.n1(x)), self.c2(self.n2(x)))

    class OneColl(m.Module):
        def __init__(self):
            super().__init__()
            self.coll = m.FnOp(lambda x: x * 1.0, "coll", resource="network")
            self.use = Lin("use")
            self.side = Lin("side")
            self.join = m.FnOp(lambda a, b: a + b, "join")

        def forward(self, x):
            return self.join(self.use(self.coll(x)), self.side(x))

    class PerPart(s.OpSchedulerBase):
        def __init__(self, sizes=(4, 4)):
            self.sizes = sizes

        def schedule(self, ctx):
            ctx.split(list(self.sizes))
            for oid in ctx.graph.topo_order():
                for p in range(len(self.sizes)):
                    ctx.execute(OpHandle(oid, p, ctx.graph.nodes[oid].name))

    class SplitThenMerge(s.OpSchedulerBase):
        def __init__(self, sizes=(4, 4)):
            self.sizes = sizes

        def schedule(self, ctx):
            ctx.split(list(self.sizes))
            oids = ctx.graph.topo_order()
            for oid in oids[:-1]:
                for p in range(len(self.sizes)):
                    ctx.execute(OpHandle(oid, p, ""))
            ctx.execute(tuple(OpHandle(oids[-1], p, "")
                              for p in range(len(self.sizes))))

    class MergeFirst(s.OpSchedulerBase):
        def schedule(self, ctx):
            ctx.split([4, 4])
            oids = ctx.graph.topo_order()
            ctx.execute(tuple(OpHandle(oids[0], p, "") for p in (0, 1)))
            for oid in oids[1:]:
                for p in (0, 1):
                    ctx.execute(OpHandle(oid, p, ""))

    class Ordered(s.OpSchedulerBase):
        def __init__(self, names):
            self.names = names

        def schedule(self, ctx):
            byname = {ctx.graph.nodes[o].name.split("/")[-1]: o
                      for o in ctx.graph.topo_order()}
            for nm in self.names:
                ctx.execute(OpHandle(byname[nm], side.graph.FULL, nm))

    return types.SimpleNamespace(**{c.__name__: c for c in (
        Lin, Chain, Dead, TwoColl, OneColl, PerPart, SplitThenMerge,
        MergeFirst, Ordered)})


SIDES = {name: _side(name) for name in ("jax", "torch")}


def both(scenario):
    """``scenario(side)`` on both packages; returns the port's result
    after requiring that both returned equal keyed diagnostics."""
    out = {name: scenario(side) for name, side in SIDES.items()}
    assert keyed(out["torch"]) == keyed(out["jax"])
    return out["torch"]


def keyed(diags):
    return [(d.severity, d.code, d.step_index,
             tuple((h.oid, h.mb, h.name) for h in d.op_handles))
            for d in diags]


def _setup(side, n=4, sizes=(4, 4), B=8, sched=None):
    g = side.core.trace(side.cls.Chain(n), {"x": side.spec((B, D))})
    plan = side.core.record_plan(g, sched or side.cls.PerPart(sizes),
                                 side.core.ScheduleContext(local_batch=B))
    return g, plan


def _replan(side, plan, steps=None, sizes=None):
    return side.plan.ExecutionPlan(
        list(plan.steps) if steps is None else steps,
        plan.split_sizes if sizes is None else sizes,
        plan.graph_fingerprint)


def _codes(diags):
    return {d.code for d in diags}


# ---------------------------------------------------------------------------
# the clean baseline and the code table
# ---------------------------------------------------------------------------


def test_clean_plan_has_no_diagnostics():
    def scenario(side):
        g, plan = _setup(side)
        rep = side.verify.verify(g, plan, lowered=side.lower(g, plan),
                                 lint=True)
        assert rep.ok and not rep.diagnostics
        assert rep.pretty() == "verification clean: no diagnostics"
        rep.raise_if_errors()
        return rep.diagnostics
    both(scenario)


def test_diagnostic_str_ops_and_code_table():
    v = SIDES["torch"].verify
    OpHandle, FULL = tcore.OpHandle, tcore.FULL
    d = v.Diagnostic("error", "VFY005", -1, (OpHandle(3, 1, "moe"),),
                     "msg", "hintx")
    assert str(d).startswith("[ERROR VFY005] plan (moe[mb=1]): msg")
    assert "hint: hintx" in str(d)
    w = v.Diagnostic("warning", "VFY009", 2, (OpHandle(3, FULL, "w"),), "m")
    assert "step 2" in str(w) and w.ops == "w"
    # the JAX package's table plus VFY106, the port's stream-program
    # code (the JAX package realizes every plan on one stream)
    assert {k: c for k, c in v.CODES.items() if k != "VFY106"} \
        == SIDES["jax"].verify.CODES
    assert v.CODES["VFY106"][0] == "error"
    jd = SIDES["jax"].verify.Diagnostic(
        "error", "VFY005", -1, (jcore.OpHandle(3, 1, "moe"),), "msg",
        "hintx")
    assert str(d) == str(jd)


# ---------------------------------------------------------------------------
# layer 1: plan-level data-flow (VFY001-VFY009)
# ---------------------------------------------------------------------------


def test_vfy001_wrong_graph_and_unknown_op():
    def scenario(side):
        g, plan = _setup(side, 4)
        g2, _ = _setup(side, 6)
        diags = list(side.verify.verify_plan(g2, plan))
        d = next(d for d in diags if d.code == "VFY001")
        assert d.step_index == -1 and plan.graph_fingerprint in d.message
        ghost = side.plan.PlanStep("exec",
                                   (side.plan.OpHandle(999, 0, "ghost"),))
        more = side.verify.verify_plan(
            g, _replan(side, plan, list(plan.steps) + [ghost]))
        d = next(d for d in more if d.code == "VFY001")
        assert d.step_index == len(plan.steps)
        assert "ghost" in d.message and d.op_handles == ghost.handles
        return more
    both(scenario)


def test_vfy002_invalid_split_sizes():
    def scenario(side):
        g, plan = _setup(side)
        diags = side.verify.verify_plan(g, _replan(side, plan, sizes=(8, 0)))
        d = next(d for d in diags if d.code == "VFY002")
        assert d.step_index == -1 and "(8, 0)" in d.message
        return diags
    both(scenario)


def test_vfy003_read_before_write_with_provenance():
    def scenario(side):
        g, plan = _setup(side)
        steps = list(plan.steps)
        steps[0], steps[2] = steps[2], steps[0]    # l1[0] before l0[0]
        diags = side.verify.verify_plan(g, _replan(side, plan, steps))
        assert _codes(diags) == {"VFY003"}
        d = diags[0]
        assert d.step_index == 0 and "l1" in d.ops and "mb=0" in d.ops
        assert "producer" in d.fix_hint
        return diags
    both(scenario)


def test_vfy004_double_execution():
    def scenario(side):
        g, plan = _setup(side)
        diags = side.verify.verify_plan(
            g, _replan(side, plan, list(plan.steps) + [plan.steps[0]]))
        d = next(d for d in diags if d.code == "VFY004")
        assert d.step_index == len(plan.steps)
        assert "l0" in d.message and "l0" in d.ops
        return diags
    both(scenario)


def test_vfy005_missing_execution():
    def scenario(side):
        g, plan = _setup(side)
        diags = side.verify.verify_plan(
            g, _replan(side, plan, list(plan.steps)[:-1]))
        d = next(d for d in diags if d.code == "VFY005")
        assert d.step_index == -1 and d.ops == "Chain/l3[mb=1]"
        assert "1 op(s) missing" in d.message
        assert any(d.code == "VFY003" and d.step_index == len(plan.steps) - 1
                   for d in diags)
        return diags
    both(scenario)


def test_vfy006_merged_step_coverage_and_mixing():
    def scenario(side):
        g, plan = _setup(side, sched=side.cls.SplitThenMerge((4, 4)))
        last = plan.steps[-1]
        assert last.kind == "merged"
        partial = dataclasses.replace(last, handles=last.handles[:1])
        diags = list(side.verify.verify_plan(g, _replan(
            side, plan, list(plan.steps[:-1]) + [partial])))
        d = next(d for d in diags if d.code == "VFY006")
        assert d.step_index == len(plan.steps) - 1
        assert "micro-batches [0]" in d.message
        other = plan.steps[0].handles[0]
        mixed = dataclasses.replace(last, handles=(last.handles[0], other))
        more = side.verify.verify_plan(g, _replan(
            side, plan, list(plan.steps[:-1]) + [mixed]))
        d = next(d for d in more if d.code == "VFY006")
        assert "mixes 2 different ops" in d.message
        return diags + list(more)
    both(scenario)


def test_vfy007_merged_read_infeasible_on_virtual_batch():
    def scenario(side):
        g, plan = _setup(side, n=2, sched=side.cls.MergeFirst())
        assert side.verify.verify(g, plan).ok
        t_mid = g.nodes[g.topo_order()[0]].outputs[0]
        g.tensors[t_mid] = dataclasses.replace(
            g.tensors[t_mid], batch_dim=side.graph.VBATCH)
        diags = side.verify.verify_plan(g, plan)
        d = next(d for d in diags if d.code == "VFY007")
        assert "virtual-batch" in d.message and "Chain/l0" in d.message
        assert d.step_index == 1
        return diags
    both(scenario)


def test_vfy008_fused_group_not_convex():
    def scenario(side):
        g = side.core.trace(side.cls.Chain(3), {"x": side.spec((8, D))})
        oids = g.topo_order()

        def h(i):
            return side.plan.OpHandle(oids[i], side.graph.FULL,
                                      g.nodes[oids[i]].name)

        steps = [side.plan.PlanStep("fused", (h(0), h(2)), "bad_fuse", None),
                 side.plan.PlanStep("exec", (h(1),))]
        diags = side.verify.verify_plan(g, side.plan.ExecutionPlan(
            steps, (), side.plan.graph_fingerprint(g)))
        d = next(d for d in diags if d.code == "VFY008")
        assert d.step_index == 0 and "l0" in d.ops and "l2" in d.ops
        assert "not dependency-closed" in d.message
        return diags
    both(scenario)


def test_vfy009_dead_op_is_warning_not_error():
    def scenario(side):
        g = side.core.trace(side.cls.Dead(), {"x": side.spec((8, D))})
        plan = side.core.record_plan(g, side.cls.PerPart((4, 4)),
                                     side.core.ScheduleContext(local_batch=8))
        rep = side.verify.verify(g, plan)
        assert rep.ok
        d = next(d for d in rep.warnings if d.code == "VFY009")
        assert d.ops == "Dead/dead"
        return rep.diagnostics
    both(scenario)


# ---------------------------------------------------------------------------
# layer 2: lowered-IR memory safety (VFY101-VFY105)
# ---------------------------------------------------------------------------


def _lowered(side, sched=None):
    g, plan = _setup(side, sched=sched)
    return g, plan, side.lower(g, plan)


def _with_instr(low, i, **attrs):
    import copy
    instrs = list(low.instrs)
    mut = copy.copy(instrs[i])
    for k, v in attrs.items():
        setattr(mut, k, v)
    instrs[i] = mut
    return dataclasses.replace(low, instrs=tuple(instrs))


def _seed_use_after_death(low):
    i = max(j for j, ins in enumerate(low.instrs) if ins.reads)
    slot = low.instrs[i].reads[0][0]
    return i, _with_instr(low, i - 1,
                          frees=tuple(low.instrs[i - 1].frees) + (slot,))


def test_vfy101_invalid_slot_read():
    def scenario(side):
        g, plan, low = _lowered(side)
        i = next(j for j, ins in enumerate(low.instrs) if ins.reads)
        ins = low.instrs[i]
        bad = _with_instr(low, i, reads=((low.n_slots + 3, ins.reads[0][1]),)
                          + tuple(ins.reads[1:]))
        diags = side.verify.verify_lowered(bad)
        d = next(d for d in diags if d.code == "VFY101")
        assert d.step_index == i and "invalid slot" in d.message
        assert d.op_handles
        return diags
    both(scenario)


def test_vfy101_vfy104_use_after_death_and_premature_free():
    def scenario(side):
        g, plan, low = _lowered(side)
        i, bad = _seed_use_after_death(low)
        diags = side.verify.verify_lowered(bad)
        d104 = next(d for d in diags if d.code == "VFY104")
        assert d104.step_index == i - 1 and "premature free" in d104.message
        d101 = next(d for d in diags if d.code == "VFY101")
        assert d101.step_index == i and "use-after-death" in d101.message
        return diags
    both(scenario)


def test_vfy102_write_clobbers_live_input_slot():
    def scenario(side):
        g, plan, low = _lowered(side)
        x_slot = low.input_slots[0][1]
        (w_slot, buf0), *rest = low.instrs[0].writes
        assert w_slot != x_slot
        bad = _with_instr(low, 0, writes=((x_slot, buf0),) + tuple(rest))
        diags = side.verify.verify_lowered(bad)
        d = next(d for d in diags if d.code == "VFY102")
        assert d.step_index == 0
        assert "clobbering live" in d.message and "aliasing" in d.message
        return diags
    both(scenario)


def test_vfy103_merge_buffer_hazards():
    def scenario(side):
        g, plan, low = _lowered(side, sched=side.cls.SplitThenMerge((4, 4)))
        assert low.stats["pad_inits"] == 1
        i = next(j for j, ins in enumerate(low.instrs)
                 if any(b is not None for _s, b in ins.writes))
        writes = tuple((s, None) for s, _b in low.instrs[i].writes)
        diags = side.verify.verify_lowered(_with_instr(low, i, writes=writes))
        msgs = [d.message for d in diags if d.code == "VFY103"]
        assert any("never writes the prealloc buffer" in m for m in msgs)
        assert any("assembles merge buffer" in m for m in msgs)
        return diags
    both(scenario)


def test_vfy105_metadata_mismatch():
    def scenario(side):
        g, plan, low = _lowered(side)
        diags = side.verify.verify_lowered(
            dataclasses.replace(low, instrs=low.instrs[:-1]))
        d = next(d for d in diags if d.code == "VFY105")
        assert d.step_index == -1 and "re-lower" in d.fix_hint
        return diags
    both(scenario)


# ---------------------------------------------------------------------------
# layer 3: lint warnings (VFY201-VFY203)
# ---------------------------------------------------------------------------


def _traced_plan(side, module, order):
    g = side.core.trace(module, {"x": side.spec((8, D))})
    plan = side.core.record_plan(g, side.cls.Ordered(order),
                                 side.core.ScheduleContext(local_batch=8))
    return g, plan


def test_vfy201_two_collectives_share_one_window():
    def scenario(side):
        g, plan = _traced_plan(side, side.cls.TwoColl(),
                               ("coll1", "coll2", "c1", "c2", "join"))
        assert side.verify.verify(g, plan).ok
        diags = side.verify.lint_plan(g, plan)
        d = next(d for d in diags if d.code == "VFY201")
        assert d.step_index == 0 and "serialize" in d.message
        assert "coll1" in d.message and "coll2" in d.message
        return diags
    both(scenario)


def test_vfy202_exposed_collective_with_reorderable_work():
    def scenario(side):
        g, plan = _traced_plan(side, side.cls.OneColl(),
                               ("coll", "use", "side", "join"))
        diags = side.verify.lint_plan(g, plan)
        d = next(d for d in diags if d.code == "VFY202")
        assert d.step_index == 0
        assert "coll" in d.message and "side" in d.message
        g2, plan2 = _traced_plan(side, side.cls.OneColl(),
                                 ("coll", "side", "use", "join"))
        assert not side.verify.lint_plan(g2, plan2)
        return diags
    both(scenario)


def test_vfy203_degenerate_split():
    def scenario(side):
        g, plan = _setup(side, 2, sizes=(15, 1), B=16)
        diags = side.verify.lint_plan(g, plan)
        d = next(d for d in diags if d.code == "VFY203")
        assert d.step_index == -1 and "93%" in d.message
        return diags
    both(scenario)


# ---------------------------------------------------------------------------
# modes, enforcement, formatting
# ---------------------------------------------------------------------------


def test_strict_mode_catches_seeded_use_after_death():
    def scenario(side):
        g, plan, low = _lowered(side)
        assert side.verify.verify(g, plan, lowered=low, mode="strict").ok
        _, bad = _seed_use_after_death(low)
        assert bad.fingerprint == low.fingerprint
        with pytest.raises(side.verify.PlanVerificationError) as ei:
            side.verify.verify(g, plan, lowered=bad, mode="strict")
        assert {"VFY101", "VFY104"} <= _codes(ei.value.report.errors)
        assert "use-after-death" in str(ei.value)
        return ei.value.report.diagnostics
    both(scenario)


def test_enforce_modes():
    v = SIDES["torch"].verify
    bad = v.VerifyReport((v.Diagnostic("error", "VFY003", 0, (), "boom"),))
    v.enforce(v.VerifyReport(), "strict")
    v.enforce(bad, "off")
    v.enforce(bad, "report")
    with pytest.raises(v.PlanVerificationError, match="unit"):
        v.enforce(bad, "strict", what="unit")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        v.enforce(bad, "warn")
    assert len(rec) == 1
    assert issubclass(rec[0].category, RuntimeWarning)
    assert "VFY003" in str(rec[0].message)
    with pytest.raises(ValueError, match="verify mode"):
        v.enforce(bad, "nope")


def test_record_plan_verify_threading():
    def scenario(side):
        g = side.core.trace(side.cls.Chain(3), {"x": side.spec((8, D))})
        plan = side.core.record_plan(g, side.cls.PerPart((4, 4)),
                                     side.core.ScheduleContext(local_batch=8),
                                     verify="strict")
        rep = side.verify.verify(g, plan)
        assert rep.ok
        return rep.diagnostics
    both(scenario)


def test_schedule_incomplete_reports_count_and_caps_list():
    msgs = {}
    for name, side in SIDES.items():
        g = side.core.trace(side.cls.Chain(12), {"x": side.spec((8, D))})

        class Nothing(side.scheduler.OpSchedulerBase):
            def schedule(self, ctx):
                ctx.split([4, 4])

        with pytest.raises(side.scheduler.ScheduleError) as ei:
            side.core.record_plan(g, Nothing(),
                                  side.core.ScheduleContext(local_batch=8))
        msgs[name] = str(ei.value)
    msg = msgs["torch"]
    assert "schedule incomplete" in msg and "12 op(s) missing" in msg
    assert "… and 4 more" in msg and "l0[mb=0,1]" in msg
    assert msgs["torch"] == msgs["jax"]


def test_format_missing():
    fm = SIDES["torch"].verify.format_missing
    missing = [(f"op{i}", {0, 1}) for i in range(10)]
    s = fm(missing)
    assert s.startswith("10 op(s) missing: ")
    assert "op0[mb=0,1]" in s and "op8" not in s and "… and 2 more" in s
    assert fm([("solo", {tcore.FULL})]) == "1 op(s) missing: solo"
    assert s == SIDES["jax"].verify.format_missing(missing)


def test_lint_table_render():
    v = SIDES["torch"].verify
    d = v.Diagnostic("error", "VFY005", -1, (tcore.OpHandle(0, 1, "op"),),
                     "gone")
    rows = [("a/b", v.VerifyReport((d,))), ("c/d", v.VerifyReport())]
    s = v.lint_table(rows)
    assert "a/b" in s and "VFY005" in s and "c/d" not in s
    s2 = v.lint_table(rows, include_clean=True)
    assert "c/d" in s2 and "clean" in s2
    assert v.lint_table([("x", v.VerifyReport())]) == "all plans clean"


def test_lint_cli_smoke(capsys):
    from repro_torch.lint import lint_arch, main
    rows = lint_arch("transformer", strategies=["sequential"],
                     phases=("prefill",))
    assert rows and all(rep.ok for _, rep in rows)
    assert all(lbl.startswith("smollm-135m/sequential/prefill/")
               for lbl, _ in rows)
    assert main(["transformer", "--strategy", "sequential",
                 "--phase", "prefill"]) == 0
    assert main(["transformer", "--codes"]) == 0
    out = capsys.readouterr().out
    assert "error(s)" in out and "VFY003" in out


# ---------------------------------------------------------------------------
# every registry strategy on each smoke arch, both packages
# ---------------------------------------------------------------------------

SMOKE_ARCHS = ["smollm-135m", "chatglm3-6b", "deepseek-moe-16b",
               "mamba2-2.7b", "zamba2-1.2b"]
PHASES = ("prefill", "decode")


def _mutations(plan):
    """The plan as recorded and three seeded mutations of its steps."""
    steps = list(plan.steps)
    out = {"recorded": steps, "drop_last": steps[:-1],
           "dup_first": steps + steps[:1]}
    if len(steps) >= 3:
        out["swap"] = [steps[2], steps[1], steps[0]] + steps[3:]
    return out


def _registry_diagnostics(side, arch, names):
    if side.name == "jax":
        model = jbuild_model(jget_smoke(arch), JMeshInfo(tp=1, dp=1))
        reg = jregistry
    else:
        model = tbuild_model(tget_smoke(arch), TMeshInfo(tp=1, dp=1))
        reg = tregistry
    partition = importlib.import_module(
        f"{'repro' if side.name == 'jax' else 'repro_torch'}.core.partition"
    ).partition
    out = {}
    for phase in PHASES:
        B, S, s_max = side.lint._phase_shapes(phase, 4, 16)
        segs, _ = model.build_segments(phase, B, S, s_max=s_max)
        info = side.core.ScheduleContext(local_batch=B, global_batch=B,
                                         seq_len=S, phase=phase,
                                         arch=model.cfg.name)
        for name in names:
            for seg in segs:
                sched = reg.make_scheduler(name)
                g = partition(seg.graph, sched.partition_rules())
                plan = side.core.record_plan(g, sched, info)
                handles = [tuple((h.oid, h.mb, h.name) for h in s.handles)
                           for s in plan.steps]
                for how, steps in _mutations(plan).items():
                    rep = side.verify.verify(
                        g, _replan(side, plan, steps), lint=True)
                    out[(phase, name, seg.key, how)] = (
                        plan.split_sizes, handles if how == "recorded"
                        else None, keyed(rep.diagnostics))
    return out


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_registry_strategies_verify_like_the_reference(arch):
    """Every strategy of the port's registry (``dynamic`` included), both
    phases, every segment: the same plans, and the same diagnostics on
    each plan as recorded and under each seeded mutation."""
    names = tregistry.strategy_names()
    got = _registry_diagnostics(SIDES["torch"], arch, names)
    want = _registry_diagnostics(SIDES["jax"], arch, names)
    assert got.keys() == want.keys()
    for key in got:
        assert got[key] == want[key], key
    recorded = [v for k, v in got.items() if k[3] == "recorded"]
    assert len(recorded) >= 2 * len(names) * 2       # >= 2 segments a phase
    assert all(not any(sev == "error" for sev, *_ in diags)
               for _s, _h, diags in recorded)
    mutated = [v for k, v in got.items() if k[3] == "drop_last"]
    assert all(any(code == "VFY005" for _sev, code, *_ in diags)
               for _s, _h, diags in mutated)
