"""The raw-graph frontend (``repro_torch.api.compile(Module | OpGraph)``,
``Program.plan``, ``Program.__call__``) against the JAX package's, and
the four ``examples/torch_*.py`` run to their OK line.

A two-branch toy net (a network-bound branch beside a compute-bound one
inside a ``mark``, as examples/quickstart.py's) is written in each
package; the port takes the reference's weights through
``convert.params_from_numpy`` and the same numpy-seeded input.  Under
jax 0.9 the reference's raw ``Program`` cannot be called: its
``_graph_program`` lowers with jaxpr capture, which reaches the removed
``jax.core.jaxpr_as_fun``.  So the reference side is its recipe, step by
step: ``resolve_strategy`` -> ``partition(g, policy.partition_rules(),
default_depth=2)`` -> ``record_plan`` -> ``lower(g, plan,
capture=False)``.  The port's plan must equal the recorded one (steps,
split sizes, fingerprint) and its output the reference's within f32
round-off (atol 1e-5: the same f32 products, summed in another order).

The refusals are the reference's own: each raises the same exception
type with the same message in both packages.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.core as jcore
from repro.core.module import Module as JModule, Op as JOp, Param as JParam
from repro.core.module import mark as jmark
from repro.core.strategies.dynamic import dynamic_policy as jdynamic
import repro_torch.api as tapi
import repro_torch.core as tcore
from repro_torch.convert import params_from_numpy
from repro_torch.core.module import Module, Op, Param, TensorSpec, mark
from repro_torch.core.strategies.dynamic import dynamic_policy

from test_torch_core import plan_summary

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 16

# ---------------------------------------------------------------------------
# the toy net, once in each package
# ---------------------------------------------------------------------------


class JLinear(JOp):
    resource = "compute"

    def __init__(self, d_in, d_out, name):
        super().__init__()
        self.w = JParam((d_in, d_out), jnp.float32)
        self.named(name)

    def kernel(self, p, x):
        return jnp.tanh(x @ p["w"])


class JCollective(JOp):
    resource = "network"

    def kernel(self, p, x):
        return x * 0.5


class JConcat(JOp):
    resource = "memory"

    def kernel(self, p, a, b):
        return jnp.concatenate([a, b], -1)


class JNet(JModule):
    def __init__(self, d=D):
        super().__init__()
        self.stem = JLinear(d, d, "stem")
        self.heavy = JLinear(d, d, "heavy_gemm")
        self.comm = JCollective().named("allreduce")
        self.cat = JConcat().named("concat")
        self.out = JLinear(2 * d, 8, "out")
        self.named("net")

    def forward(self, x):
        h = self.stem(x)
        with jmark("overlap_me"):
            a = self.comm(h)
            b = self.heavy(h)
        return self.out(self.cat(a, b))


class TLinear(Op):
    resource = "compute"

    def __init__(self, d_in, d_out, name):
        super().__init__()
        self.w = Param((d_in, d_out), torch.float32)
        self.named(name)

    def kernel(self, p, x):
        return torch.tanh(x @ p["w"])


class TCollective(Op):
    resource = "network"

    def kernel(self, p, x):
        return x * 0.5


class TConcat(Op):
    resource = "memory"

    def kernel(self, p, a, b):
        return torch.cat([a, b], -1)


class TNet(Module):
    def __init__(self, d=D):
        super().__init__()
        self.stem = TLinear(d, d, "stem")
        self.heavy = TLinear(d, d, "heavy_gemm")
        self.comm = TCollective().named("allreduce")
        self.cat = TConcat().named("concat")
        self.out = TLinear(2 * d, 8, "out")
        self.named("net")

    def forward(self, x):
        h = self.stem(x)
        with mark("overlap_me"):
            a = self.comm(h)
            b = self.heavy(h)
        return self.out(self.cat(a, b))


def _schedulers(core):
    """A SplitBatch-style scheduler and one with a ``SplitFunc`` partition
    rule that issues network ops first, over ``core``'s base class."""

    class SplitBatch(core.OpSchedulerBase):
        name = "splitbatch"

        def schedule(self, ctx):
            b = ctx.info.local_batch
            ctx.split([b // 2, b - b // 2])
            ctx.run_rest_sequential()

    class NetFirstSplitFunc(core.OpSchedulerBase):
        name = "netfirst"

        def partition_rules(self):
            return [core.SplitFunc(r"heavy|allreduce")]

        def schedule(self, ctx):
            while True:
                ready = ctx.get_ready_ops()
                if not ready:
                    break
                nets = [h for h in ready if ctx.resource_of(h) == "network"]
                ctx.execute(nets[0] if nets else ready[0])

    return {"splitbatch": SplitBatch, "splitfunc": NetFirstSplitFunc}


def policy_of(name, jax_side):
    core = jcore if jax_side else tcore
    if name in ("splitbatch", "splitfunc"):
        return _schedulers(core)[name]()
    if name == "dynamic_low":        # thresholds the toy batch passes
        return (jdynamic if jax_side else dynamic_policy)(
            split_tokens=4, seq_tokens=2)
    return name


POLICIES = ["sequential", "sbo", "splitbatch", "splitfunc", "dynamic",
            "dynamic_low"]
_NETS: dict = {}


def nets():
    """(JAX net, its params as numpy, port net, params, input x)."""
    if not _NETS:
        jnet = JNet()
        jp = jax.tree_util.tree_map(np.asarray,
                                    jnet.init(jax.random.PRNGKey(0)))
        x = np.random.default_rng(1).standard_normal((8, D)) \
            .astype(np.float32)
        _NETS["v"] = (jnet, jp, TNet(), params_from_numpy(jp, device="cpu"),
                      x)
    return _NETS["v"]


def reference_recipe(jnet, policy, b, phase="train"):
    """The reference's ``Program._graph_program`` step by step, lowered
    without jaxpr capture: (graph, plan, lowered)."""
    g = jcore.trace(jnet, {"x": jax.ShapeDtypeStruct((8, D), jnp.float32)})
    pol = jcore.as_policy(policy)
    info = jcore.ScheduleContext(local_batch=b, global_batch=b, phase=phase)
    sched = jcore.resolve_strategy(pol, info, graph=g)
    rules = pol.partition_rules()
    if rules:
        g = jcore.partition(g, rules, default_depth=2)
    plan = jcore.record_plan(g, sched, info)
    return g, plan, jcore.lower(g, plan, capture=False)


def port_program(policy):
    _, _, tnet, _, _ = nets()
    return tapi.compile(tnet, policy=policy_of(policy, False),
                        example_inputs={"x": TensorSpec((8, D),
                                                        torch.float32)},
                        device="cpu")


# ---------------------------------------------------------------------------
# plans and outputs against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [8, 4])
@pytest.mark.parametrize("policy", POLICIES)
def test_plan_matches_reference(policy, b):
    jnet = nets()[0]
    _, jplan, _ = reference_recipe(jnet, policy_of(policy, True), b)
    prog = port_program(policy)
    plan = prog.plan(local_batch=b)
    assert plan_summary(plan) == plan_summary(jplan)
    assert plan.split_sizes == jplan.split_sizes
    assert plan.graph_fingerprint == jplan.graph_fingerprint
    assert plan.fingerprint() == jplan.fingerprint()
    assert prog.plan(local_batch=b) is plan          # cached per bucket


@pytest.mark.parametrize("policy", POLICIES)
def test_call_matches_reference(policy):
    jnet, jp, _, tp, x = nets()
    _, jplan, jlowered = reference_recipe(jnet, policy_of(policy, True), 8)
    want = jlowered(jax.tree_util.tree_map(jnp.asarray, jp),
                    {"x": jnp.asarray(x)})
    prog = port_program(policy)
    got = prog(tp, {"x": torch.from_numpy(x)})
    assert set(got) == set(want) == {"out"}
    np.testing.assert_allclose(got["out"].numpy(), np.asarray(want["out"]),
                               atol=1e-5, rtol=0)
    # the call ran the plan prog.plan records, lowered, and verified it
    g, realizer, plan = prog._graph_program(tcore.ScheduleContext(
        local_batch=8, global_batch=8, phase="train"))
    assert realizer.lowered is not None and plan is prog.plan(8)
    assert plan_summary(plan) == plan_summary(jplan)
    assert [label for label, _ in prog.verify_reports()] == \
        ["graph/train/b8"]
    # the same bucket again: no new plan, no new lowering
    before = dict(prog.stats)
    again = prog(tp, {"x": torch.from_numpy(x)})
    assert torch.equal(again["out"], got["out"])
    assert prog.stats["misses"] == before["misses"] == 1


def test_compile_wraps_a_traced_graph_as_it_is():
    _, _, tnet, tp, x = nets()
    g = tcore.trace(tnet, {"x": TensorSpec((8, D), torch.float32)})
    prog = tapi.compile(g, policy="sbo", device="cpu")
    assert prog.graph is g and prog.model is None
    want = port_program("sequential")(tp, {"x": torch.from_numpy(x)})
    got = prog(tp, {"x": torch.from_numpy(x)})
    torch.testing.assert_close(got["out"], want["out"], atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


def test_policy_branch_rules_use_union_partition():
    """tests/test_api.py's case on the port: two buckets resolving to
    different branches (one with partition rules, one without) see the
    same partitioned graph, so the second bucket is a pure store hit."""
    class RuledSeq(tcore.OpSchedulerBase):
        name = "ruledseq"

        def partition_rules(self):
            return [tcore.SplitFunc(r"heavy")]

    _, _, tnet, _, _ = nets()
    policy = tcore.by_token_threshold([(6, "sequential")], above=RuledSeq())
    prog = tapi.compile(tnet, policy=policy, device="cpu",
                        example_inputs={"x": TensorSpec((8, D),
                                                        torch.float32)})
    ctx = tcore.ScheduleContext
    assert type(policy(ctx(local_batch=4))).__name__ == "Sequential"
    assert isinstance(policy(ctx(local_batch=8)), RuledSeq)
    prog.plan(local_batch=4)             # Sequential branch
    prog.plan(local_batch=8)             # RuledSeq branch
    st = prog.stats
    assert st["misses"] == 1 and st["hits"] == 1, st


# ---------------------------------------------------------------------------
# refusals, as the reference's
# ---------------------------------------------------------------------------


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value)


def test_compile_module_needs_example_inputs():
    jnet, _, tnet, _, _ = nets()
    jtype, jmsg = _raised(lambda: repro.api.compile(jnet))
    ttype, tmsg = _raised(lambda: tapi.compile(tnet, device="cpu"))
    assert ttype == jtype == "ValueError"
    # the same sentence, with the port's name for a ShapeDtypeStruct
    assert tmsg == jmsg.replace("ShapeDtypeStruct", "TensorSpec")


LM_ONLY = [("init_params", (0,)), ("train_step", (2, 16)),
           ("prefill", (2, 16)), ("decode_tiers", (2, 16)),
           ("serve", (None,)), ("save", ("bundle.dfpb",))]


@pytest.mark.parametrize("method,args", LM_ONLY, ids=[m for m, _ in LM_ONLY])
def test_lm_methods_refuse_a_raw_program(method, args, tmp_path):
    jnet = nets()[0]
    jprog = repro.api.compile(
        jnet, example_inputs={"x": jax.ShapeDtypeStruct((8, D),
                                                        jnp.float32)})
    tprog = port_program("sequential")
    args = tuple(str(tmp_path / a) if isinstance(a, str) else a
                 for a in args)
    jwant = _raised(lambda: getattr(jprog, method)(*args))
    assert jwant[0] == "TypeError"
    assert _raised(lambda: getattr(tprog, method)(*args)) == jwant


@pytest.mark.parametrize("method", ["plan", "__call__"])
def test_graph_methods_refuse_an_lm_program(method):
    jprog = repro.api.compile("chatglm3-6b", smoke=True)
    tprog = tapi.compile("chatglm3-6b", smoke=True, device="cpu")
    args = () if method == "plan" else ({}, {})
    jwant = _raised(lambda: getattr(jprog, method)(*args))
    assert jwant[0] == "TypeError"
    assert _raised(lambda: getattr(tprog, method)(*args)) == jwant


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------

EXAMPLES = [
    ("torch_quickstart.py", ["--device", "cpu"], "quickstart OK"),
    ("torch_custom_strategy.py", [], "custom_strategy OK"),
    # 5 requests of 4 tokens: the save/load round trip and the restarted
    # server's tokens
    ("torch_serve_batched.py", ["--device", "cpu", "--requests", "5",
                                "--max-new", "4"], "serve_batched OK"),
    # 12 steps, a crash at step 8 restored from the step-4 checkpoint
    ("torch_train_ft.py", ["--device", "cpu", "--steps", "12",
                           "--crash-at", "8"], "train_ft OK"),
]


@pytest.mark.parametrize("script,args,ok", EXAMPLES,
                         ids=[e[0] for e in EXAMPLES])
def test_example_runs_to_its_ok_line(script, args, ok):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                     script), *args],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert ok in r.stdout.splitlines()[-1], r.stdout[-2000:]
