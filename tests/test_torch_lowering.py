"""The port's slot IR (src/repro_torch/core/lowering.py) against the JAX
package's (src/repro/core/lowering.py).

On the same traced random DAGs and the same recorded plans, the port's
``lower`` must allocate the same env slots, free them at the same death
sites, intern the same param paths and report the same stats as the
reference's ``lower(..., capture=False)``; its outputs, on the same
numpy-seeded params and inputs, must agree with the reference's within
f32 round-off (TOL) and equal the port's own interpreter
(``lowered=False``) bitwise.  Then ``specialize`` across batch sizes, the
refusals, and the smoke models' prefill and decode steps lowered against
interpreted, bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as jcore
import repro.core.module as jmodule
import repro_torch.core as tcore
import repro_torch.core.module as tmodule
from repro_torch.api import compile as tcompile
from repro_torch.convert import params_from_numpy
from repro_torch.core import (FULL, LoweringError, OpSchedulerBase,
                              ScheduleContext, lower, specialize)
from repro_torch.core.module import TensorSpec
from repro_torch.core.plan import OpHandle, structural_fingerprint
from repro_torch.models.base import build_forward

D = 8
# the two packages' f32 matmuls and tanh on the CPU (XLA against ATen):
# different summation orders and tanh approximations, a few ulps a step
TOL = dict(atol=1e-5, rtol=1e-5)
SPLITS = [(), (4, 4), (2, 6), (2, 2, 4)]


# ---------------------------------------------------------------------------
# the same networks in both packages
# ---------------------------------------------------------------------------


class _Pkg:
    """One package's module classes, tensor spec and math."""

    def __init__(self, core, module, spec, tanh, f32):
        self.core, self.module = core, module
        self.spec, self.tanh, self.f32 = spec, tanh, f32


JAX = _Pkg(jcore, jmodule, jax.ShapeDtypeStruct, jnp.tanh, jnp.float32)
TORCH = _Pkg(tcore, tmodule, TensorSpec, torch.tanh, torch.float32)


def make_lin(pkg):
    class Lin(pkg.module.Op):
        def __init__(self, d_in, d_out, name):
            super().__init__()
            self.w = pkg.module.Param((d_in, d_out), pkg.f32)
            self.named(name)

        def kernel(self, p, x):
            return pkg.tanh(x @ p["w"])
    return Lin


def make_add(pkg):
    class AddOp(pkg.module.Op):
        def kernel(self, p, a, b):
            return a + b
    return AddOp


def random_net(pkg, seed, n_ops):
    """Random DAG: chain of Lins with Add-merges of random earlier taps
    (tests/test_lowering.py's ``RandomNet``)."""
    Lin, AddOp = make_lin(pkg), make_add(pkg)

    class RandomNet(pkg.module.Module):
        def __init__(self):
            super().__init__()
            rng = np.random.default_rng(seed)
            self.wiring = []
            for i in range(n_ops):
                if i >= 2 and rng.random() < 0.4:
                    self.wiring.append(("add", int(rng.integers(i)),
                                        int(rng.integers(i))))
                    setattr(self, f"op{i}", AddOp().named(f"add{i}"))
                else:
                    self.wiring.append(("lin", int(rng.integers(i + 1)) - 1,
                                        -1))
                    setattr(self, f"op{i}", Lin(D, D, f"lin{i}"))

        def forward(self, x):
            vals = [x]
            for i, (kind, a, b) in enumerate(self.wiring):
                op = getattr(self, f"op{i}")
                if kind == "add":
                    vals.append(op(vals[a + 1], vals[b + 1]))
                else:
                    vals.append(op(vals[a + 1]))
            return vals[-1]
    return RandomNet()


def chain_net(pkg, n=10):
    Lin = make_lin(pkg)

    class Chain(pkg.module.Module):
        def __init__(self):
            super().__init__()
            for i in range(n):
                setattr(self, f"l{i}", Lin(D, D, f"l{i}"))

        def forward(self, x):
            for i in range(n):
                x = getattr(self, f"l{i}")(x)
            return x
    return Chain()


def three_lin_net(pkg):
    Lin = make_lin(pkg)

    class ThreeLin(pkg.module.Module):
        def __init__(self):
            super().__init__()
            self.a = Lin(D, D, "a")
            self.b = Lin(D, D, "b")
            self.c = Lin(D, D, "c")

        def forward(self, x):
            return self.c(self.b(self.a(x)))
    return ThreeLin()


def make_random_scheduler(pkg):
    class RandomScheduler(pkg.core.OpSchedulerBase):
        def __init__(self, seed, split_sizes, merge_prob):
            self.rng = np.random.default_rng(seed)
            self.split_sizes = split_sizes
            self.merge_prob = merge_prob

        def schedule(self, ctx):
            if self.split_sizes:
                ctx.split(self.split_sizes)
            parts = (list(range(len(self.split_sizes)))
                     if self.split_sizes else [pkg.core.FULL])
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
    return RandomScheduler


def per_part_then_merge(pkg, split):
    """Every op but the last per micro-batch, the last merged."""
    class PerPartThenMerge(pkg.core.OpSchedulerBase):
        def schedule(self, ctx):
            ctx.split(list(split))
            oids = ctx.graph.topo_order()
            parts = range(len(split))
            for oid in oids[:-1]:
                for p in parts:
                    ctx.execute(pkg.core.OpHandle(oid, p, ""))
            ctx.execute(tuple(pkg.core.OpHandle(oids[-1], p, "")
                              for p in parts))
    return PerPartThenMerge()


def fuse_first_two(pkg):
    def fused_ab(info, xin):
        pa, pb = info.params_of(0), info.params_of(1)
        return pkg.tanh(pkg.tanh(xin @ pa["w"]) @ pb["w"])

    class FuseFirstTwo(pkg.core.OpSchedulerBase):
        def schedule(self, ctx):
            oids = ctx.graph.topo_order()
            ctx.execute((pkg.core.OpHandle(oids[0], pkg.core.FULL, "a"),
                         pkg.core.OpHandle(oids[1], pkg.core.FULL, "b")),
                        replace_func=fused_ab, replace_name="fused_ab")
            ctx.run_rest_sequential()
    return FuseFirstTwo()


def params_like(jnet, seed):
    """A numpy-seeded param tree in the reference's layout."""
    rng = np.random.default_rng(seed)
    tree = jnet.init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.5).astype(np.float32),
        tree)


def build_both(make_net, make_sched, batch=8, seed=0):
    """Trace, schedule and lower the same network in both packages.
    Returns ((j graph, j plan, j params, j x), (t graph, ...))."""
    out = []
    np_params = x = None
    for pkg in (JAX, TORCH):
        net = make_net(pkg)
        g = pkg.core.trace(net, {"x": pkg.spec((batch, D), pkg.f32)})
        plan = pkg.core.record_plan(g, make_sched(pkg),
                                    pkg.core.ScheduleContext(local_batch=batch))
        if pkg is JAX:
            np_params = params_like(net, seed)
            x = np.random.default_rng(seed + 1).standard_normal(
                (batch, D)).astype(np.float32)
            out.append((g, plan, jax.tree_util.tree_map(jnp.asarray,
                                                        np_params),
                        jnp.asarray(x)))
        else:
            out.append((g, plan, params_from_numpy(np_params, device="cpu"),
                        torch.from_numpy(x)))
    return out


def instr_summary(lp):
    """What the two packages' lowerings must share: every instr's reads,
    writes (slot, merge-buffer slot, start, pad layout) and frees, its
    param references and label, and the plan-level slot maps and stats."""
    instrs = [(ins.reads,
               tuple((slot, None if buf is None else tuple(buf[:3]))
                     for slot, buf in ins.writes),
               ins.frees, ins.fused, ins.param_ix, ins.member_pairs,
               ins.fused_pairs, ins.ext_inputs, ins.ext_outputs, ins.label)
              for ins in lp.instrs]
    return (instrs, lp.input_slots, lp.output_slots, lp.param_paths,
            lp.n_slots, lp.split_sizes, lp.fingerprint,
            {k: lp.stats[k] for k in ("n_slots", "n_env_keys",
                                      "slots_reused", "pad_inits",
                                      "n_instrs")})


def check_against_reference(jside, tside):
    jg, jplan, jparams, jx = jside
    tg, tplan, tparams, tx = tside
    jl = jcore.lower(jg, jplan, capture=False)
    tl = lower(tg, tplan)
    assert instr_summary(tl) == instr_summary(jl)
    want = jl(jparams, {"x": jx})
    got = tl(tparams, {"x": tx})
    interp = tcore.Realizer(tg, tplan, lowered=False)(tparams, {"x": tx})
    assert set(got) == set(want) == set(interp)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL)
        assert torch.equal(got[k], interp[k]), f"output {k!r} diverged"
    return tl


# ---------------------------------------------------------------------------
# the slot IR against the reference's
# ---------------------------------------------------------------------------


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000),
       n_ops=st.integers(3, 8),
       split=st.sampled_from(SPLITS),
       merge_prob=st.floats(0.0, 0.9))
def test_random_graphs_and_schedules_lower_like_the_reference(
        seed, n_ops, split, merge_prob):
    sides = build_both(
        lambda pkg: random_net(pkg, seed % 50, n_ops),
        lambda pkg: make_random_scheduler(pkg)(seed, split, merge_prob),
        seed=seed % 50)
    check_against_reference(*sides)


@pytest.mark.parametrize("split", [(4, 4), (2, 6), (2, 2, 4)])
def test_slot_reuse_heavy_chain_lowers_like_the_reference(split):
    """A long per-micro-batch chain: env keys die every step, so the slot
    allocator recycles aggressively; one merge buffer at the end."""
    sides = build_both(lambda pkg: chain_net(pkg),
                       lambda pkg: per_part_then_merge(pkg, split))
    tl = check_against_reference(*sides)
    assert tl.stats["slots_reused"] > 0
    assert tl.n_slots < tl.stats["n_env_keys"]
    assert tl.stats["pad_inits"] == 1


def test_fused_step_lowers_like_the_reference():
    sides = build_both(lambda pkg: three_lin_net(pkg),
                       lambda pkg: fuse_first_two(pkg))
    tl = check_against_reference(*sides)
    assert [ins.fused for ins in tl.instrs] == [True, False]
    tg, tplan, tparams, tx = sides[1]
    net = three_lin_net(TORCH)
    np.testing.assert_allclose(tl(tparams, {"x": tx})["out"].numpy(),
                               net.apply(tparams, tx).numpy(), **TOL)


def test_merge_buffer_is_created_by_its_first_producer_without_a_fill(
        monkeypatch):
    """The first producer allocates the buffer uninitialized and writes
    its slice in place; no zero fill and no concatenation."""
    sides = build_both(lambda pkg: chain_net(pkg, 3),
                       lambda pkg: per_part_then_merge(pkg, (2, 6)))
    tg, tplan, tparams, tx = sides[1]
    tl = lower(tg, tplan)
    want = tcore.Realizer(tg, tplan, lowered=False)(tparams, {"x": tx})

    def refuse(*a, **k):
        raise AssertionError("the lowered merge path must not fill or cat")

    for name in ("zeros", "zeros_like", "cat"):
        monkeypatch.setattr(torch, name, refuse)
    assert torch.equal(tl(tparams, {"x": tx})["out"], want["out"])


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_lowering_rejects_mismatched_analysis():
    for pkg, low in ((JAX, lambda g, p, a: jcore.lower(g, p, a,
                                                      capture=False)),
                     (TORCH, lower)):
        g = pkg.core.trace(random_net(pkg, 0, 5),
                           {"x": pkg.spec((8, D), pkg.f32)})
        ctx = pkg.core.ScheduleContext(local_batch=8)
        rs = make_random_scheduler(pkg)
        plan_a = pkg.core.record_plan(g, rs(1, (4, 4), 0.3), ctx)
        plan_b = pkg.core.record_plan(g, rs(2, (2, 6), 0.6), ctx)
        assert plan_a.fingerprint() != plan_b.fingerprint()
        ana_a = pkg.core.static_analysis(g, plan_a)
        with pytest.raises(pkg.core.LoweringError, match="belongs to plan"):
            low(g, plan_b, ana_a)


def test_lowering_rejects_mismatched_graph():
    for pkg, low in ((JAX, lambda g, p: jcore.lower(g, p, capture=False)),
                     (TORCH, lower)):
        spec = {"x": pkg.spec((8, D), pkg.f32)}
        g1 = pkg.core.trace(random_net(pkg, 0, 5), spec)
        g2 = pkg.core.trace(random_net(pkg, 1, 6), spec)
        plan = pkg.core.record_plan(g1, make_random_scheduler(pkg)(1, (), 0.0),
                                    pkg.core.ScheduleContext(local_batch=8))
        with pytest.raises(pkg.core.LoweringError, match="recorded for graph"):
            low(g2, plan)


def test_lowering_rejects_an_analysis_of_another_length():
    g = tcore.trace(chain_net(TORCH, 3), {"x": TensorSpec((8, D),
                                                          torch.float32)})
    plan = tcore.sequential_plan(g)
    ana = tcore.static_analysis(g, plan)
    ana.plan_fingerprint = ""
    ana.n_steps += 1
    with pytest.raises(LoweringError, match="analysis covers"):
        lower(g, plan, ana)


# ---------------------------------------------------------------------------
# specialize: one canonical lowering, other batch sizes
# ---------------------------------------------------------------------------


def _traced(batch, split, seed=3, n_ops=7, sched_seed=11):
    net = random_net(TORCH, seed, n_ops)
    g = tcore.trace(net, {"x": TensorSpec((batch, D), torch.float32)})
    plan = tcore.record_plan(
        g, make_random_scheduler(TORCH)(sched_seed, split, 0.5),
        ScheduleContext(local_batch=batch))
    return net, g, plan


@pytest.mark.parametrize("batches", [
    ((8, (4, 4)), (4, (2, 2)), (16, (8, 8))),
    ((8, (2, 6)), (12, (3, 9))),
    ((8, (2, 2, 4)), (16, (4, 4, 8))),
    ((8, ()), (3, ())),
])
def test_specialize_across_batch_sizes_equals_a_fresh_lowering(batches):
    (b0, s0), *rest = batches
    net, g0, plan0 = _traced(b0, s0)
    canonical = lower(g0, plan0)
    params = params_from_numpy(params_like(random_net(JAX, 3, 7), 0),
                               device="cpu")
    for b, split in rest:
        _, g, plan = _traced(b, split)
        assert structural_fingerprint(g, plan) == \
            structural_fingerprint(g0, plan0)
        spec = specialize(canonical, g, plan)
        fresh = lower(g, plan)
        assert [(i.reads, i.writes, i.frees) for i in spec.instrs] == \
            [(i.reads, i.writes, i.frees) for i in fresh.instrs]
        assert spec.stats["specialized_from"] == canonical.fingerprint
        x = torch.from_numpy(np.random.default_rng(b).standard_normal(
            (b, D)).astype(np.float32))
        got = spec(params, {"x": x})["out"]
        assert torch.equal(got, fresh(params, {"x": x})["out"])
        assert torch.equal(got, tcore.Realizer(g, plan, lowered=False)(
            params, {"x": x})["out"])


def test_specialize_refuses_another_structure():
    _, g0, plan0 = _traced(8, (4, 4))
    canonical = lower(g0, plan0)
    _, g1, plan1 = _traced(8, (2, 2, 4))      # another micro-batch count
    with pytest.raises(LoweringError, match="cannot specialize"):
        specialize(canonical, g1, plan1)
    _, g2, plan2 = _traced(8, (4, 4), seed=4)  # another graph
    with pytest.raises(LoweringError, match="cannot specialize"):
        specialize(canonical, g2, plan2)


def test_defaults_are_lowered():
    import inspect

    from repro_torch.serve import ServeConfig
    g = tcore.trace(chain_net(TORCH, 2), {"x": TensorSpec((4, D),
                                                          torch.float32)})
    rz = tcore.Realizer(g, tcore.sequential_plan(g))
    assert isinstance(rz.lowered, tcore.LoweredPlan)
    assert tcore.Realizer(g, tcore.sequential_plan(g),
                          lowered=False).lowered is None
    assert inspect.signature(build_forward).parameters["lowered"].default
    assert ServeConfig().lowered is True


# ---------------------------------------------------------------------------
# smoke models: lowered against interpreted, bitwise
# ---------------------------------------------------------------------------

MODELS = [("chatglm3-6b", "nanoflow"), ("chatglm3-6b", "tokenweave"),
          ("deepseek-moe-16b", "dbo"), ("deepseek-moe-16b", "comet"),
          ("mamba2-2.7b", "nanoflow"), ("zamba2-1.2b", "dynamic")]


def _both_forwards(prog, phase, B, S, policy, s_max):
    q = 1 if phase == "decode" else S
    out = []
    for lowered in (True, False):
        segs, _ = prog.model.build_segments(phase, B, q, s_max=s_max)
        info = ScheduleContext(local_batch=B, global_batch=B, seq_len=S,
                               phase=phase, arch=prog.model.cfg.name)
        out.append(build_forward(segs, policy, info, lowered=lowered))
    return out


def _assert_bitwise(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), f"{k!r} differs"


@pytest.mark.parametrize("arch,policy", MODELS)
def test_smoke_prefill_lowered_equals_interpreted(arch, policy):
    prog = tcompile(arch, policy=policy, smoke=True, device="cpu")
    params = prog.init_params(0)
    B, S = 4, 64
    rng = np.random.default_rng(0)
    batch = {"ids": torch.from_numpy(rng.integers(
                 0, prog.model.cfg.vocab, (B, S)).astype(np.int32)),
             "positions": torch.arange(S, dtype=torch.int32).expand(B, S)}
    lo, it = _both_forwards(prog, "prefill", B, S, policy, S)
    assert any(isinstance(r.lowered, tcore.LoweredPlan)
               for r in lo.realizers.values())
    _assert_bitwise(lo(params, batch), it(params, batch))


@pytest.mark.parametrize("arch,policy", MODELS)
def test_smoke_decode_lowered_equals_interpreted(arch, policy):
    prog = tcompile(arch, policy=policy, smoke=True, device="cpu")
    params = prog.init_params(0)
    B, s_max = 4, 32
    model = prog.model
    gen = torch.Generator().manual_seed(1)
    caches = {k: (torch.randn(v.shape, generator=gen) * 0.5).to(v.dtype)
              for k, v in model.decode_cache_env(B, s_max).items()}
    clen = torch.tensor([0, 5, 17, 30], dtype=torch.int32)
    ids = torch.randint(0, model.cfg.vocab, (B, 1), generator=gen,
                        dtype=torch.int32)
    outs = []
    for fwd in _both_forwards(prog, "decode", B, s_max, policy, s_max):
        mine = {k: v.clone() for k, v in caches.items()}
        outs.append(fwd(params, {"ids": ids, "positions": clen[:, None],
                                 "cache_len": clen, **mine}))
    _assert_bitwise(*outs)
