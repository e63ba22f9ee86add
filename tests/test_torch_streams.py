"""The stream program of a lowered plan (src/repro_torch/core/streams.py)
and its check in ``verify_lowered`` (VFY106).

On the CPU there are no streams, so a test executor plays the card's
part: the host resolves every instruction's slots to values in plan
order, as ``LoweredPlan.__call__`` does, and the "device" then runs the
instructions in a random order that keeps only each stream's FIFO order
and the program's waits, freeing each value at its death site's stream
position (a value a side-stream instruction touches at the join, as the
card's replay holds it).  A read of a value not yet produced, or freed,
fails.  Under the derived per-resource program and under random
assignments, every built-in strategy of the four model families (the
dense LM here, the others in tests/test_torch_streams_{moe,ssm}.py), in
prefill, decode and the train forward, must give bitwise the in-order
replay's outputs and the interpreter's (``lowered=False``), and random
resource-tagged DAGs must match the JAX package's lowering within
tests/test_torch_lowering.py's f32 tolerance.  Then the derivation's
rules, minimal waits, the verifier's findings on broken programs, and
``specialize`` / ``save`` / ``load`` deriving the same program.  The
``cuda`` cases compare per-resource streams with one stream on the card.
"""
import contextlib
import dataclasses
import itertools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.module as jmodule
import repro_torch.core as tcore
import repro_torch.core.module as tmodule
from repro.configs import get_smoke_config as jget_smoke
from repro.core import ScheduleContext as JCtx
from repro.models.base import build_forward as jbuild_forward
from repro.models.layers import MeshInfo as JMeshInfo
from repro.models.registry import build_model as jbuild_model
from repro_torch.api import compile as tcompile
from repro_torch.convert import params_from_numpy
from repro_torch.core import ScheduleContext, lower, specialize
from repro_torch.core import streams as tstreams
from repro_torch.core.backend import _resolve_path
from repro_torch.core.lowering import LoweredPlan
from repro_torch.core.module import TensorSpec
from repro_torch.core.partition import _dominant_resource
from repro_torch.core.strategies import registry as tregistry
from repro_torch.core.verify import verify_lowered
from repro_torch.models.base import build_forward
from repro_torch.tree import tree_map

D = 8
# tests/test_torch_lowering.py's: f32 matmuls and tanh, XLA against ATen
TOL = dict(atol=1e-5, rtol=1e-5)
# tests/test_torch_model.py's bf16 tolerance, atol scaled by the largest
# magnitude of the reference
BF16 = dict(atol=3e-2, rtol=3e-2)
ARCHS = ["chatglm3-6b", "deepseek-moe-16b", "mamba2-2.7b", "zamba2-1.2b"]
# every built-in strategy by name, and the two splitting ones with their
# token threshold at 1, as the autotuner's space registers them, so that
# the smoke shapes split into micro-batches too
STRATEGIES = tregistry.strategy_names() + ["nanoflow@1", "nanoflow@1x4",
                                           "dbo@1"]


def strategy(pkg, name):
    """The scheduler ``build_forward`` takes for ``name`` in ``pkg``
    (``"repro"`` or ``"repro_torch"``)."""
    if "@" not in name:
        return name
    import importlib
    base, spec = name.split("@")
    mod = importlib.import_module(f"{pkg}.core.strategies.{base}")
    if base == "dbo":
        return mod.DualBatchOverlap(min_tokens=1)
    n = int(spec.split("x")[1]) if "x" in spec else 2
    return mod.NanoFlow(min_tokens=1, n_split=n)


# ---------------------------------------------------------------------------
# the test executor: random legal interleavings on the CPU
# ---------------------------------------------------------------------------


class Hazard(AssertionError):
    """An instruction ran before a value it needs existed, or after it
    was freed."""


def interleaved(lp, prog, params, inputs, rng):
    """``lp(params, inputs)`` under ``prog`` in one random device order
    (see the module docstring)."""
    pvals = [_resolve_path(params, p) for p in lp.param_paths]
    ids = itertools.count()
    vals: dict = {}                    # value id -> tensor ("device" state)
    slot: dict = {}                    # slot -> value id (host)
    for name, s in lp.input_slots:
        v = next(ids)
        vals[v] = inputs[name]
        slot[s] = v
    host = []
    made = {}                          # value id -> producing instruction
    for i, ins in enumerate(lp.instrs):
        reads = [(slot[s], sl) for s, sl in ins.reads]
        dying, writes = [], []
        for s, buf in ins.writes:
            v = None
            if s >= 0:
                if s in slot:
                    dying.append(slot[s])
                v = slot[s] = next(ids)
                made[v] = i
            b = None
            if buf is not None:
                bslot, start, pad_cfg, axis = buf
                if pad_cfg is not None:
                    if bslot in slot:
                        dying.append(slot[bslot])
                    bv = next(ids)
                    made[bv] = i
                    slot[bslot] = bv
                b = (slot[bslot], start, pad_cfg, axis)
            writes.append((v, b))
        dying.extend(slot.pop(s) for s in ins.frees if s in slot)
        host.append((reads, writes, dying))
    outputs = {name: slot[s] for name, s in lp.output_slots}
    held = {v for i, (reads, writes, _d) in enumerate(host) if prog.held[i]
            for v in [r for r, _ in reads]
            + [w for w, _ in writes if w is not None]
            + [b[0] for _, b in writes if b is not None]}
    # the allocator: a value freed on the host (its death site) and not
    # held goes back to its producer's stream, whose next instruction
    # may take its storage
    reuse: dict = {}
    for d, (_r, _w, dying) in enumerate(host):
        for v in dying:
            if v in held or v not in made:
                continue
            a = prog.streams[made[v]]
            q = next((q for q in range(d + 1, len(host))
                      if prog.streams[q] == a), None)
            if q is not None:
                reuse.setdefault(q, []).append(v)

    def run(i):
        for v in reuse.get(i, ()):
            vals.pop(v, None)
        reads, writes, dying = host[i]
        ins = lp.instrs[i]
        try:
            args = [vals[v] if sl is None else vals[v].narrow(*sl)
                    for v, sl in reads]
        except KeyError as e:
            raise Hazard(f"instr {i} ({ins.label}) reads value {e} that "
                         "is not produced yet or was freed") from None
        outs = lp._exec(ins, pvals, args)
        for (v, b), o in zip(writes, outs):
            if v is not None:
                vals[v] = o
            if b is not None:
                bv, start, pad_cfg, axis = b
                if pad_cfg is not None:
                    before, after, _ = pad_cfg[axis]
                    shape = list(o.shape)
                    shape[axis] += before + after
                    vals[bv] = o.new_empty(shape)
                    vals[bv].narrow(axis, before, o.shape[axis]).copy_(o)
                elif bv not in vals:
                    raise Hazard(f"instr {i} writes a merge buffer not "
                                 "created yet")
                else:
                    vals[bv].narrow(axis, start[axis],
                                    o.shape[axis]).copy_(o)
        for v in dying:
            if v not in held:
                vals.pop(v, None)

    queues: dict = {}
    for i, s in enumerate(prog.streams):
        queues.setdefault(s, []).append(i)
    done: set = set()
    while any(queues.values()):
        ready = [s for s, q in queues.items()
                 if q and all(j in done for j in prog.waits[q[0]])]
        assert ready, "the stream program deadlocks"
        s = ready[rng.integers(len(ready))]
        i = queues[s].pop(0)
        run(i)
        done.add(i)
    return {name: vals[v] for name, v in outputs.items()}


def random_assignment(n, rng, k=4):
    a = rng.integers(0, k, n)
    return lambda i: int(a[i])


@contextlib.contextmanager
def interleaving(seed, mode):
    """Every ``LoweredPlan`` call inside runs through the test executor:
    ``mode`` ``"resources"`` runs each call's own program, ``"random"``
    a random assignment of each call's instructions to 4 streams (which
    the verifier must pass)."""
    rng = np.random.default_rng(seed)

    def call(self, params, inputs):
        prog = self.streams
        if mode == "random":
            prog = prog.reassigned(random_assignment(len(self.instrs), rng))
            assert not verify_lowered(
                dataclasses.replace(self, streams=prog))
        return interleaved(self, prog, params, inputs, rng)
    with mock.patch.object(LoweredPlan, "__call__", call):
        yield


def assert_bitwise(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), f"{k!r} differs"


# ---------------------------------------------------------------------------
# resource-tagged DAGs in both packages, against the JAX package
# ---------------------------------------------------------------------------


class _Pkg:
    def __init__(self, core, module, spec, tanh, f32):
        self.core, self.module = core, module
        self.spec, self.tanh, self.f32 = spec, tanh, f32


JAX = _Pkg(jcore, jmodule, jax.ShapeDtypeStruct, jnp.tanh, jnp.float32)
TORCH = _Pkg(tcore, tmodule, TensorSpec, torch.tanh, torch.float32)


def tagged_net(pkg, seed, n_ops):
    """A random DAG of compute ``Lin``s, memory ``Add``s and ``Scale``s
    and network ``Pass``es (identities, as a collective is at tp=1)."""
    class Lin(pkg.module.Op):
        resource = "compute"

        def __init__(self, name):
            super().__init__()
            self.w = pkg.module.Param((D, D), pkg.f32)
            self.named(name)

        def kernel(self, p, x):
            return pkg.tanh(x @ p["w"])

    class Add(pkg.module.Op):
        resource = "memory"

        def kernel(self, p, a, b):
            return a + b

    class Scale(pkg.module.Op):
        resource = "memory"

        def kernel(self, p, a):
            return a * 0.5

    class Pass(pkg.module.Op):
        resource = "network"

        def kernel(self, p, a):
            return a

    class Net(pkg.module.Module):
        def __init__(self):
            super().__init__()
            rng = np.random.default_rng(seed)
            self.wiring = []
            for i in range(n_ops):
                r = rng.random()
                if i >= 2 and r < 0.3:
                    self.wiring.append(("add", int(rng.integers(i)),
                                        int(rng.integers(i))))
                    setattr(self, f"op{i}", Add().named(f"add{i}"))
                    continue
                a = int(rng.integers(i + 1)) - 1
                if r < 0.45:
                    op = Scale().named(f"scale{i}")
                elif r < 0.6:
                    op = Pass().named(f"pass{i}")
                else:
                    op = Lin(f"lin{i}")
                self.wiring.append(("one", a, -1))
                setattr(self, f"op{i}", op)

        def forward(self, x):
            vals = [x]
            for i, (kind, a, b) in enumerate(self.wiring):
                op = getattr(self, f"op{i}")
                vals.append(op(vals[a + 1], vals[b + 1]) if kind == "add"
                            else op(vals[a + 1]))
            return {"y": vals[-1], "mid": vals[len(vals) // 2]}
    return Net()


def random_scheduler(pkg, seed, split, merge_prob):
    class RandomScheduler(pkg.core.OpSchedulerBase):
        def schedule(self, ctx):
            rng = np.random.default_rng(seed)
            if split:
                ctx.split(split)
            parts = list(range(len(split))) if split else [pkg.core.FULL]
            while True:
                ready = [h for i in parts for h in ctx.get_ready_ops(i)]
                if not ready:
                    break
                if split and rng.random() < merge_prob:
                    by_oid = {}
                    for h in ready:
                        by_oid.setdefault(h.oid, []).append(h)
                    full = [v for v in by_oid.values() if len(v) == len(split)]
                    if full:
                        ctx.execute(tuple(full[rng.integers(len(full))]))
                        continue
                ctx.execute(ready[rng.integers(len(ready))])
    return RandomScheduler()


def build_both(seed, n_ops, split, merge_prob, batch=8):
    out = []
    np_params = x = None
    for pkg in (JAX, TORCH):
        net = tagged_net(pkg, seed, n_ops)
        g = pkg.core.trace(net, {"x": pkg.spec((batch, D), pkg.f32)})
        plan = pkg.core.record_plan(
            g, random_scheduler(pkg, seed, split, merge_prob),
            pkg.core.ScheduleContext(local_batch=batch))
        if pkg is JAX:
            rng = np.random.default_rng(seed)
            np_params = jax.tree_util.tree_map(
                lambda a: (rng.standard_normal(a.shape) * 0.5).astype(
                    np.float32), net.init(jax.random.PRNGKey(0)))
            x = rng.standard_normal((batch, D)).astype(np.float32)
            out.append((g, plan, jax.tree_util.tree_map(jnp.asarray,
                                                        np_params),
                        jnp.asarray(x)))
        else:
            out.append((g, plan, params_from_numpy(np_params, device="cpu"),
                        torch.from_numpy(x)))
    return out


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("split", [(), (4, 4), (2, 6), (2, 2, 4)])
def test_random_interleavings_of_tagged_dags_match_the_reference(seed,
                                                                 split):
    (jg, jplan, jp, jx), (tg, tplan, tp, tx) = build_both(
        seed, 4 + seed % 6, split, merge_prob=0.3 * (seed % 3))
    want = jcore.Realizer(jg, jplan, lowered=False)(jp, {"x": jx})
    lp = lower(tg, tplan)
    in_order = lp(tp, {"x": tx})
    interp = tcore.Realizer(tg, tplan, lowered=False)(tp, {"x": tx})
    assert_bitwise(in_order, interp)
    rng = np.random.default_rng(100 + seed)
    assert not verify_lowered(lp)
    for trial in range(6):
        prog = lp.streams if trial < 3 else lp.streams.reassigned(
            random_assignment(len(lp.instrs), rng))
        got = interleaved(lp, prog, tp, {"x": tx}, rng)
        assert_bitwise(got, in_order)
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       **TOL)


# ---------------------------------------------------------------------------
# the four model families, every built-in strategy, three phases
# ---------------------------------------------------------------------------


def smoke_cfg(get, arch):
    return dataclasses.replace(get(arch), n_layers=2) \
        if arch == "deepseek-moe-16b" else get(arch)


def family_fixture(archs):
    """A module fixture over ``archs``: the smoke model of both packages
    on the JAX package's params.  The families are spread over this file
    and tests/test_torch_streams_{moe,ssm}.py, so that parallel workers
    take them apart."""
    return pytest.fixture(scope="module", params=archs)(_family)


def _family(request):
    from repro_torch.configs import get_smoke_config as tget_smoke
    arch = request.param
    jm = jbuild_model(smoke_cfg(jget_smoke, arch), JMeshInfo())
    jparams = jm.init_params(jax.random.PRNGKey(0), phase="prefill")
    prog = tcompile(smoke_cfg(tget_smoke, arch), policy="sequential",
                    device="cpu")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return arch, jm, jparams, prog, tparams


def phase_inputs(model, phase, B, S, seed):
    rng = np.random.default_rng(seed)
    vocab = model.cfg.vocab
    if phase == "decode":
        clen = np.asarray([0, 3, 9, S - 1][:B], np.int32)
        batch = {"ids": rng.integers(0, vocab, (B, 1)).astype(np.int32),
                 "positions": clen[:, None].copy(), "cache_len": clen}
        caches = {k: (rng.standard_normal(tuple(v.shape)) * 0.5).astype(
                      np.float32)
                  for k, v in model.decode_cache_env(B, S).items()}
        return batch, caches
    batch = {"ids": rng.integers(0, vocab, (B, S)).astype(np.int32),
             "positions": np.broadcast_to(np.arange(S, dtype=np.int32),
                                          (B, S)).copy()}
    if phase == "train":
        batch["labels"] = rng.integers(0, vocab, (B, S)).astype(np.int32)
    return batch, {}


def port_forward(prog, phase, B, S, name, lowered):
    q = 1 if phase == "decode" else S
    segs, _ = prog.model.build_segments(phase, B, q, s_max=S)
    info = ScheduleContext(local_batch=B, global_batch=B, seq_len=S,
                           phase=phase, arch=prog.model.cfg.name)
    return build_forward(segs, strategy("repro_torch", name), info,
                         lowered=lowered)


def run_port(fwd, params, batch, caches):
    """``fwd`` on the batch and fresh copies of the caches (a decode
    step writes them in place)."""
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb.update({k: v.clone() for k, v in caches.items()})
    return fwd(params, tb)


def run_jax(jm, jparams, phase, B, S, name, batch, caches):
    q = 1 if phase == "decode" else S
    segs, _ = jm.build_segments(phase, B, q, s_max=S)
    fwd = jbuild_forward(segs, strategy("repro", name),
                         JCtx(local_batch=B, global_batch=B, seq_len=S,
                              phase=phase, arch=jm.cfg.name),
                         lowered=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb.update({k: jnp.asarray(v.float().numpy()).astype(
        jnp.dtype(str(v.dtype).split(".")[-1])) for k, v in caches.items()})
    return fwd(jparams, jb)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want):
    want = np32(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np32(got), want, atol=BF16["atol"] * scale,
                               rtol=BF16["rtol"])


def check_interleavings(prog, tparams, phase, name, jax_side=None):
    """The in-order replay equals the interpreter; random legal
    interleavings of each call's own program and of random assignments
    equal the in-order replay; with ``jax_side``, the JAX package's
    interpreted forward under the same strategy agrees."""
    model = prog.model
    B, S = 4, 16
    batch, caches = phase_inputs(model, phase, B, S, seed=7)
    caches = {k: torch.from_numpy(v).to(model.decode_cache_env(
        B, S)[k].dtype) for k, v in caches.items()}
    lo = port_forward(prog, phase, B, S, name, True)
    it = port_forward(prog, phase, B, S, name, False)
    for r in lo.realizers.values():
        assert r.lowered.streams.side          # memory ops: a side stream
        assert not verify_lowered(r.lowered)
    if phase != "decode" and (name.startswith("nanoflow@") or (
            name == "dbo@1" and model.cfg.family == "moe")):
        assert any(r.lowered.split_sizes for r in lo.realizers.values())
    want = run_port(lo, tparams, batch, caches)
    assert_bitwise(want, run_port(it, tparams, batch, caches))
    for seed, mode in ((1, "resources"), (2, "resources"), (3, "random")):
        with interleaving(seed, mode):
            assert_bitwise(run_port(lo, tparams, batch, caches), want)
    if jax_side is not None:
        jm, jparams = jax_side
        ref = run_jax(jm, jparams, phase, B, S, name, batch, caches)
        close(want["logits"], ref["logits"])


family = family_fixture(ARCHS[:1])


@pytest.mark.parametrize("name", STRATEGIES)
@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_every_strategy_interleaves_to_the_same_bits(family, phase, name):
    """Prefill also against the JAX package; decode against the port's
    interpreter, which tests/test_torch_{model,moe,ssm}.py hold to it."""
    arch, jm, jparams, prog, tparams = family
    check_interleavings(prog, tparams, phase, name,
                        (jm, jparams) if phase == "prefill" else None)


@pytest.mark.parametrize("name", STRATEGIES)
def test_every_strategy_interleaves_the_train_forward(name):
    """The dense LM's train forward (loss sum and token count per
    sample); the MoE LM's is in tests/test_torch_streams_moe.py, Mamba2's
    and the hybrid's in tests/test_torch_streams_ssm.py."""
    prog = tcompile("chatglm3-6b", policy="sequential", smoke=True,
                    device="cpu")
    check_interleavings(prog, prog.init_params(0, phase="train"), "train",
                        name)


# ---------------------------------------------------------------------------
# the derivation's rules
# ---------------------------------------------------------------------------


def _tagged(seed=3, n_ops=9, split=(4, 4), merge_prob=0.3):
    _, (g, plan, params, x) = build_both(seed, n_ops, split, merge_prob)
    return g, plan, params, x, lower(g, plan)


@pytest.mark.parametrize("seed", range(6))
def test_steps_go_to_their_resource_stream(seed):
    g, plan, _, _, lp = _tagged(seed)
    want = [tstreams.RESOURCE_STREAM[g.nodes[s.handles[0].oid].resource]
            for s in plan.steps]
    assert list(lp.streams.streams) == want
    assert set(want) > {0}                  # the nets mix resources
    assert lp.streams.side == tuple(sorted(set(want) - {0}))
    assert lp.streams.held == tuple(s != 0 for s in want)


def _fused_forward():
    """TokenWeave's fused [all-reduce -> add -> RMSNorm] steps, one per
    layer of the smoke dense LM without sequence parallelism."""
    from repro_torch.configs import get_smoke_config as tget_smoke
    cfg = dataclasses.replace(tget_smoke("chatglm3-6b"), seq_parallel=False)
    prog = tcompile(cfg, policy="tokenweave", device="cpu")
    return prog, [port_forward(prog, "prefill", 4, 16, "tokenweave", lo)
                  for lo in (True, False)]


def test_fused_steps_run_on_their_dominant_resource():
    prog, (lo, it) = _fused_forward()
    seen = 0
    for rz in lo.realizers.values():
        lp = rz.lowered
        for i, ins in enumerate(lp.instrs):
            if not ins.fused:
                continue
            nodes = {h.oid: lp.graph.nodes[h.oid] for h in ins.step.handles}
            res = _dominant_resource(list(nodes.values()))
            assert lp.streams.streams[i] == tstreams.RESOURCE_STREAM[res]
            assert tstreams.step_resource(lp.graph, ins.step) == res
            seen += 1
    assert seen == 1              # one fused step in the layer plan
    params = prog.init_params(0)
    batch, _ = phase_inputs(prog.model, "prefill", 4, 16, seed=2)
    want = run_port(lo, params, batch, {})
    assert_bitwise(want, run_port(it, params, batch, {}))
    for seed, mode in ((4, "resources"), (5, "random")):
        with interleaving(seed, mode):
            assert_bitwise(run_port(lo, params, batch, {}), want)


def test_a_fused_mix_is_decided_by_weight_not_by_set_order():
    """A fused step of a compute and a memory op goes by their flops and
    bytes (``_dominant_resource``), whatever order a set would give."""
    g, plan, _, _, lp = _tagged(5, n_ops=6, split=())
    nodes = list(g.nodes.values())
    comp = next(n for n in nodes if n.resource == "compute")
    mem = next(n for n in nodes if n.resource == "memory")
    step = tcore.PlanStep("fused", (tcore.OpHandle(comp.oid, tcore.FULL, ""),
                                    tcore.OpHandle(mem.oid, tcore.FULL, "")))
    heavy = dataclasses.replace(comp, flops=1e9, bytes_moved=0.0)
    light = dataclasses.replace(mem, flops=0.0, bytes_moved=1.0)
    for a, b in ((heavy, light), (light, heavy)):
        g.nodes[a.oid], g.nodes[b.oid] = a, b
        assert tstreams.step_resource(g, step) == "compute"
    heavy_mem = dataclasses.replace(mem, bytes_moved=1e12)
    g.nodes[mem.oid] = heavy_mem
    assert tstreams.step_resource(g, step) == "memory"


def _ancestors(prog, i, drop=None):
    """Instructions ordered before ``i`` starts: its stream's earlier
    instructions and, through waits, whatever those waited for
    (``drop``: one wait ``(i, j)`` left out)."""
    prev = {}
    for k, s in enumerate(prog.streams):
        prev[k] = prev.get("last", {}).get(s)
        prev.setdefault("last", {})[s] = k
    seen, todo = set(), [i]
    while todo:
        k = todo.pop()
        nxt = [prev[k]] if prev[k] is not None else []
        nxt += [j for j in prog.waits[k] if (k, j) != drop]
        for j in nxt:
            if j not in seen:
                seen.add(j)
                todo.append(j)
    return seen


@pytest.mark.parametrize("seed", range(8))
def test_waits_are_sufficient_and_minimal(seed):
    g, plan, _, _, lp = _tagged(seed, n_ops=10, split=(2, 2, 4))
    rng = np.random.default_rng(seed)
    for prog in (lp.streams,
                 lp.streams.reassigned(random_assignment(len(lp.instrs),
                                                         rng))):
        for i in range(len(prog.streams)):
            before = _ancestors(prog, i)
            assert set(prog.deps[i]) <= before
            for j in prog.waits[i]:
                assert prog.streams[j] != prog.streams[i]
                assert prog.events[j] >= 0
                # no other path already orders j before i
                assert j not in _ancestors(prog, i, drop=(i, j))
        last = {}
        for k, s in enumerate(prog.streams):
            last[s] = k

        def joined(joins):
            end = set(joins)
            if 0 in last:
                end |= {last[0]} | _ancestors(prog, last[0])
            for j in joins:
                end |= _ancestors(prog, j)
            return end
        # every side stream is joined, and no join is implied by the rest
        assert {k for s, k in last.items() if s != 0} <= joined(prog.joins)
        for j in prog.joins:
            assert j not in joined([k for k in prog.joins if k != j])


def test_one_stream_program_has_no_waits_or_events():
    _, _, _, _, lp = _tagged(2)
    prog = lp.streams.reassigned(lambda i: 0)
    assert prog.side == () and prog.n_events == 0 and prog.joins == ()
    assert all(w == () for w in prog.waits) and not any(prog.held)


# ---------------------------------------------------------------------------
# the verifier on broken programs
# ---------------------------------------------------------------------------


def _nanoflow_layer():
    """The smoke dense LM's NanoFlow prefill layer plan: two nano-batches
    whose memory ops run on the side stream."""
    prog = tcompile("chatglm3-6b", policy="nanoflow", smoke=True,
                    device="cpu")
    fwd = port_forward(prog, "prefill", 4, 16, "nanoflow@1", True)
    lp = fwd.realizers["layers"].lowered
    assert lp.streams.side and lp.split_sizes
    params = prog.init_params(0)
    x = torch.randn((4, 16, prog.model.cfg.d_model),
                    generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    inputs = {"x": x, "positions": torch.arange(
        16, dtype=torch.int32).expand(4, 16)}
    return lp, tree_map(lambda t: t[0], params["layers"]), inputs


def _vfy106(lp, prog):
    return [d for d in verify_lowered(dataclasses.replace(lp, streams=prog))
            if d.code == "VFY106"]


def test_built_in_programs_verify_clean():
    lp, _, _ = _nanoflow_layer()
    assert not verify_lowered(lp)


def test_a_missing_wait_is_reported_and_races():
    lp, params, inputs = _nanoflow_layer()
    want = lp(params, inputs)
    prog = lp.streams
    i = next(i for i, w in enumerate(prog.waits) if w)
    waits = list(prog.waits)
    waits[i] = waits[i][1:]
    bad = dataclasses.replace(prog, waits=tuple(waits))
    diags = _vfy106(lp, bad)
    assert any(d.step_index == i and "before" in d.message for d in diags)
    hazards = 0
    for seed in range(40):
        try:
            got = interleaved(lp, bad, params, inputs,
                              np.random.default_rng(seed))
            assert_bitwise(got, want)
        except Hazard:
            hazards += 1
    assert hazards


def test_an_early_cross_stream_free_is_reported_and_races():
    """Without the holds, a value read on a side stream is freed at its
    death site on its producer's stream: the allocator may reuse it
    under the pending read."""
    lp, params, inputs = _nanoflow_layer()
    bad = dataclasses.replace(lp.streams, held=(False,) * len(lp.instrs))
    diags = _vfy106(lp, bad)
    assert any("frees" in d.message and "may still read" in d.message
               for d in diags)
    hazards = 0
    for seed in range(40):
        try:
            interleaved(lp, bad, params, inputs, np.random.default_rng(seed))
        except Hazard:
            hazards += 1
    assert hazards


def test_an_unjoined_side_stream_is_reported():
    lp, _, _ = _nanoflow_layer()
    bad = dataclasses.replace(lp.streams, joins=())
    diags = _vfy106(lp, bad)
    assert any("not joined" in d.message for d in diags)


def test_a_wait_on_an_unrecorded_event_is_reported():
    lp, _, _ = _nanoflow_layer()
    prog = lp.streams
    i = next(i for i, w in enumerate(prog.waits) if w)
    events = list(prog.events)
    events[prog.waits[i][0]] = -1
    diags = _vfy106(lp, dataclasses.replace(prog, events=tuple(events)))
    assert any("records no event" in d.message for d in diags)


def test_a_program_of_another_length_is_reported():
    lp, _, _ = _nanoflow_layer()
    prog = lp.streams
    short = dataclasses.replace(prog, streams=prog.streams[:-1])
    diags = _vfy106(lp, short)
    assert diags and diags[0].step_index == -1


# ---------------------------------------------------------------------------
# re-derived, never stored
# ---------------------------------------------------------------------------


def _bucket(batch, split, seed=4):
    _, (g, plan, params, x) = build_both(seed, 8, split, 0.3, batch=batch)
    return g, plan, params, x


@pytest.mark.parametrize("batches", [((8, (4, 4)), (16, (8, 8))),
                                     ((8, (2, 6)), (12, (3, 9)))])
def test_specialize_derives_the_same_program(batches):
    (b0, s0), (b1, s1) = batches
    g0, p0, _, _ = _bucket(b0, s0)
    g1, p1, params, x = _bucket(b1, s1)
    canon = lower(g0, p0)
    spec = specialize(canon, g1, p1)
    fresh = lower(g1, p1)
    assert spec.streams == fresh.streams == canon.streams
    assert spec.streams is not canon.streams
    assert_bitwise(spec(params, {"x": x}), fresh(params, {"x": x}))


def test_a_saved_and_loaded_plan_derives_the_same_program(tmp_path):
    from repro_torch.core.plan_store import PlanStore
    g, plan, params, x = _bucket(8, (4, 4))
    store = PlanStore()
    lp = store.get_or_lower(g, plan, salt="t", capture=False)
    path = tmp_path / "plans.dfps"
    assert store.save(str(path)) == 1
    assert b"streams" not in path.read_bytes()
    warm = PlanStore.open(str(path))
    back = warm.get_or_lower(g, plan, salt="t", capture=False)
    assert warm.snapshot()["restore_hits"] == 1
    assert back.streams == lp.streams
    assert not verify_lowered(back)
    assert_bitwise(back(params, {"x": x}), lp(params, {"x": x}))


def test_the_assignment_is_no_option_of_an_entry_point():
    import inspect

    from repro_torch.api import compile as api_compile
    from repro_torch.serve import ServeConfig
    from repro_torch.train import TrainStepConfig
    names = set(inspect.signature(api_compile).parameters)
    names |= {f.name for f in dataclasses.fields(ServeConfig)}
    names |= {f.name for f in dataclasses.fields(TrainStepConfig)}
    assert not {n for n in names if "stream" in n or "assign" in n}
