"""The port under a bound mesh axis, against the JAX package's
``shard_map`` steps: counterparts of ``tests/test_distributed.py``'s
tensor-parallel forward, token-sharded MoE, TokenWeave over four ranks,
the four-stage pipeline (its forward and its weight gradients) and the
data-parallel gradient rules, each rank's
outputs held to the reference's addressable shard.

How both sides run (the helpers here are shared by
``tests/test_torch_fsdp.py`` and ``tests/test_torch_launch.py``):
  * the reference runs once a module, in one subprocess with
    ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` set before
    ``jax`` is imported, through its interpreted steps (``lowered=False``:
    its lowered realize captures a jaxpr with ``jax.core.jaxpr_as_fun``,
    which jax 0.9 removed); it pickles the global params and outputs as
    numpy arrays;
  * the port runs in 2 or 4 CPU processes over ``torch.distributed``
    (gloo), each with its own free port and a timeout, on a mesh from
    ``launch.mesh.make_mesh``; each rank loads the reference's params with
    ``convert.params_from_numpy`` and cuts its shard with
    ``launch.sharding.shard_tree``, and pickles what it computed.

Tolerances are the port's single-device parity limits for the same
family: the train-phase loss within 2e-3 relative, a train step's
grad_norm within 2e-2 and each leaf's update within 5e-2 relative L2
(``tests/test_torch_train.py``); the MoE block within the reference
test's 3e-2 (the reference's einsum FFN rounds its gate to bf16, the
port's grouped FFN keeps it in f32); TokenWeave and the pipeline within
the reference test's 1e-4 (the pipeline's gradients also 1e-5
relative).  Plans must be equal.
"""
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
TIMEOUT = 300


# ---------------------------------------------------------------------------
# shared helpers: subprocesses, pickled numpy trees
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


def run_reference(module: str, out: Path, devices: int = 4) -> dict:
    """``<module>._reference(out)`` in a subprocess that sees ``devices``
    host devices; returns what it pickled to ``out/ref.pkl``."""
    code = (f"import sys; sys.path.insert(0, {str(TESTS)!r}); "
            f"import {module} as t; t._reference({str(out)!r})")
    env = _env(XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    with open(out / "ref.pkl", "rb") as f:
        return pickle.load(f)


def run_ranks(module: str, fn: str, world: int, out: Path) -> list:
    """``<module>.<fn>(rank, world, port, out)`` in ``world`` processes;
    returns what each pickled to ``out/<fn>_rank<r>.pkl``."""
    port = free_port()
    code = (f"import sys; sys.path.insert(0, {str(TESTS)!r}); "
            f"import {module} as t; "
            f"t.{fn}(int(sys.argv[1]), {world}, {port}, {str(out)!r})")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=TIMEOUT)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), \
        "\n".join(e[-3000:] for e in errs)
    res = []
    for r in range(world):
        with open(out / f"{fn}_rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


def init_rank(rank: int, world: int, port: int):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)


def save(obj, path):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def to_np(tree):
    """jax/torch tree -> numpy tree: the reference's arrays as they are
    (bf16 as ``ml_dtypes.bfloat16``), the port's tensors as numpy (bf16
    widened to f32, which is exact)."""
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if hasattr(tree, "dtype") and hasattr(tree, "shape"):
        return np.asarray(tree)
    return tree


def to_torch(tree):
    """numpy tree -> torch tensors on the CPU, through the port's
    ``convert.params_from_numpy`` (bf16 by its bits)."""
    from repro_torch.convert import params_from_numpy
    return params_from_numpy(tree, device="cpu")


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def rel(a, b) -> float:
    a, b = f32(a), f32(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def plan_summary(plan):
    return ([(s.kind, tuple((h.oid, h.mb, h.name) for h in s.handles),
              s.replace_name) for s in plan.steps], tuple(plan.split_sizes))


def plans_of(fwd) -> dict:
    return {k: plan_summary(rz.plan) for k, rz in fwd.realizers.items()}


# ---------------------------------------------------------------------------
# the cases' configurations (shared by both sides)
# ---------------------------------------------------------------------------


B, S = 2, 16


def tp_cfg(pkg_get):
    import dataclasses
    return dataclasses.replace(pkg_get("chatglm3-6b"), n_heads=4, n_kv=2,
                               d_model=32, d_ff=64)


def batch_np(vocab, Bg, Sg, seed, labels=True):
    rng = np.random.default_rng(seed)
    out = {"ids": rng.integers(0, min(vocab, 100), (Bg, Sg)).astype(np.int32),
           "positions": np.broadcast_to(np.arange(Sg, dtype=np.int32),
                                        (Bg, Sg)).copy()}
    if labels:
        out["labels"] = rng.integers(0, min(vocab, 100),
                                     (Bg, Sg)).astype(np.int32)
    return out


def moe_arch(pkg):
    return pkg.ArchConfig(
        name="t", family="moe", n_layers=1, d_model=16, n_heads=2, n_kv=2,
        d_ff=32, vocab=64, moe=pkg.MoEConfig(n_experts=4, top_k=2,
                                             d_ff_expert=8, n_shared=1,
                                             capacity_factor=4.0))


LR, EPS = 1.0, 1.0      # AdamW updates linear in the gradients


# ---------------------------------------------------------------------------
# the reference side
# ---------------------------------------------------------------------------


def _reference(out):
    import jax
    import jax.numpy as jnp
    import jax.tree_util as jtu
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro import configs as jconfigs
    from repro.configs import get_smoke_config
    from repro.core.scheduler import ScheduleContext
    from repro.core.strategies import get_strategy
    from repro.dist.pipeline import pipeline_apply
    from repro.kernels import ops, ref
    from repro.launch.sharding import (global_param_specs, shard_specs_of,
                                       spec_to_p)
    from repro.models.base import build_forward
    from repro.models.layers import MeshInfo
    from repro.models.moe import MoEBlock
    from repro.models.registry import build_model
    from repro.optim import AdamWConfig
    from repro.train.step import TrainStepConfig, _build_train_step
    res = {}

    # -- tp=4 train-phase forward against tp=1 ----------------------------
    cfg = tp_cfg(get_smoke_config)
    mesh = jax.make_mesh((1, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    batch = {k: jnp.asarray(v) for k, v in
             batch_np(cfg.vocab, B, S, 2).items()}
    m1 = build_model(cfg, MeshInfo(tp=1, dp=1))
    segs1, _ = m1.build_segments("train", B, S)
    ctx = ScheduleContext(local_batch=B, seq_len=S, phase="train")
    fwd1 = build_forward(segs1, get_strategy("sequential"), ctx,
                         lowered=False)
    p1 = m1._init_from_segments(segs1, jax.random.PRNGKey(0), global_=True)
    o1 = fwd1(p1, batch)
    res["tp1_loss"] = float(jnp.sum(o1["loss_sum"])
                            / jnp.sum(o1["token_count"]))
    m4 = build_model(cfg, MeshInfo(tp=4, dp=1))
    segs4, _ = m4.build_segments("train", B, S)
    fwd4 = build_forward(segs4, get_strategy("sequential"), ctx,
                         lowered=False)
    pg = m4._init_from_segments(segs4, jax.random.PRNGKey(0), global_=True)
    _, pshd = global_param_specs(m4, segs4, mesh)

    def step(params, batch):
        o = fwd4(params, batch)
        return jnp.sum(o["loss_sum"]), jnp.sum(o["token_count"])

    fm = jax.shard_map(step, mesh=mesh,
                       in_specs=(shard_specs_of(pshd),
                                 {k: P() for k in batch}),
                       out_specs=(P(), P()), check_vma=False)
    ls, cnt = jax.jit(fm)(jax.device_put(pg, pshd), batch)
    res["tp4"] = {"params": to_np(pg), "loss": float(ls / cnt),
                  "plans": plans_of(fwd4)}

    # -- MoE: token-sharded (a2a) against replicated (slice + psum) -------
    mcfg = moe_arch(jconfigs)
    mesh_m = jax.make_mesh((4,), ("model",),
                           axis_types=(jax.sharding.AxisType.Auto,))
    minfo = MeshInfo(tp=4, dp=1)
    blk_ts = MoEBlock(mcfg, minfo, token_sharded=True)
    blk_rp = MoEBlock(mcfg, minfo, token_sharded=False)
    params = blk_ts.init(jax.random.PRNGKey(0), global_=True)
    params_rp = blk_rp.init(jax.random.PRNGKey(0), global_=True)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 8, 16), jnp.bfloat16)

    def pspec(blk):
        return jtu.tree_map(spec_to_p, blk.param_pspecs(),
                            is_leaf=lambda v: isinstance(v, tuple))

    def put(t, s):
        return jax.device_put(t, jtu.tree_map(
            lambda sp: NamedSharding(mesh_m, sp), s,
            is_leaf=lambda v: isinstance(v, P)))
    f_ts = jax.shard_map(blk_ts.apply, mesh=mesh_m,
                         in_specs=(pspec(blk_ts), P(None, "model", None)),
                         out_specs=P(None, "model", None), check_vma=False)
    f_rp = jax.shard_map(blk_rp.apply, mesh=mesh_m,
                         in_specs=(pspec(blk_rp), P()), out_specs=P(),
                         check_vma=False)
    y_ts = jax.jit(f_ts)(put(params, pspec(blk_ts)), jax.device_put(
        x, NamedSharding(mesh_m, P(None, "model", None))))
    y_rp = jax.jit(f_rp)(put(params_rp, pspec(blk_rp)), x)
    res["moe"] = {"params": to_np(params), "params_rp": to_np(params_rp),
                  "x": to_np(x), "y_ts": to_np(y_ts), "y_rp": to_np(y_rp)}

    # -- TokenWeave over 4 ranks -------------------------------------------
    y_parts = jax.random.normal(jax.random.PRNGKey(0), (4, 2, 16, 32))
    xw = jax.random.normal(jax.random.PRNGKey(1), (2, 16, 32))
    g = jax.random.normal(jax.random.PRNGKey(2), (32,))

    def tw(yp, x, g):
        return ops.fused_ar_add_rmsnorm(yp[0], x, g, axis="model")
    fm = jax.shard_map(tw, mesh=mesh_m, in_specs=(P("model"), P(), P()),
                       out_specs=(P(), P()), check_vma=False)
    s, h = jax.jit(fm)(y_parts, xw, g)
    s2, h2 = ref.fused_add_rmsnorm(xw, y_parts.sum(0), g)
    res["tokenweave"] = {"y_parts": to_np(y_parts), "x": to_np(xw),
                         "g": to_np(g), "s": to_np(s), "h": to_np(h),
                         "s_ref": to_np(s2), "h_ref": to_np(h2)}

    # -- the pipeline driver over 4 stages ----------------------------------
    mesh_p = jax.make_mesh((4,), ("pod",),
                           axis_types=(jax.sharding.AxisType.Auto,))
    Ws = jnp.stack([jnp.eye(8) * (i + 1) for i in range(4)])
    mbs = jax.random.normal(jax.random.PRNGKey(0), (6, 3, 8))
    fm = jax.shard_map(
        lambda ws, mb: pipeline_apply(lambda w, x: x @ w, ws[0], mb,
                                      axis="pod"),
        mesh=mesh_p, in_specs=(P("pod"), P()), out_specs=P("pod"),
        check_vma=False)
    # its backward: a fixed cotangent on every stage's buffer, each
    # stage's weight gradient through the ring's transposed ppermutes
    cot = jax.random.normal(jax.random.PRNGKey(1), (24, 3, 8))
    grad = jax.jit(jax.grad(lambda ws: jnp.sum(fm(ws, mbs) * cot)))(Ws)
    res["pipeline"] = {"Ws": to_np(Ws), "mbs": to_np(mbs),
                       "out": to_np(jax.jit(fm)(Ws, mbs)),
                       "cot": to_np(cot), "grad": to_np(grad)}

    # -- data-parallel gradient rules (dp=2) --------------------------------
    mesh_d = jax.make_mesh((2, 1), ("data", "model"), devices=jax.devices()[:2],
                           axis_types=(jax.sharding.AxisType.Auto,) * 2)
    scfg = get_smoke_config("smollm-135m")
    tcfg = TrainStepConfig(optimizer=AdamWConfig(lr=LR, eps=EPS),
                           remat=False, warmup=1, total_steps=5,
                           lowered=False)
    model = build_model(scfg, MeshInfo(tp=1, dp=2))
    B_loc = 2
    step, segs, _, init_opt = _build_train_step(
        model, get_strategy("sequential"), B_loc, S, tcfg)
    params = model._init_from_segments(segs, jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in
             batch_np(scfg.vocab, 2 * B_loc, S, 3).items()}
    bspec = {k: P("data") for k in batch}
    fm = jax.shard_map(step, mesh=mesh_d, in_specs=(P(), P(), bspec, P()),
                       out_specs=(P(), P(), {"loss": P(), "grad_norm": P(),
                                             "lr": P(), "tokens": P()}),
                       check_vma=False)
    p2, _, m = jax.jit(fm)(params, init_opt(params), batch, jnp.int32(0))
    m1 = build_model(scfg, MeshInfo(tp=1, dp=1))
    step1, segs1, _, init1 = _build_train_step(
        m1, get_strategy("sequential"), 2 * B_loc, S, tcfg)
    p1n, _, mm1 = jax.jit(step1)(params, init1(params), batch, jnp.int32(0))
    res["dp"] = {"params": to_np(params), "after": to_np(p2),
                 "metrics": {k: float(v) for k, v in m.items()},
                 "after_1dev": to_np(p1n),
                 "metrics_1dev": {k: float(v) for k, v in mm1.items()}}
    save(res, Path(out) / "ref.pkl")


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------


def _ref_of(out):
    with open(Path(out) / "ref.pkl", "rb") as f:
        return pickle.load(f)


def _ranks4(rank, world, port, out):
    """tp=4 forward, MoE, TokenWeave and the pipeline on 4 ranks."""
    init_rank(rank, world, port)
    import torch.distributed as dist

    from repro_torch import configs as tconfigs
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import ScheduleContext
    from repro_torch.dist.pipeline import pipeline_apply
    from repro_torch.kernels import tokenweave
    from repro_torch.launch.mesh import make_mesh, unbind_mesh
    from repro_torch.launch.sharding import (param_placements, shard_tree,
                                             spec_to_placements)
    from repro_torch.models.base import build_forward
    from repro_torch.models.layers import MeshInfo
    from repro_torch.models.moe import MoEBlock
    from repro_torch.models.registry import build_model
    from repro_torch.tree import tree_map
    ref = _ref_of(out)
    res = {}

    mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
    cfg = tp_cfg(get_smoke_config)
    model = build_model(cfg, MeshInfo(tp=4, dp=1))
    segs, _ = model.build_segments("train", B, S)
    fwd = build_forward(segs, "sequential",
                        ScheduleContext(local_batch=B, seq_len=S,
                                        phase="train"))
    params = shard_tree(to_torch(ref["tp4"]["params"]),
                        param_placements(model, segs), mesh)
    o = fwd(params, {k: torch.from_numpy(v) for k, v in
                     batch_np(cfg.vocab, B, S, 2).items()})
    res["tp4"] = {"loss": float(o["loss_sum"].sum() / o["token_count"].sum()),
                  "plans": plans_of(fwd)}
    unbind_mesh(mesh)

    mesh = make_mesh((4,), ("model",), device="cpu")
    mcfg = moe_arch(tconfigs)
    minfo = MeshInfo(tp=4, dp=1)
    x = to_torch(ref["moe"]["x"])
    for key, ts, xs in (("y_ts", True, x[:, 2 * rank:2 * rank + 2]),
                        ("y_rp", False, x)):
        blk = MoEBlock(mcfg, minfo, token_sharded=ts)
        p = shard_tree(to_torch(ref["moe"]["params" if ts else "params_rp"]),
                       tree_map(spec_to_placements, blk.param_pspecs()),
                       mesh)
        res[key] = to_np(blk.apply(p, xs))
    tw = ref["tokenweave"]
    s, h = tokenweave.fused_ar_add_rmsnorm(
        to_torch(tw["y_parts"])[rank], to_torch(tw["x"]), to_torch(tw["g"]),
        axis="model")
    res["tokenweave"] = {"s": to_np(s), "h": to_np(h)}
    unbind_mesh(mesh)

    mesh = make_mesh((4,), ("pod",), device="cpu")
    pp = ref["pipeline"]
    w = to_torch(pp["Ws"])[rank].clone().requires_grad_(True)
    y = pipeline_apply(lambda w, x: x @ w, w, to_torch(pp["mbs"]),
                       axis="pod")
    (y * to_torch(pp["cot"])[6 * rank:6 * rank + 6]).sum().backward()
    res["pipeline"] = to_np(y)
    res["pipeline_grad"] = to_np(w.grad)
    unbind_mesh(mesh)
    save(res, Path(out) / f"_ranks4_rank{rank}.pkl")
    dist.destroy_process_group()


def _ranks2(rank, world, port, out):
    """The data-parallel train step on 2 ranks."""
    init_rank(rank, world, port)
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import MeshInfo
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainStepConfig
    from repro_torch.train.step import _build_train_step
    ref = _ref_of(out)["dp"]
    make_mesh((2, 1), ("data", "model"), device="cpu")
    scfg = get_smoke_config("smollm-135m")
    model = build_model(scfg, MeshInfo(tp=1, dp=2))
    tcfg = TrainStepConfig(optimizer=AdamWConfig(lr=LR, eps=EPS),
                           remat=False, warmup=1, total_steps=5)
    step, _, _, init_opt = _build_train_step(model, "sequential", 2, S, tcfg)
    params = to_torch(ref["params"])
    batch = {k: torch.from_numpy(v[2 * rank:2 * rank + 2].copy())
             for k, v in batch_np(scfg.vocab, 4, S, 3).items()}
    params, _, m = step(params, init_opt(params), batch, 0)
    save({"after": to_np(params),
          "metrics": {k: float(v) for k, v in m.items()}},
         Path(out) / f"_ranks2_rank{rank}.pkl")
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    ref = run_reference("test_torch_distributed", out)
    return ref, run_ranks("test_torch_distributed", "_ranks4", 4, out), \
        run_ranks("test_torch_distributed", "_ranks2", 2, out)


@pytest.mark.parametrize("rank", range(4))
def test_tp_sharded_forward_matches_reference(runs, rank):
    """tp=4 train-phase loss on each rank == the reference's shard_map
    loss (and its tp=1 loss within the reference test's 5e-2)."""
    ref, r4, _ = runs
    got = r4[rank]["tp4"]["loss"]
    assert got == pytest.approx(ref["tp4"]["loss"], rel=2e-3)
    assert abs(got - ref["tp1_loss"]) < 5e-2 * max(abs(ref["tp1_loss"]), 1)


@pytest.mark.parametrize("rank", range(4))
def test_tp_plans_equal_reference(runs, rank):
    ref, r4, _ = runs
    got = r4[rank]["tp4"]["plans"]
    assert got == ref["tp4"]["plans"]


@pytest.mark.parametrize("rank", range(4))
def test_moe_token_sharded_vs_replicated(runs, rank):
    """Each rank's token-sharded output is its sequence shard of the
    reference's; the replicated block's output is the reference's whole;
    and the two layouts agree with each other."""
    ref, r4, _ = runs
    want_ts = f32(ref["moe"]["y_ts"])[:, 2 * rank:2 * rank + 2]
    got_ts = f32(r4[rank]["y_ts"])
    np.testing.assert_allclose(got_ts, want_ts, atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(f32(r4[rank]["y_rp"]), f32(ref["moe"]["y_rp"]),
                               atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(
        got_ts, f32(r4[rank]["y_rp"])[:, 2 * rank:2 * rank + 2],
        atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("rank", range(4))
def test_tokenweave_fused_collective_4_ranks(runs, rank):
    ref, r4, _ = runs
    tw, got = ref["tokenweave"], r4[rank]["tokenweave"]
    for k in ("s", "h"):
        np.testing.assert_allclose(f32(got[k]), f32(tw[k]), atol=1e-4)
        np.testing.assert_allclose(f32(got[k]), f32(tw[f"{k}_ref"]),
                                   atol=1e-4)


@pytest.mark.parametrize("rank", range(4))
def test_pipeline_driver_4_stages(runs, rank):
    """Each stage's buffer is its shard of the reference's; the last
    stage holds every microbatch through all four stages."""
    ref, r4, _ = runs
    got = f32(r4[rank]["pipeline"])
    np.testing.assert_allclose(
        got, f32(ref["pipeline"]["out"])[6 * rank:6 * rank + 6], atol=1e-4)
    if rank == 3:
        np.testing.assert_allclose(got, f32(ref["pipeline"]["mbs"]) * 24.0,
                                   atol=1e-4)


@pytest.mark.parametrize("rank", range(4))
def test_pipeline_backward_4_stages(runs, rank):
    """Each stage's weight gradient under a fixed cotangent equals the
    reference's ``jax.grad`` through its ``shard_map`` pipeline: the
    ring's ``ppermute`` transposes to the inverse permutation."""
    ref, r4, _ = runs
    np.testing.assert_allclose(f32(r4[rank]["pipeline_grad"]),
                               f32(ref["pipeline"]["grad"])[rank],
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("rank", range(2))
def test_grad_reduction_rules_dp(runs, rank):
    """dp=2: per-replica grads psum; the loss is normalized by the global
    tokens; each rank's step equals the reference's shard_map step and
    the single-device step over the whole batch."""
    ref, _, r2 = runs
    got, want = r2[rank], ref["dp"]
    assert got["metrics"]["tokens"] == want["metrics"]["tokens"] == 4 * S
    for wm in (want["metrics"], want["metrics_1dev"]):
        assert got["metrics"]["loss"] == pytest.approx(wm["loss"], rel=2e-3)
        assert got["metrics"]["grad_norm"] == pytest.approx(
            wm["grad_norm"], rel=2e-2)
    from repro_torch.tree import leaves_with_paths
    before = dict(leaves_with_paths(want["params"]))
    for after in (want["after"], want["after_1dev"]):
        mine = dict(leaves_with_paths(got["after"]))
        for path, leaf in leaves_with_paths(after):
            old = f32(before[path])
            assert rel(f32(mine[path]) - old, f32(leaf) - old) < 5e-2, path


def test_ppermute_and_pipeline_unbound_are_identities():
    from repro_torch.dist import collectives as col
    from repro_torch.dist.pipeline import pipeline_apply
    x = torch.arange(6.0).reshape(2, 3)
    assert col.ppermute(x, "pod", [(0, 1), (1, 0)]) is x
    mbs = torch.randn(3, 2, 4)
    w = torch.randn(4, 4)
    torch.testing.assert_close(pipeline_apply(lambda w, x: x @ w, w, mbs),
                               mbs @ w)
