"""The port's launch layer (``launch/{mesh,sharding,steps,serve}.py`` and
``api.compile(mesh=)``) against the JAX package's.

  * The chatglm3-6b (sequence parallel) and smollm-135m (not) smoke
    train steps at data=2 x model=2 under ``sequential`` and
    ``dynamic``: each rank's loss, grad norm and every updated leaf
    against the reference's ``shard_map`` step (its
    ``_build_global_train_step`` with ``lowered=False``).  These settle
    the collectives' backward rules: each one's backward is the
    transpose the reference's step takes under ``check_vma=False``
    (psum -> psum, all_gather <-> reduce_scatter).
  * Decode tiers at tp=2 share one lowering (3 misses, then shares), and
    the tier-2 step's rank-local logits and caches equal the reference's
    addressable shards.
  * Plans recorded on every rank equal the reference's for the same mesh.
  * ``global_batch_specs`` equals the reference's shapes and specs.
  * ``python -m repro_torch.launch.serve``: its greedy tokens on a smoke
    model equal ``compile(...).serve``'s and the reference engine's at
    ``lowered=False`` (or first differ at a near tie, as in
    ``tests/test_torch_serve.py``).
  * A one-rank mesh (an in-memory store, no environment) gives the
    no-mesh program's bits; ``serve`` and ``save`` refuse under a mesh.

Tolerances: as ``tests/test_torch_distributed.py`` states (train: loss
2e-3, grad_norm 2e-2, each leaf's update 5e-2 relative L2); decode logits
and caches within the bf16 limits of ``tests/test_torch_model.py``
(3e-2, atol scaled by the largest magnitude).
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_distributed import (LR, EPS, batch_np, f32, init_rank,
                                    plans_of, rel, run_ranks, run_reference,
                                    save, to_np, to_torch)

B_GLOBAL, S = 4, 16
POLICIES = ("sequential", "dynamic")
# chatglm3-6b is sequence parallel (all-gathers and reduce-scatters around
# each block); smollm-135m is not (a psum after each block, TokenWeave's
# reduce-scatter + all-gather under ``dynamic``)
TRAIN_ARCHS = ("chatglm3-6b", "smollm-135m")
STRATEGY = {("chatglm3-6b", "dynamic"): "nanoflow",
            ("smollm-135m", "dynamic"): "tokenweave"}
STEPS = 2
TIERS_S_MAX = 32


def _policy(name, jax_side):
    """``dynamic`` with thresholds that split or fuse at the test's size
    (``tests/test_torch_train.py``'s)."""
    if name != "dynamic":
        return name
    if jax_side:
        from repro.core.strategies.dynamic import dynamic_policy
    else:
        from repro_torch.core.strategies.dynamic import dynamic_policy
    return dynamic_policy(split_tokens=16, seq_tokens=4)


def _decode_batch(vocab, tier, s_max, seed):
    rng = np.random.default_rng(seed)
    return {"ids": rng.integers(0, vocab, (tier, 1)).astype(np.int32),
            "positions": np.full((tier, 1), 5, np.int32),
            "cache_len": np.full((tier,), 5, np.int32)}


# ---------------------------------------------------------------------------
# the reference side
# ---------------------------------------------------------------------------


def _reference(out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_smoke_config
    from repro.configs.base import ShapeConfig
    from repro.core.strategies import get_strategy
    from repro.launch.sharding import global_batch_specs
    from repro.launch.steps import (_build_global_decode_tiers,
                                    _build_global_train_step, _sched_info)
    from repro.models.base import build_forward
    from repro.models.layers import MeshInfo
    from repro.models.registry import build_model
    from repro.optim import AdamWConfig
    from repro.train.step import TrainStepConfig
    res = {"train": {}}
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    shape = ShapeConfig("train_smoke", S, B_GLOBAL, "train")
    tcfg = TrainStepConfig(optimizer=AdamWConfig(lr=LR, eps=EPS, block=64),
                           lowered=False, warmup=1, total_steps=10)
    for arch, name in ((a, n) for a in TRAIN_ARCHS for n in POLICIES):
        cfg = get_smoke_config(arch)
        policy = _policy(name, True)
        model = build_model(cfg, MeshInfo(tp=2, dp=2))
        fn, in_sdss, in_shd, _, init_opt, segs = _build_global_train_step(
            model, policy, shape, mesh, tcfg=tcfg)
        params = model._init_from_segments(segs, jax.random.PRNGKey(0),
                                           global_=True)
        p0 = to_np(params)
        params = jax.device_put(params, in_shd[0])
        opt = jax.device_put(init_opt(params), in_shd[1])
        step = jax.jit(fn)
        metrics = []
        for i in range(STEPS):
            batch = jax.device_put(
                {k: jnp.asarray(v) for k, v in
                 batch_np(cfg.vocab, B_GLOBAL, S, 10 + i).items()},
                in_shd[2])
            params, opt, m = step(params, opt, batch, jnp.int32(i))
            metrics.append({k: float(v) for k, v in m.items()})
        info = _sched_info(cfg.name, shape, B_GLOBAL // 2, mesh)
        fwd = build_forward(segs, policy, info, lowered=False)
        res["train"][(arch, name)] = {"params": p0, "after": to_np(params),
                                      "metrics": metrics,
                                      "plans": plans_of(fwd)}

    # decode tiers at tp=2, and the tier-2 step's outputs
    cfg = get_smoke_config("chatglm3-6b")
    mesh2 = jax.make_mesh((1, 2), ("data", "model"),
                          devices=jax.devices()[:2],
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    model = build_model(cfg, MeshInfo(tp=2, dp=1))
    dshape = ShapeConfig("decode_smoke", TIERS_S_MAX, 4, "decode")
    tiers = _build_global_decode_tiers(model, get_strategy("sequential"),
                                       dshape, mesh2, lowered=False)
    fn, in_sdss, in_shd, _, segs = tiers[2]
    params = model._init_from_segments(segs, jax.random.PRNGKey(0),
                                       global_=True)
    batch = {k: jnp.asarray(v) for k, v in
             _decode_batch(cfg.vocab, 2, TIERS_S_MAX, 4).items()}
    rng = np.random.default_rng(5)
    for k, sds in in_sdss[1].items():
        if k not in batch:
            batch[k] = jnp.asarray(rng.standard_normal(sds.shape),
                                   sds.dtype)
    outs = jax.jit(fn)(jax.device_put(params, in_shd[0]),
                       jax.device_put(batch, in_shd[1]))
    info = _sched_info(cfg.name, dataclasses_replace(dshape, 2), 2, mesh2)
    res["decode"] = {"tiers": sorted(tiers), "params": to_np(params),
                     "batch": to_np(batch), "outs": to_np(outs),
                     "ids_shape": tuple(in_sdss[1]["ids"].shape),
                     "plans": plans_of(build_forward(
                         segs, get_strategy("sequential"), info,
                         lowered=False))}

    # global batch specs
    specs = {}
    for arch in ("chatglm3-6b", "deepseek-moe-16b", "qwen2-vl-7b"):
        m = build_model(get_smoke_config(arch), MeshInfo(tp=2, dp=2))
        for phase, gb in (("train", 4), ("prefill", 4), ("prefill", 1),
                          ("decode", 4), ("decode", 1)):
            sdss, shds, B_loc, repl = global_batch_specs(
                m, phase, 16, gb, mesh, s_max=32)
            specs[(arch, phase, gb)] = (
                {k: (tuple(v.shape), str(v.dtype)) for k, v in sdss.items()},
                {k: tuple(_entry(e) for e in s.spec)
                 for k, s in shds.items()}, B_loc, repl)
    res["specs"] = specs
    save(res, Path(out) / "ref.pkl")


def dataclasses_replace(shape, tier):
    import dataclasses
    return dataclasses.replace(shape, name=f"{shape.name}@{tier}",
                               global_batch=tier)


def _entry(e):
    if e is None:
        return ()
    return (e,) if isinstance(e, str) else tuple(e)


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------


def _ref_of(out):
    import pickle
    with open(Path(out) / "ref.pkl", "rb") as f:
        return pickle.load(f)


def _train4(rank, world, port, out):
    init_rank(rank, world, port)
    import torch.distributed as dist

    from repro_torch.api import compile
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import shard_tree, unshard_tree
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainStepConfig
    from repro_torch.tree import leaves
    ref = _ref_of(out)["train"]
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    tcfg = TrainStepConfig(optimizer=AdamWConfig(lr=LR, eps=EPS, block=64),
                           warmup=1, total_steps=10)
    res = {}
    for arch, name in ((a, n) for a in TRAIN_ARCHS for n in POLICIES):
        prog = compile(arch, smoke=True, device="cpu", mesh=mesh,
                       policy=_policy(name, False))
        step = prog.train_step(B_GLOBAL, S, cfg=tcfg)
        p_place, _, b_place, _ = step.in_placements
        full = to_torch(ref[(arch, name)]["params"])
        params = shard_tree(full, p_place, mesh)
        back = unshard_tree(params, p_place)
        round_trip = all(torch.equal(a, b) for a, b in
                         zip(leaves(back), leaves(full)))
        # init_params under the mesh, gathered: held to the one-device
        # program's tree in the test process (a program built here for
        # one device would read the bound axes)
        drawn = (to_np(unshard_tree(prog.init_params(0), p_place))
                 if name == POLICIES[0] else None)
        opt = step.init_opt(params)
        metrics = []
        for i in range(STEPS):
            batch = shard_tree(
                {k: torch.from_numpy(v) for k, v in
                 batch_np(prog.model.cfg.vocab, B_GLOBAL, S, 10 + i).items()},
                b_place, mesh)
            params, opt, m = step(params, opt, batch, i)
            metrics.append({k: float(v) for k, v in m.items()})
        res[(arch, name)] = {"after": to_np(params), "metrics": metrics,
                             "round_trip": round_trip,
                             "drawn": drawn,
                     "plans": plans_of(step.fn.forward),
                     "strategies": dict(step.strategies),
                     "placements": p_place}
    save(res, Path(out) / f"_train4_rank{rank}.pkl")
    dist.destroy_process_group()


def _tiers2(rank, world, port, out):
    init_rank(rank, world, port)
    import torch.distributed as dist

    from repro_torch.api import compile
    from repro_torch.core.plan_store import PlanStore
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import shard_tree
    ref = _ref_of(out)["decode"]
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    store = PlanStore()
    prog = compile("chatglm3-6b", smoke=True, device="cpu", mesh=mesh,
                   policy="sequential", plan_store=store)
    tiers = prog.decode_tiers(4, TIERS_S_MAX)
    stats = dict(store.stats)
    st = tiers[2]
    p_place, b_place = st.in_placements
    params = shard_tree(to_torch(ref["params"]), p_place, mesh)
    batch = shard_tree(to_torch(ref["batch"]), b_place, mesh)
    outs = st.fn(params, {k: v.clone() for k, v in batch.items()})
    save({"tiers": sorted(tiers), "stats": stats,
          "ids_shape": tuple(st.in_specs[1]["ids"].shape),
          "outs": to_np(outs), "out_placements": st.out_placements,
          "plans": plans_of(st.fn.fwd)},
         Path(out) / f"_tiers2_rank{rank}.pkl")
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("launch")
    ref = run_reference("test_torch_launch", out)
    return (ref, run_ranks("test_torch_launch", "_train4", 4, out),
            run_ranks("test_torch_launch", "_tiers2", 2, out))


def _coords(rank, shape=(2, 2), axes=("data", "model")):
    return dict(zip(axes, np.unravel_index(rank, shape)))


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_data2_model2_matches_reference(runs, arch, policy,
                                                   rank):
    from repro_torch.launch.sharding import shard
    from repro_torch.tree import leaves_with_paths
    ref, r4, _ = runs
    want, got = ref["train"][(arch, policy)], r4[rank][(arch, policy)]
    for wm, tm in zip(want["metrics"], got["metrics"]):
        assert tm["tokens"] == wm["tokens"]
        assert tm["lr"] == pytest.approx(wm["lr"], rel=1e-6)
        assert tm["loss"] == pytest.approx(wm["loss"], rel=2e-3)
        assert tm["grad_norm"] == pytest.approx(wm["grad_norm"], rel=2e-2)
    sizes, coord = {"data": 2, "model": 2}, _coords(rank)
    place = dict(leaves_with_paths(got["placements"]))
    before = dict(leaves_with_paths(want["params"]))
    mine = dict(leaves_with_paths(got["after"]))
    for path, leaf in leaves_with_paths(want["after"]):
        cut = (lambda a: shard(to_torch(a), place.get(path, ()), sizes,
                               coord))
        old = f32(cut(before[path]))
        assert rel(f32(mine[path]) - old, f32(cut(leaf)) - old) < 5e-2, path


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_unshard_tree_inverts_shard_tree(runs, arch):
    """Every rank's all-gathers rebuild the global params bit for bit."""
    r4 = runs[1]
    assert all(r4[rank][(arch, p)]["round_trip"] for rank in range(4)
               for p in POLICIES)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_init_params_under_a_mesh_is_a_shard_of_the_global_draw(runs,
                                                                arch):
    """Each rank's ``init_params(0)`` gathered over the mesh is the
    one-device program's tree: the values do not depend on the mesh."""
    from repro_torch.api import compile
    from repro_torch.tree import leaves_with_paths
    alone = dict(leaves_with_paths(compile(arch, smoke=True, device="cpu")
                                   .init_params(0)))
    r4 = runs[1]
    for rank in range(4):
        got = dict(leaves_with_paths(r4[rank][(arch, POLICIES[0])]["drawn"]))
        assert sorted(got) == sorted(alone)
        for path, want in alone.items():
            np.testing.assert_array_equal(got[path], f32(want), str(path))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_plans_equal_reference_on_every_rank(runs, arch, policy):
    ref, r4, _ = runs
    key = (arch, policy)
    for rank in range(4):
        assert r4[rank][key]["plans"] == ref["train"][key]["plans"]
    assert r4[0][key]["strategies"]["layers"] == STRATEGY.get(key, policy)


def test_decode_tiers_share_one_lowering_tp2(runs):
    ref, _, r2 = runs
    for got in r2:
        assert got["tiers"] == ref["decode"]["tiers"] == [1, 2, 4]
        # the first tier lowers each segment once; tiers 2 and 4 share
        assert got["stats"]["misses"] == 3, got["stats"]
        assert got["stats"]["shares"] == 6, got["stats"]
        assert got["ids_shape"] == ref["decode"]["ids_shape"] == (2, 1)
        assert got["plans"] == ref["decode"]["plans"]


@pytest.mark.parametrize("rank", range(2))
def test_decode_tier_step_matches_reference_shards(runs, rank):
    from repro_torch.launch.sharding import shard
    ref, _, r2 = runs
    got = r2[rank]
    sizes, coord = {"data": 1, "model": 2}, {"data": 0, "model": rank}
    assert sorted(got["outs"]) == sorted(ref["decode"]["outs"])
    for k, want in ref["decode"]["outs"].items():
        want = f32(shard(to_torch(want), got["out_placements"][k], sizes,
                         coord))
        have = f32(got["outs"][k])
        assert have.shape == want.shape, k
        if k == "logits":
            want, have = np.maximum(want, -1e4), np.maximum(have, -1e4)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(have, want, atol=3e-2 * scale, rtol=3e-2,
                                   err_msg=k)


def test_global_batch_specs_match_reference(runs):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.sharding import global_batch_specs
    from repro_torch.models.layers import MeshInfo
    from repro_torch.models.registry import build_model
    ref = runs[0]["specs"]
    sizes = {"data": 2, "model": 2}
    for (arch, phase, gb), (shapes, specs, B_loc, repl) in ref.items():
        m = build_model(get_smoke_config(arch), MeshInfo(tp=2, dp=2))
        got, places, b, r = global_batch_specs(m, phase, 16, gb, sizes,
                                               s_max=32)
        assert (b, r) == (B_loc, repl)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: v[0] for k, v in shapes.items()}
        for k, spec in specs.items():
            want = tuple(spec) + ((),) * (len(shapes[k][0]) - len(spec))
            assert places[k] == want, (arch, phase, gb, k)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


CLI_ARGS = ["--smoke", "--device", "cpu", "--requests", "6", "--max-new",
            "6"]


def test_cli_tokens_equal_serve_and_reference(monkeypatch, capsys):
    import jax

    from repro.configs import get_smoke_config as jget_smoke
    from repro.models.layers import MeshInfo as JMeshInfo
    from repro.models.registry import build_model as jbuild_model
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServeConfig as JServeConfig
    from repro.serve.engine import ServeEngine as JServeEngine
    from repro_torch import api
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch import serve as cli
    from repro_torch.serve import Request, ServeConfig
    from test_torch_serve import reference_margin
    jm = jbuild_model(jget_smoke("chatglm3-6b"), JMeshInfo())
    jparams = jm.init_params(jax.random.PRNGKey(0), phase="prefill")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    # the CLI draws its params from init_params(0): hand it the
    # reference's, so all three engines serve one model
    monkeypatch.setattr(api.Program, "init_params",
                        lambda self, seed=0, **kw: tparams)
    done = cli.main(CLI_ARGS)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("served 6 requests, 36 tokens in ")
    assert lines[1].startswith("decode tier mix: ")
    assert lines[2].startswith("TTFT p50=")
    got = {r.rid: list(r.output) for r in done}
    prompts = {r.rid: np.asarray(r.prompt) for r in done}
    cfg = dict(max_batch=4, s_max=128, prefill_buckets=(16, 32, 64),
               prefill_batch=4)
    prog = api.compile("chatglm3-6b", smoke=True, device="cpu")
    eng = prog.serve(tparams, ServeConfig(**cfg))
    ref = JServeEngine(jm, jparams, "dynamic",
                       JServeConfig(lowered=False, **cfg))
    for rid, p in sorted(prompts.items()):
        eng.submit(Request(rid, p, max_new_tokens=6))
        ref.submit(JRequest(rid, p, max_new_tokens=6))
    same = {r.rid: list(r.output) for r in eng.run()}
    want = {r.rid: list(r.output) for r in ref.run()}
    assert got == same
    for rid, toks in got.items():
        first = next((i for i in range(6) if toks[i] != want[rid][i]), None)
        if first is None:
            continue
        margin, bound, tie = reference_margin(
            jm, jparams, list(prompts[rid]) + want[rid][:first], monkeypatch)
        assert margin < bound or tie, (rid, first, margin, bound)


def test_cli_flags_are_the_references_plus_device():
    import argparse
    import repro.launch.serve as jserve
    import repro_torch.launch.serve as tserve

    def flags(mod):
        seen = []
        real = argparse.ArgumentParser.add_argument

        def spy(self, *a, **k):
            seen.append(a[0])
            return real(self, *a, **k)
        argparse.ArgumentParser.add_argument = spy
        try:
            with pytest.raises(SystemExit):
                mod.main(["--help"])
        finally:
            argparse.ArgumentParser.add_argument = real
        return [f for f in seen if f != "-h"]
    assert flags(tserve) == [f for f in flags(jserve)[:2]] + ["--device"] \
        + flags(jserve)[2:]


# ---------------------------------------------------------------------------
# one rank in this process
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh, unbind_mesh
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    try:
        yield mesh
    finally:
        unbind_mesh(mesh)
        dist.destroy_process_group()


def test_one_rank_mesh_equals_no_mesh(one_rank):
    from repro_torch.api import ProgramBundleError, compile
    from repro_torch.tree import leaves
    plain = compile("chatglm3-6b", smoke=True, device="cpu")
    meshed = compile("chatglm3-6b", smoke=True, device="cpu", mesh=one_rank)
    params = plain.init_params(0)
    assert all(torch.equal(a, b) for a, b in
               zip(leaves(params), leaves(meshed.init_params(0))))
    batch = {k: torch.from_numpy(v) for k, v in
             batch_np(128, 2, 16, 0, labels=False).items()}
    a = plain.prefill(2, 16).fn(params, batch)
    b = meshed.prefill(2, 16).fn(params, batch)
    assert torch.equal(a["logits"], b["logits"])
    assert torch.equal(a["layers.k"], b["layers.k"])
    da = plain.decode_tiers(4, 32, tiers=(2,))[2]
    db = meshed.decode_tiers(4, 32, tiers=(2,))[2]
    dec = {k: torch.from_numpy(v) for k, v in
           _decode_batch(128, 2, 32, 1).items()}
    for k, spec in db.in_specs[1].items():
        if k not in dec:
            dec[k] = torch.randn(spec.shape, generator=torch.Generator()
                                 .manual_seed(2)).to(spec.dtype)
    oa = da.fn(params, {k: v.clone() for k, v in dec.items()})
    ob = db.fn(params, {k: v.clone() for k, v in dec.items()})
    for k in ob:
        assert torch.equal(oa[k], ob[k]), k
    with pytest.raises(NotImplementedError, match="single-host"):
        meshed.serve(params)
    with pytest.raises(ProgramBundleError, match="single-host"):
        meshed.save("unused.bundle")


def test_make_mesh_refuses_a_shape_the_world_lacks(one_rank):
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh((2, 2), ("data", "model"), device="cpu")
    for multi, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {n} ranks; the world "
                           "has 1"):
            make_production_mesh(multi_pod=multi, device="cpu")


def test_mesh_info_from_mesh_and_closure_config(one_rank):
    from repro_torch.api import compile
    from repro_torch.launch.mesh import make_mesh_info, mesh_shape_dict
    from repro_torch.models.layers import MeshInfo
    assert mesh_shape_dict(one_rank) == {"data": 1, "model": 1}
    info = make_mesh_info(one_rank, fsdp=True, fsdp_resident=True)
    assert info == MeshInfo(tp=1, dp=1, pods=1, fsdp=True, fsdp_resident=True)
    assert info.dp_axes == ("data",) and MeshInfo(pods=2).dp_axes == (
        "pod", "data")
    prog = compile("grok-1-314b", smoke=True, device="cpu", mesh=one_rank,
                   mesh_info=info)
    assert dict(prog.model.op_closure_config())["fsdp_resident"] is True
