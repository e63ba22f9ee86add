"""The port's FSDP layers and grok-1-314b against the JAX package.

  * ``ShardedLinear`` over four data ranks: the resident decode linear
    (``DataShardedLinearOp``) equals the gathered one (``WeightGatherOp``
    + ``LinearOp(owns_weight=False)``), both equal the reference's
    ``shard_map`` outputs, and the gathered weight's gradient comes back
    to each rank's shard as the reference's does.
  * Experts over four data ranks: the ff-sharded GEMM's partials psum'd
    over 'data' and the zero3 ``ExpertFFN`` (gathers + grouped FFN) equal
    the dense experts and the reference's; the zero3 weights' gradients
    equal the reference's shards.
  * ``launch.sharding.shard_tree`` cuts, for every leaf of a dense, an
    MoE and a grok smoke model, with and without FSDP (gathered and
    resident layouts), the bits JAX's ``NamedSharding`` gives the device
    at each coordinate of a data=2 x model=2 mesh.
  * grok-1-314b: the config is the reference's; its smoke model's
    prefill and decode match the reference's on one device, and on a
    one-rank mesh its FSDP modes (zero3 prefill, resident and ff-sharded
    decode) give the bits of the model built without FSDP.

Tolerances: 1e-5 (linear, f32) and 1e-4 (experts, f32) as the
reference's tests; the smoke model's logits within the bf16 limits of
``tests/test_torch_model.py`` (3e-2, atol scaled by the largest
magnitude); shards and one-rank FSDP bit for bit.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_distributed import (EPS, LR, batch_np, f32, init_rank,
                                    moe_arch, rel, run_ranks, run_reference,
                                    save, to_np, to_torch)

D_IN, D_OUT, NB = 32, 16, 4
ARCHS = ("chatglm3-6b", "deepseek-moe-16b", "grok-1-314b")
LAYOUTS = ("plain", "fsdp", "fsdp_resident")
# train steps at data=2 x model=2 under ``sequential``: FSDP (gathers,
# zero3 experts; their leaves skip the data psum) and the MoE without it
TRAIN = (("chatglm3-6b", True), ("deepseek-moe-16b", False),
         ("deepseek-moe-16b", True))
B_TRAIN, S_TRAIN = 4, 16
# the MoE embedding's update, as tests/test_torch_moe_train.py holds it
EMBED, EMBED_LIMIT = ("embed", "emb", "w"), 1e-1


def _layout_info(pkg_meshinfo, layout, tp=2, dp=2):
    return pkg_meshinfo(tp=tp, dp=dp, fsdp=layout != "plain",
                        fsdp_resident=layout == "fsdp_resident")


def _phase(layout):
    return "decode" if layout == "fsdp_resident" else "prefill"


def _moe_cfg(pkg):
    return pkg.MoEConfig(n_experts=2, top_k=1, d_ff_expert=16)


# ---------------------------------------------------------------------------
# the reference side
# ---------------------------------------------------------------------------


def _reference(out):
    import jax
    import jax.numpy as jnp
    import jax.tree_util as jtu
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs import base as jbase
    from repro.configs import get_config, get_smoke_config
    from repro.launch.sharding import global_param_specs, spec_to_p
    from repro.models.layers import MeshInfo, ShardedLinear
    from repro.models.moe import ExpertFFN, ExpertGEMMOp, FFShardedExpertGEMM
    from repro.models.registry import build_model
    res = {}
    mesh = jax.make_mesh((4, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)

    def pspec(mod):
        return jtu.tree_map(spec_to_p, mod.param_pspecs(),
                            is_leaf=lambda v: isinstance(v, tuple))

    def put(tree, spec):
        return jax.device_put(tree, jtu.tree_map(
            lambda sp: NamedSharding(mesh, sp), spec,
            is_leaf=lambda v: isinstance(v, P)))

    # -- ShardedLinear: resident against gathered, and the gather's grad --
    x = jax.random.normal(jax.random.PRNGKey(0), (NB, 1, D_IN))
    w = jax.random.normal(jax.random.PRNGKey(1), (D_IN, D_OUT))
    ct = jax.random.normal(jax.random.PRNGKey(2), (NB, 1, D_OUT))
    lin_out = {"x": to_np(x), "w": to_np(w), "ct": to_np(ct)}
    for resident in (False, True):
        minfo = MeshInfo(tp=1, dp=4, fsdp=True, fsdp_resident=resident)
        lin = ShardedLinear(D_IN, D_OUT, "proj", minfo, dtype=jnp.float32)
        params = {"lin" if resident else "gather": {"w": w}}
        spec = pspec(lin)
        f = jax.shard_map(lambda p, x: lin.apply(p, x), mesh=mesh,
                          in_specs=(spec, P()), out_specs=P(),
                          check_vma=False)
        lin_out[f"y_{resident}"] = to_np(jax.jit(f)(put(params, spec), x))
        if not resident:
            g = jax.shard_map(
                jax.grad(lambda p, x: jnp.sum(lin.apply(p, x) * ct)),
                mesh=mesh, in_specs=(spec, P()), out_specs=spec,
                check_vma=False)
            lin_out["grad"] = to_np(jax.jit(g)(put(params, spec), x))
    res["linear"] = lin_out

    # -- experts: ff-sharded partials, zero3, dense -------------------------
    m = _moe_cfg(jbase)
    d = 8
    buf = jax.random.normal(jax.random.PRNGKey(0), (2, 4, d))
    ctb = jax.random.normal(jax.random.PRNGKey(3), (2, 4, d))
    dense = ExpertGEMMOp(d, m, MeshInfo(tp=1, dp=4), dtype=jnp.float32)
    pd = dense.init(jax.random.PRNGKey(1), global_=True)
    ex = {"buf": to_np(buf), "ct": to_np(ctb), "dense_params": to_np(pd),
          "want": to_np(dense.apply(pd, buf))}
    ff = FFShardedExpertGEMM(d, m, MeshInfo(tp=1, dp=4, fsdp=True),
                             dtype=jnp.float32)
    pf = ff.init(jax.random.PRNGKey(1), global_=True)
    f = jax.shard_map(lambda p, x: jax.lax.psum(ff.apply(p, x), "data"),
                      mesh=mesh, in_specs=(pspec(ff), P()), out_specs=P(),
                      check_vma=False)
    ex["ff_params"] = to_np(pf)
    ex["ff"] = to_np(jax.jit(f)(put(pf, pspec(ff)), buf))
    z3 = ExpertFFN(d, m, MeshInfo(tp=1, dp=4, fsdp=True), dtype=jnp.float32)
    pz = {"g1": {"w": pd["w1"]}, "g3": {"w": pd["w3"]},
          "g2": {"w": pd["w2"]}}
    f = jax.shard_map(lambda p, x: z3.apply(p, x), mesh=mesh,
                      in_specs=(pspec(z3), P()), out_specs=P(),
                      check_vma=False)
    ex["zero3"] = to_np(jax.jit(f)(put(pz, pspec(z3)), buf))
    g = jax.shard_map(jax.grad(lambda p, x: jnp.sum(z3.apply(p, x) * ctb)),
                      mesh=mesh, in_specs=(pspec(z3), P()),
                      out_specs=pspec(z3), check_vma=False)
    ex["zero3_grad"] = to_np(jax.jit(g)(put(pz, pspec(z3)), buf))
    res["experts"] = ex

    # -- the replicated MoE block under FSDP: ff-sharded experts + ar_dp --
    from repro import configs as jconfigs
    from repro.models.moe import MoEBlock
    blk = MoEBlock(moe_arch(jconfigs), MeshInfo(tp=1, dp=4, fsdp=True),
                   token_sharded=False)
    pb = blk.init(jax.random.PRNGKey(0), global_=True)
    xb = jax.random.normal(jax.random.PRNGKey(1), (2, 8, 16), jnp.bfloat16)
    f = jax.shard_map(blk.apply, mesh=mesh, in_specs=(pspec(blk), P()),
                      out_specs=P(), check_vma=False)
    res["moe_block"] = {"params": to_np(pb), "x": to_np(xb),
                        "y": to_np(jax.jit(f)(put(pb, pspec(blk)), xb))}

    # -- train steps at data=2 x model=2 --------------------------------------
    from repro.configs.base import ShapeConfig
    from repro.launch.steps import _build_global_train_step
    from repro.optim import AdamWConfig
    from repro.train.step import TrainStepConfig
    mesh22 = jax.make_mesh((2, 2), ("data", "model"),
                           axis_types=(jax.sharding.AxisType.Auto,) * 2)
    tcfg = TrainStepConfig(optimizer=AdamWConfig(lr=LR, eps=EPS, block=64),
                           lowered=False, warmup=1, total_steps=10)
    shape = ShapeConfig("train_smoke", S_TRAIN, B_TRAIN, "train")
    train = {}
    for arch, fsdp in TRAIN:
        cfg = get_smoke_config(arch)
        model = build_model(cfg, MeshInfo(tp=2, dp=2, fsdp=fsdp))
        fn, _, in_shd, _, init_opt, segs = _build_global_train_step(
            model, "sequential", shape, mesh22, tcfg=tcfg)
        params = model._init_from_segments(segs, jax.random.PRNGKey(0),
                                           global_=True)
        p0 = to_np(params)
        params = jax.device_put(params, in_shd[0])
        batch = jax.device_put({k: jnp.asarray(v) for k, v in batch_np(
            cfg.vocab, B_TRAIN, S_TRAIN, 20).items()}, in_shd[2])
        params, _, m = jax.jit(fn)(params, jax.device_put(
            init_opt(params), in_shd[1]), batch, jnp.int32(0))
        train[(arch, fsdp)] = {"params": p0, "after": to_np(params),
                               "metrics": {k: float(v) for k, v in m.items()}}
    res["train"] = train

    # -- NamedSharding's shards of every leaf, data=2 x model=2 ------------
    mesh22 = jax.make_mesh((2, 2), ("data", "model"),
                           axis_types=(jax.sharding.AxisType.Auto,) * 2)
    coords = {dev.id: dict(zip(("data", "model"), (int(i), int(j))))
              for (i, j), dev in np.ndenumerate(mesh22.devices)}
    shards = {}
    for arch in ARCHS:
        for layout in LAYOUTS:
            model = build_model(get_smoke_config(arch),
                                _layout_info(MeshInfo, layout))
            segs, _ = model.build_segments(_phase(layout), 2, 4, s_max=8)
            pg = model._init_from_segments(segs, jax.random.PRNGKey(0),
                                           global_=True)
            _, shd = global_param_specs(model, segs, mesh22)
            placed = jax.device_put(pg, shd)
            per = {}
            for path, leaf in jtu.tree_leaves_with_path(placed):
                key = tuple(k.key for k in path)
                per[key] = {
                    tuple(sorted(coords[s.device.id].items())):
                        to_np(np.asarray(s.data))
                    for s in leaf.addressable_shards}
            shards[(arch, layout)] = {"global": to_np(pg), "shards": per}
    res["shards"] = shards

    # -- grok-1-314b's config -----------------------------------------------
    res["grok_config"] = dataclasses.asdict(get_config("grok-1-314b"))
    save(res, Path(out) / "ref.pkl")


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------


def _ranks4(rank, world, port, out):
    init_rank(rank, world, port)
    import pickle

    import torch.distributed as dist

    from repro_torch.configs import base as tbase
    from repro_torch.dist import collectives as col
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import shard_tree, spec_to_placements
    from repro_torch.models.layers import MeshInfo, ShardedLinear
    from repro_torch.models.moe import (ExpertFFN, ExpertGEMMOp,
                                        FFShardedExpertGEMM)
    from repro_torch.tree import tree_map
    with open(Path(out) / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    mesh = make_mesh((4, 1), ("data", "model"), device="cpu")

    def local(mod, tree):
        return shard_tree(to_torch(tree), tree_map(
            spec_to_placements, mod.param_pspecs()), mesh)

    res = {}
    lr = ref["linear"]
    x, w, ct = (to_torch(lr[k]) for k in ("x", "w", "ct"))
    for resident in (False, True):
        minfo = MeshInfo(tp=1, dp=4, fsdp=True, fsdp_resident=resident)
        lin = ShardedLinear(D_IN, D_OUT, "proj", minfo, dtype=torch.float32)
        p = local(lin, {"lin" if resident else "gather": {"w": w}})
        res[f"mode_{resident}"] = lin.mode
        res[f"y_{resident}"] = to_np(lin.apply(p, x))
        if not resident:
            leaf = p["gather"]["w"].requires_grad_()
            (lin.apply(p, x) * ct).sum().backward()
            res["grad"] = to_np({"gather": {"w": leaf.grad}})
    ex = ref["experts"]
    buf, ctb = to_torch(ex["buf"]), to_torch(ex["ct"])
    m = _moe_cfg(tbase)
    ff = FFShardedExpertGEMM(8, m, MeshInfo(tp=1, dp=4, fsdp=True),
                             dtype=torch.float32)
    res["ff"] = to_np(col.psum(ff.apply(local(ff, ex["ff_params"]), buf),
                               "data"))
    z3 = ExpertFFN(8, m, MeshInfo(tp=1, dp=4, fsdp=True),
                   dtype=torch.float32)
    pd = ex["dense_params"]
    pz = local(z3, {"g1": {"w": pd["w1"]}, "g3": {"w": pd["w3"]},
                    "g2": {"w": pd["w2"]}})
    for v in pz.values():
        v["w"].requires_grad_()
    y = z3.apply(pz, buf)
    (y * ctb).sum().backward()
    res["zero3"] = to_np(y)
    res["zero3_grad"] = to_np({k: {"w": v["w"].grad} for k, v in pz.items()})
    res["modes"] = (z3.mode, ExpertFFN(8, m, MeshInfo(tp=1, dp=4, fsdp=True),
                                       ff_shard=True).mode,
                    ExpertFFN(8, m, MeshInfo(tp=1, dp=4)).mode)
    dense = ExpertGEMMOp(8, m, MeshInfo(tp=1, dp=4), dtype=torch.float32)
    res["dense"] = to_np(dense.apply(to_torch(pd), buf))
    from repro_torch import configs as tconfigs
    from repro_torch.models.moe import MoEBlock
    blk = MoEBlock(moe_arch(tconfigs), MeshInfo(tp=1, dp=4, fsdp=True),
                   token_sharded=False)
    mb = ref["moe_block"]
    res["moe_block"] = to_np(blk.apply(local(blk, mb["params"]),
                                       to_torch(mb["x"])))
    save(res, Path(out) / f"_ranks4_rank{rank}.pkl")
    dist.destroy_process_group()


def _train4(rank, world, port, out):
    init_rank(rank, world, port)
    import pickle

    import torch.distributed as dist

    from repro_torch.api import compile
    from repro_torch.launch.mesh import make_mesh, make_mesh_info
    from repro_torch.launch.sharding import shard_tree
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainStepConfig
    with open(Path(out) / "ref.pkl", "rb") as f:
        ref = pickle.load(f)["train"]
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    tcfg = TrainStepConfig(optimizer=AdamWConfig(lr=LR, eps=EPS, block=64),
                           warmup=1, total_steps=10)
    res = {}
    for arch, fsdp in TRAIN:
        prog = compile(arch, smoke=True, device="cpu", policy="sequential",
                       mesh=mesh, mesh_info=make_mesh_info(mesh, fsdp=fsdp))
        step = prog.train_step(B_TRAIN, S_TRAIN, cfg=tcfg)
        p_place, _, b_place, _ = step.in_placements
        params = shard_tree(to_torch(ref[(arch, fsdp)]["params"]), p_place,
                            mesh)
        batch = shard_tree({k: torch.from_numpy(v) for k, v in batch_np(
            prog.model.cfg.vocab, B_TRAIN, S_TRAIN, 20).items()}, b_place,
            mesh)
        params, _, m = step(params, step.init_opt(params), batch, 0)
        res[(arch, fsdp)] = {"after": to_np(params), "placements": p_place,
                             "metrics": {k: float(v) for k, v in m.items()}}
    save(res, Path(out) / f"_train4_rank{rank}.pkl")
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("fsdp")
    ref = run_reference("test_torch_fsdp", out)
    return (ref, run_ranks("test_torch_fsdp", "_ranks4", 4, out),
            run_ranks("test_torch_fsdp", "_train4", 4, out))


@pytest.mark.parametrize("rank", range(4))
def test_fsdp_resident_decode_linear_matches_gathered(runs, rank):
    ref, r4, _ = runs
    got, lr = r4[rank], ref["linear"]
    assert (got["mode_False"], got["mode_True"]) == ("gather", "resident")
    for resident in (False, True):
        np.testing.assert_allclose(f32(got[f"y_{resident}"]),
                                   f32(lr[f"y_{resident}"]),
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(f32(got["y_False"]), f32(got["y_True"]),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("rank", range(4))
def test_weight_gather_grad_reaches_each_shard(runs, rank):
    """The gathered weight's gradient, reduce-scattered back to this
    rank's shard (the all-gather's transpose), equals the reference's."""
    ref, r4, _ = runs
    want = f32(ref["linear"]["grad"]["gather"]["w"])
    n = want.shape[0] // 4
    np.testing.assert_allclose(f32(r4[rank]["grad"]["gather"]["w"]),
                               want[rank * n:(rank + 1) * n],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("rank", range(4))
def test_ff_sharded_and_zero3_experts_match_dense_experts(runs, rank):
    ref, r4, _ = runs
    got, ex = r4[rank], ref["experts"]
    assert got["modes"] == ("zero3", "ff_sharded", "resident")
    for k in ("ff", "zero3"):
        np.testing.assert_allclose(f32(got[k]), f32(ex[k]), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(f32(got[k]), f32(ex["want"]), atol=1e-4,
                                   rtol=1e-4)
    np.testing.assert_allclose(f32(got["dense"]), f32(ex["want"]),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("rank", range(4))
def test_zero3_expert_grads_match_reference_shards(runs, rank):
    ref, r4, _ = runs
    want = ref["experts"]["zero3_grad"]
    for name, gdim in (("g1", 2), ("g3", 2), ("g2", 1)):
        w = f32(want[name]["w"])
        n = w.shape[gdim] // 4
        np.testing.assert_allclose(
            f32(r4[rank]["zero3_grad"][name]["w"]),
            np.take(w, range(rank * n, (rank + 1) * n), axis=gdim),
            atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("rank", range(4))
def test_moe_block_under_fsdp_psums_over_data(runs, rank):
    """The replicated block's ff-sharded experts and its psum over
    'data' (``ar_dp``) give the reference's output on every rank."""
    ref, r4, _ = runs
    want = f32(ref["moe_block"]["y"])
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(f32(r4[rank]["moe_block"]), want,
                               atol=3e-2 * scale, rtol=3e-2)


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("arch,fsdp", TRAIN)
def test_train_step_data2_model2_fsdp_matches_reference(runs, arch, fsdp,
                                                        rank):
    """The train step at data=2 x model=2 with FSDP's gathers (their
    gradients reduce-scattered back to the shards, which skip the data
    psum) and the MoE without FSDP, against the reference's shards, with
    ``tests/test_torch_train.py``'s and ``test_torch_moe_train.py``'s
    limits."""
    from repro_torch.launch.sharding import shard
    from repro_torch.tree import leaves_with_paths
    ref, _, t4 = runs
    want, got = ref["train"][(arch, fsdp)], t4[rank][(arch, fsdp)]
    wm, tm = want["metrics"], got["metrics"]
    assert tm["tokens"] == wm["tokens"] == B_TRAIN * S_TRAIN
    assert tm["loss"] == pytest.approx(wm["loss"], rel=2e-3)
    assert tm["grad_norm"] == pytest.approx(wm["grad_norm"], rel=2e-2)
    sizes = {"data": 2, "model": 2}
    coord = dict(zip(("data", "model"), divmod(rank, 2)))
    place = dict(leaves_with_paths(got["placements"]))
    before = dict(leaves_with_paths(want["params"]))
    mine = dict(leaves_with_paths(got["after"]))
    for path, leaf in leaves_with_paths(want["after"]):
        def cut(a, path=path):
            return f32(shard(to_torch(a), place[path], sizes, coord))
        old = cut(before[path])
        limit = EMBED_LIMIT if path == EMBED and "moe" in arch else 5e-2
        assert rel(f32(mine[path]) - old, cut(leaf) - old) < limit, path


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_tree_equals_named_sharding(runs, arch, layout):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.sharding import param_placements, shard_tree
    from repro_torch.models.layers import MeshInfo
    from repro_torch.models.registry import build_model
    from repro_torch.tree import leaves_with_paths
    ref = runs[0]["shards"][(arch, layout)]
    model = build_model(get_smoke_config(arch),
                        _layout_info(MeshInfo, layout))
    segs, _ = model.build_segments(_phase(layout), 2, 4, s_max=8)
    place = param_placements(model, segs)
    full = to_torch(ref["global"])
    paths = {p for p, _ in leaves_with_paths(full)}
    assert paths == set(ref["shards"])
    sizes = {"data": 2, "model": 2}
    for coord in ({"data": i, "model": j} for i in (0, 1) for j in (0, 1)):
        mine = dict(leaves_with_paths(shard_tree(full, place, sizes, coord)))
        key = tuple(sorted(coord.items()))
        for path, want in ref["shards"].items():
            want = to_torch(want[key])
            got = mine[path]
            assert got.shape == want.shape and got.dtype == want.dtype, path
            assert torch.equal(got, want), (path, coord)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_cut_by_layer_equals_cut_of_global_draw(arch, layout):
    """A mesh program's ``init_params`` cuts each layer to the rank's
    shard as it is drawn: at every coordinate of a data=2 x model=2 mesh
    that equals the shard of the whole global tree, FSDP layouts
    included."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.sharding import (param_placements, shard_tree,
                                             spec_to_placements)
    from repro_torch.models.layers import MeshInfo
    from repro_torch.models.registry import build_model
    from repro_torch.tree import leaves_with_paths, tree_map
    model = build_model(get_smoke_config(arch),
                        _layout_info(MeshInfo, layout))
    phase = _phase(layout)
    full = model.init_params(0, device="cpu", phase=phase,
                             shard=lambda t, ps: t)
    segs, _ = model.build_segments(phase, 2, 4, s_max=8)
    place = param_placements(model, segs)
    sizes = {"data": 2, "model": 2}
    for coord in ({"data": i, "model": j} for i in (0, 1) for j in (0, 1)):
        got = dict(leaves_with_paths(model.init_params(
            0, device="cpu", phase=phase,
            shard=lambda t, ps: shard_tree(
                t, tree_map(spec_to_placements, ps), sizes, coord))))
        want = dict(leaves_with_paths(shard_tree(full, place, sizes, coord)))
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            assert torch.equal(got[path], w), (path, coord)


def test_grok_config_is_the_references(runs):
    from repro_torch.configs import get_config, list_archs
    assert "grok-1-314b" in list_archs()
    assert dataclasses.asdict(get_config("grok-1-314b")) == \
        runs[0]["grok_config"]


GROK_PRE, GROK_DEC = (2, 16), (3, 24)


def _grok_batches(cfg):
    rng = np.random.default_rng(5)
    B, S = GROK_PRE
    pre = {"ids": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "positions": np.broadcast_to(np.arange(S, dtype=np.int32),
                                        (B, S)).copy()}
    B, s_max = GROK_DEC
    clen = np.asarray([0, 5, 23], np.int32)
    shape = (cfg.n_layers, B, s_max, cfg.n_kv, cfg.hd)
    dec = {"ids": rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32),
           "positions": clen[:, None].copy(), "cache_len": clen,
           "k_cache": (rng.standard_normal(shape) * 0.5).astype(np.float32),
           "v_cache": (rng.standard_normal(shape) * 0.5).astype(np.float32)}
    return pre, dec


def _torch_batch(batch):
    return {k: torch.from_numpy(v).to(torch.bfloat16) if k.endswith("cache")
            else torch.from_numpy(v) for k, v in batch.items()}


def _grok_steps(prog, dec_prog, params, dec_params, cfg):
    pre, dec = _grok_batches(cfg)
    got_pre = prog.prefill(*GROK_PRE)(params, _torch_batch(pre))
    B, s_max = GROK_DEC
    got_dec = dec_prog.decode_tiers(B, s_max, tiers=(B,))[B](
        dec_params, _torch_batch(dec))
    return got_pre, got_dec


def test_grok_smoke_matches_reference_one_device(monkeypatch):
    """Prefill and decode of the smoke grok against the reference's
    interpreted steps on its own params; routes as in
    ``tests/test_torch_moe.py`` (a differing route only at a near tie,
    outputs compared on the rows whose every route agrees)."""
    import jax
    import jax.numpy as jnp

    import repro.models.moe as jmoe
    import repro_torch.models.moe as tmoe
    from repro.configs import get_smoke_config as jget_smoke
    from repro.core import ScheduleContext as JCtx
    from repro.models.base import build_forward as jbuild_forward
    from repro.models.layers import MeshInfo as JMeshInfo
    from repro.models.registry import build_model as jbuild_model
    from repro_torch.api import compile
    from repro_torch.convert import params_from_numpy
    from test_torch_moe import Routes, agreeing_rows, close
    jm = jbuild_model(jget_smoke("grok-1-314b"), JMeshInfo())
    cfg = jm.cfg
    jparams = jm.init_params(jax.random.PRNGKey(0), phase="prefill")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    prog = compile("grok-1-314b", smoke=True, device="cpu",
                   policy="sequential")
    pre, dec = _grok_batches(cfg)

    def jrun(phase, B, S, batch):
        segs, _ = jm.build_segments(phase, B, 1 if phase == "decode" else S,
                                    s_max=S)
        fwd = jbuild_forward(segs, "sequential",
                             JCtx(local_batch=B, seq_len=S, phase=phase,
                                  arch=cfg.name), lowered=False)
        return fwd(jparams, {k: jnp.asarray(v).astype(jnp.bfloat16)
                             if k.endswith("cache") else jnp.asarray(v)
                             for k, v in batch.items()})
    for phase, (B, S), batch in (("prefill", GROK_PRE, pre),
                                 ("decode", GROK_DEC, dec)):
        step = (prog.prefill(B, S) if phase == "prefill"
                else prog.decode_tiers(B, S, tiers=(B,))[B])
        jr, tr = Routes(monkeypatch, jmoe), Routes(monkeypatch, tmoe)
        want = jrun(phase, B, S, batch)
        got = step(params, _torch_batch(batch))
        rows = agreeing_rows(jr, tr, cfg.moe.top_k)
        assert len(rows) > 0
        keys = (("logits", "layers.k", "layers.v") if phase == "prefill"
                else ("logits", "k_cache", "v_cache"))
        for key in keys:
            axis = 0 if key == "logits" else 1
            close(np.take(f32(got[key]), rows, axis),
                  np.take(f32(want[key]), rows, axis))
        monkeypatch.undo()


def test_grok_fsdp_modes_on_one_rank_equal_no_fsdp():
    """On a one-rank mesh the zero3 prefill and the resident and
    ff-sharded decode give the no-FSDP model's bits."""
    import torch.distributed as dist

    from repro_torch.api import compile
    from repro_torch.launch.mesh import make_mesh, unbind_mesh
    from repro_torch.launch.sharding import fsdp_gathered_tree
    from repro_torch.models.layers import MeshInfo
    plain = compile("grok-1-314b", smoke=True, device="cpu",
                    policy="sequential")
    cfg = plain.model.cfg
    params = plain.init_params(0)
    want = _grok_steps(plain, plain, params, params, cfg)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    try:
        pre_prog = compile("grok-1-314b", smoke=True, device="cpu",
                           policy="sequential", mesh=mesh,
                           mesh_info=MeshInfo(fsdp=True))
        dec_prog = compile("grok-1-314b", smoke=True, device="cpu",
                           policy="sequential", mesh=mesh,
                           mesh_info=MeshInfo(fsdp=True, fsdp_resident=True))
        layers = pre_prog.model.layer_stacks("prefill")[0][1]
        dlayers = dec_prog.model.layer_stacks("decode")[0][1]
        assert (layers.qkv.proj.mode, layers.moe.experts.mode) == \
            ("gather", "zero3")
        assert (dlayers.qkv.proj.mode, dlayers.moe.experts.mode) == \
            ("resident", "ff_sharded")
        got = _grok_steps(pre_prog, dec_prog,
                          fsdp_gathered_tree(params, pre_prog.model),
                          params, cfg)
    finally:
        unbind_mesh(mesh)
        dist.destroy_process_group()
    for a, b in zip(got, want):
        assert "logits" in a and set(a) <= set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
