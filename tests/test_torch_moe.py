"""The port's MoE (src/repro_torch/models/moe.py) against the JAX package.

Op by op: the router, the dispatch build (capacity, slots, drops), the
combine and the expert GEMM on identical inputs made with seeded numpy.
Then smoke deepseek-moe-16b (cut to three layers, so the MoE layers are
a stack of two) on the same parameters — ``params_from_numpy`` of
``repro``'s ``init_params(PRNGKey(0))`` — through prefill and decode in
both packages, the JAX one interpreted (``lowered=False``).

Tolerances: bf16 outputs within atol=rtol=3e-2 (tests/test_kernels.py),
atol scaled by the reference's largest magnitude, as in
tests/test_torch_model.py.  Routes are discrete: the two frameworks
round bf16 at different places, so the router's input, and its
probabilities, differ by that tolerance, and a token's top-k can only
differ from the reference's where the reference's k-th and (k+1)-th
probabilities lie within twice the bound, ``2 * (3e-2 + 3e-2 * p_k)``.
Wherever a route differs the test requires such a near tie, and it
compares the outputs of the batch rows whose every route agrees.  The
smoke capacity (cf=2.0) never drops a token, so a flipped route moves
only its own token's row.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
import repro_torch.models.moe as tmoe
from repro.configs import get_smoke_config as jget_smoke
from repro.configs.base import MoEConfig as JMoEConfig
from repro.core import ScheduleContext as JCtx
from repro.models.base import build_forward as jbuild_forward
from repro.models.layers import MeshInfo as JMeshInfo
from repro.models.registry import build_model as jbuild_model
from repro_torch.api import compile as tcompile
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.convert import params_from_numpy
from repro_torch.dist import collectives as col
from repro_torch.models.layers import MeshInfo as TMeshInfo

ARCH = "deepseek-moe-16b"
BF16 = dict(atol=3e-2, rtol=3e-2)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want):
    want = np32(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np32(got), want, atol=BF16["atol"] * scale,
                               rtol=BF16["rtol"])


def both(a, dtype):
    """The same values in both frameworks, rounded once to ``dtype``."""
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype)))


def moe_cfg(**kw):
    base = dict(n_experts=4, top_k=2, d_ff_expert=32, n_shared=1,
                capacity_factor=2.0, first_layer_dense=True)
    base.update(kw)
    return JMoEConfig(**base), TMoEConfig(**base)


# ---------------------------------------------------------------------------
# op-level parity
# ---------------------------------------------------------------------------


def test_router_matches_reference():
    jm, tm = moe_cfg()
    rng = np.random.default_rng(0)
    (xj, xt) = both(rng.standard_normal((2, 16, 32)), "bfloat16")
    (wj, wt) = both(rng.standard_normal((32, 4)) * 0.3, "float32")
    jw, jve = jmoe.RouterOp(32, jm, JMeshInfo()).kernel({"wr": wj}, xj)
    tw, tve = tmoe.RouterOp(32, tm, TMeshInfo()).kernel({"wr": wt}, xt)
    assert tve.dtype == torch.int32 and tw.dtype == torch.float32
    np.testing.assert_array_equal(tve.numpy(), np.asarray(jve))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)


def test_router_breaks_ties_toward_the_lower_expert():
    """Equal probabilities (identical router columns) pick the lower
    expert index first, as ``lax.top_k`` does."""
    jm, tm = moe_cfg(n_experts=6, top_k=3)
    rng = np.random.default_rng(1)
    (xj, xt) = both(rng.standard_normal((1, 8, 16)), "bfloat16")
    w = rng.standard_normal((16, 6)) * 0.3
    w[:, 4] = w[:, 1]
    w[:, 5] = w[:, 2] = w[:, 0]
    (wj, wt) = both(w, "float32")
    _, jve = jmoe.RouterOp(16, jm, JMeshInfo()).kernel({"wr": wj}, xj)
    _, tve = tmoe.RouterOp(16, tm, TMeshInfo()).kernel({"wr": wt}, xt)
    np.testing.assert_array_equal(tve.numpy(), np.asarray(jve))


@pytest.mark.parametrize("cf", [2.0, 0.5], ids=["fits", "overflows"])
def test_dispatch_build_slots_and_drops_match_reference(cf):
    """Capacity max(4, ceil(cf*n*k/E)); slots count earlier (token, k)
    positions row-major; past capacity a row is dropped (slot -1) and
    its buffer row stays zero."""
    jm, tm = moe_cfg(capacity_factor=cf)
    rng = np.random.default_rng(2)
    B, S, d, kv = 2, 16, 24, 2
    (xj, xt) = both(rng.standard_normal((B, S, d)), "bfloat16")
    # skewed routing: expert 0 is everyone's first choice
    ve = np.stack([np.zeros((B, S)), rng.integers(1, 4, (B, S))],
                  -1).astype(np.int32)
    jbuf, jslot = jmoe.DispatchBuildOp(jm, JMeshInfo()).kernel(
        {}, xj, jnp.asarray(ve))
    op = tmoe.DispatchBuildOp(tm, TMeshInfo())
    tbuf, tslot = op.kernel({}, xt, torch.from_numpy(ve))
    C = max(4, int(np.ceil(cf * B * S * kv / 4)))
    assert tuple(tbuf.shape) == (4, C, d) and tslot.dtype == torch.int32
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(np32(tbuf), np32(jbuf))
    counts = np.bincount(ve.reshape(-1), minlength=4)
    assert int((tslot < 0).sum()) == int(np.maximum(counts - C, 0).sum())
    assert (int((tslot < 0).sum()) > 0) == (cf < 1)
    assert [tuple(s.shape) for s in op.infer_out(
        [tmoe.TensorSpec((B, S, d), torch.bfloat16),
         tmoe.TensorSpec((B, S, kv), torch.int32)])] == \
        [(4, C, d), (B, S, kv)]


def test_combine_matches_reference():
    jm, tm = moe_cfg()
    rng = np.random.default_rng(3)
    B, S, d, V, C = 2, 8, 16, 4, 10
    (bj, bt) = both(rng.standard_normal((V, C, d)), "bfloat16")
    ve = rng.integers(0, V, (B, S, 2)).astype(np.int32)
    slot = rng.integers(-1, C, (B, S, 2)).astype(np.int32)
    (wj, wt) = both(rng.random((B, S, 2)), "float32")
    args_j = (bj, jnp.asarray(ve), jnp.asarray(slot), wj)
    args_t = (bt, torch.from_numpy(ve), torch.from_numpy(slot), wt)
    close(tmoe.CombineOp().kernel({}, *args_t),
          jmoe.CombineOp().kernel({}, *args_j))
    # the decode layout's partial combine is the same function at tp=1
    close(tmoe.CombinePartialOp(tm, TMeshInfo()).kernel({}, *args_t),
          jmoe.CombinePartialOp(jm, JMeshInfo()).kernel({}, *args_j))


def test_expert_gemm_matches_reference():
    """The port's op goes through the grouped-FFN kernel path; the JAX
    package's default (``impl='xla'``) rounds its intermediates to bf16,
    its ``impl='pallas'`` runs the Pallas kernel (interpret mode)."""
    jm, tm = moe_cfg()
    rng = np.random.default_rng(4)
    E, N, d, F = 4, 12, 32, 32
    (bj, bt) = both(rng.standard_normal((E, N, d)) * 0.5, "bfloat16")
    pj, pt = {}, {}
    for k, shape in (("w1", (E, d, F)), ("w3", (E, d, F)),
                     ("w2", (E, F, d))):
        pj[k], pt[k] = both(rng.standard_normal(shape) * 0.1, "bfloat16")
    got = tmoe.ExpertGEMMOp(d, tm, TMeshInfo()).kernel(pt, bt)
    for impl in ("xla", "pallas"):
        close(got, jmoe.ExpertGEMMOp(d, jm, JMeshInfo(), impl=impl)
              .kernel(pj, bj))


def test_all_to_all_and_axis_index_are_identities_at_tp1():
    x = torch.arange(48.0).reshape(4, 3, 4)     # (E, C, d) of moe_cfg()
    assert col.axis_index("model") == 0
    for split, concat in ((0, 1), (1, 0)):
        assert col.all_to_all(x, "model", split_dim=split,
                              concat_dim=concat) is x
    for direction in ("dispatch", "combine"):
        op = tmoe.MoEAllToAllOp(TMeshInfo(), direction)
        assert op.kernel({}, x) is x
        assert op.infer_out([tmoe.TensorSpec((4, 3, 4), torch.float32)]) \
            == tmoe.TensorSpec((4, 3, 4), torch.float32)
    assert tmoe.ExpertSliceOp(moe_cfg()[1], TMeshInfo()).kernel({}, x) \
        .data_ptr() == x.data_ptr()


def test_fsdp_expert_modes_are_refused():
    """No longer refused: under ``mesh.fsdp`` the experts take the
    reference's zero3 (gathered) and ff-sharded modes, with the same
    param trees; the modes across ranks are held to the reference in
    tests/test_torch_fsdp.py."""
    cfg = moe_cfg()[1]
    jcfg = moe_cfg()[0]
    for ff_shard, mode, keys in ((False, "zero3", ["g1", "g2", "g3"]),
                                 (True, "ff_sharded", ["gemm"])):
        op = tmoe.ExpertFFN(32, cfg, TMeshInfo(fsdp=True), ff_shard=ff_shard)
        ref = jmoe.ExpertFFN(32, jcfg, JMeshInfo(fsdp=True),
                             ff_shard=ff_shard)
        assert op.mode == mode
        assert sorted(op.param_pspecs()) == sorted(ref.param_pspecs()) \
            == keys
    assert tmoe.ExpertFFN(32, cfg, TMeshInfo()).mode == "resident"


# ---------------------------------------------------------------------------
# the smoke model against the reference
# ---------------------------------------------------------------------------


def smoke(pkg_get):
    return dataclasses.replace(pkg_get(ARCH), n_layers=3)


@pytest.fixture(scope="module")
def pair():
    from repro_torch.configs import get_smoke_config as tget_smoke
    jm = jbuild_model(smoke(jget_smoke), JMeshInfo())
    jparams = jm.init_params(jax.random.PRNGKey(0), phase="prefill")
    prog = tcompile(smoke(tget_smoke), policy="sequential", device="cpu")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jm, jparams, prog, tparams


class Routes:
    """Records every router call's probabilities and chosen experts (the
    router op's kernel, patched on its class).  The JAX package runs a
    layer stack under ``lax.scan``, so its values arrive through an
    ordered ``jax.debug.callback``."""

    def __init__(self, monkeypatch, module):
        self.calls = []
        orig = module.RouterOp.kernel

        def record(x, wr, ve):
            logits = np32(x).astype(np.float64) @ np32(wr)
            e = np.exp(logits - logits.max(-1, keepdims=True))
            self.calls.append((e / e.sum(-1, keepdims=True),
                               np.asarray(ve)))

        def kernel(op, p, x):
            w, ve = orig(op, p, x)
            if module is jmoe:
                jax.debug.callback(record, x, p["wr"], ve, ordered=True)
            else:
                record(x, p["wr"], ve)
            return w, ve
        monkeypatch.setattr(module.RouterOp, "kernel", kernel)


def agreeing_rows(jroutes, troutes, k):
    """Batch rows whose every route agrees; a differing route must sit
    on a near tie of the reference's probabilities."""
    assert len(jroutes.calls) == len(troutes.calls) > 0
    ok = None
    for (jp, jve), (tp, tve) in zip(jroutes.calls, troutes.calls):
        np.testing.assert_allclose(tp, jp, **BF16)
        same = (np.sort(jve, -1) == np.sort(tve, -1)).all(-1)    # (B, S)
        for b, s in zip(*np.nonzero(~same)):
            p = np.sort(jp[b, s])[::-1]
            margin = p[k - 1] - p[k]
            assert margin < 2 * (BF16["atol"] + BF16["rtol"] * p[k - 1]), \
                (b, s, margin)
        rows = same.all(-1)
        ok = rows if ok is None else ok & rows
    return np.nonzero(ok)[0]


def test_params_carry_across(pair):
    """The f32 router, the stacked (n_moe, E, D, F) expert leaves, the
    dense0 stack and the shared expert arrive as they are."""
    jm, jparams, prog, tparams = pair
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in flat_j:
        t = tparams
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).endswith(np.dtype(leaf.dtype).name)
        np.testing.assert_array_equal(np32(t), np32(leaf))
    moe = tparams["layers"]["moe"]
    assert moe["router"]["wr"].dtype == torch.float32
    assert tuple(moe["experts"]["gemm"]["w1"].shape) == (2, 4, 32, 32)
    assert "mlp" in tparams["dense0"] and "shared" in moe
    mine = prog.init_params(0)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, mine)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0,
                                                            jparams))
    assert mine["layers"]["moe"]["router"]["wr"].dtype == torch.float32


def _run_jax(jm, jparams, phase, B, S, batch, s_max):
    q = 1 if phase == "decode" else S
    segs, _ = jm.build_segments(phase, B, q, s_max=s_max)
    fwd = jbuild_forward(segs, "sequential",
                         JCtx(local_batch=B, seq_len=s_max, phase=phase,
                              arch=jm.cfg.name), lowered=False)
    return lambda: fwd(jparams, {k: jnp.asarray(v) for k, v in batch.items()})


@pytest.mark.parametrize("B,S", [(2, 16), (1, 37)])
def test_prefill_logits_and_kv_match(pair, monkeypatch, B, S):
    jm, jparams, prog, tparams = pair
    rng = np.random.default_rng(5)
    batch = {"ids": rng.integers(0, jm.cfg.vocab, (B, S)).astype(np.int32),
             "positions": np.broadcast_to(np.arange(S, dtype=np.int32),
                                          (B, S)).copy()}
    jrun = _run_jax(jm, jparams, "prefill", B, S, batch, S)
    step = prog.prefill(B, S)
    jr = Routes(monkeypatch, jmoe)
    tr = Routes(monkeypatch, tmoe)
    want = jrun()
    got = step(tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got["logits"].shape == (B, 1, jm.cfg.vocab)
    rows = agreeing_rows(jr, tr, jm.cfg.moe.top_k)
    assert len(jr.calls) == 2                 # the two MoE layers
    for key in ("dense0.k", "dense0.v"):      # before any router
        close(got[key], want[key])
    for key in ("logits", "layers.k", "layers.v"):
        axis = 1 if key.startswith("layers") else 0
        close(np.take(np32(got[key]), rows, axis),
              np.take(np32(want[key]), rows, axis))


def test_decode_logits_and_caches_match(pair, monkeypatch):
    jm, jparams, prog, tparams = pair
    cfg = jm.cfg
    B, s_max = 3, 24
    rng = np.random.default_rng(6)
    clen = np.asarray([0, 5, 23], np.int32)
    shape = (B, s_max, cfg.n_kv, cfg.hd)
    caches = {"dense0_k_cache": shape, "dense0_v_cache": shape,
              "k_cache": (2,) + shape, "v_cache": (2,) + shape}
    cvals = {k: (rng.standard_normal(s) * 0.5).astype(np.float32)
             for k, s in caches.items()}
    batch = {"ids": rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32),
             "positions": clen[:, None].copy(), "cache_len": clen}
    jb = dict(batch, **{k: jnp.asarray(v).astype(jnp.bfloat16)
                        for k, v in cvals.items()})
    jrun = _run_jax(jm, jparams, "decode", B, s_max, jb, s_max)
    step = prog.decode_tiers(B, s_max, tiers=(B,))[B]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tc = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in cvals.items()}
    jr = Routes(monkeypatch, jmoe)
    tr = Routes(monkeypatch, tmoe)
    want = jrun()
    got = step(tparams, dict(tb, **tc))
    rows = agreeing_rows(jr, tr, cfg.moe.top_k)
    for key in ("dense0_k_cache", "dense0_v_cache"):
        close(got[key], want[key])
    close(np.take(np32(got["logits"]), rows, 0),
          np.take(np32(want["logits"]), rows, 0))
    for key in ("k_cache", "v_cache"):
        close(np.take(np32(got[key]), rows, 1),
              np.take(np32(want[key]), rows, 1))
        # the decode step wrote the new KV into the caches it was given
        assert got[key].data_ptr() == tc[key].data_ptr()


@pytest.mark.parametrize("policy", ["dbo", "comet", "dynamic"])
def test_split_and_fused_plans_equal_sequential(pair, policy):
    """DBO splits the MoE section into micro-batches of their own
    capacity; Comet runs the expert FFN over chunks of the dispatch
    buffer; ``dynamic`` resolves to DBO at 2048 tokens."""
    jm, jparams, prog, tparams = pair
    B, S = 2, 1024
    rng = np.random.default_rng(7)
    batch = {"ids": torch.from_numpy(
                 rng.integers(0, jm.cfg.vocab, (B, S)).astype(np.int32)),
             "positions": torch.arange(S, dtype=torch.int32).expand(B, S)
             .contiguous()}
    want = prog.prefill(B, S)(tparams, batch)
    other = tcompile(prog.model.cfg, policy=policy, device="cpu") \
        .prefill(B, S)
    got = other(tparams, batch)
    layers = other.fn.realizers["layers"].plan
    if policy in ("dbo", "dynamic"):
        assert other.strategies["layers"] == "dbo"
        assert layers.split_sizes == (1, 1)
    else:
        assert [s.replace_name for s in layers.steps
                if s.kind == "fused"] == ["comet"]
    for key in ("logits", "layers.k", "layers.v"):
        a, b = got[key].float(), want[key].float()
        assert float((a - b).norm() / b.norm()) < 1e-2, key
