"""The port's Mamba2 and hybrid families (src/repro_torch/models/mamba2.py,
hybrid.py) and its SSD scan (src/repro_torch/kernels/ssd_scan.py) against
the JAX package.

The scan's plain version (the CPU path of the whole model) is held
against ``repro.kernels.ref.ssd_scan`` (the sequential recurrence), the
Pallas kernel in interpret mode and the model's ``SSDScanOp._ref``.  Each
Mamba2 op is held against its JAX counterpart on the same parameters.
Then smoke mamba2-2.7b and zamba2-1.2b on ``params_from_numpy`` of
``repro``'s ``init_params(PRNGKey(0))``: prefill logits under
``sequential`` and ``dynamic``, a decode step from non-zero caches, and
the serve engine against ``repro.serve.ServeEngine(lowered=False)``.

Tolerances.  f32: the SSD tolerance of tests/test_kernels.py (atol=2e-3,
rtol=1e-2), as the chunked and the sequential forms sum in different
orders.  bf16: atol=rtol=3e-2 (tests/test_kernels.py), atol scaled by the
reference's largest magnitude, as in tests/test_torch_model.py: the two
frameworks round bf16 at different places.  Greedy tokens must be equal
wherever the reference's top-1/top-2 margin is above twice that bound
(tests/test_torch_serve.py).

Neither package hands the recurrent state from prefill to decode: the
prefill stacks collect nothing, so decode starts from whatever the cache
row holds (zeros in a fresh engine).  The port mirrors that; the tests
below pin it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.mamba2 as jm2
import repro_torch.models.mamba2 as tm2
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.core import ScheduleContext as JCtx
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.base import build_forward as jbuild_forward
from repro.models.layers import MeshInfo as JMeshInfo
from repro.models.registry import build_model as jbuild_model
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.api import compile as tcompile
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_smoke_config as tget_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.core.module import TensorSpec
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models.layers import MeshInfo as TMeshInfo
from repro_torch.serve import Request, ServeConfig
from repro_torch.serve.kv_cache import KVCacheManager

ARCHS = ["mamba2-2.7b", "zamba2-1.2b"]
SSD_F32 = dict(atol=2e-3, rtol=1e-2)
BF16 = dict(atol=3e-2, rtol=3e-2)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want):
    """bf16 tolerance, atol scaled by the reference's largest magnitude."""
    want = np32(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np32(got), want, atol=BF16["atol"] * scale,
                               rtol=BF16["rtol"])


def both(a, dtype):
    """The same values in both frameworks, rounded once to ``dtype``."""
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype)))


def ssd_inputs(seed, b, L, H, P, G, N, dtype="float32"):
    """x, dt (softplus of a normal), A = -exp(normal), B, C, D = 1."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, L, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((b, L, H))))
    A = -np.exp(rng.standard_normal((H,)))
    B = rng.standard_normal((b, L, G, N)) * 0.5
    C = rng.standard_normal((b, L, G, N)) * 0.5
    D = np.ones((H,))
    return (both(x, dtype), both(dt, "float32"), both(A, "float32"),
            both(B, dtype), both(C, dtype), both(D, "float32"))


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L,chunk,Q", [(2048, 128, 128), (32, 128, 32),
                                       (48, 16, 16), (37, 128, 37),
                                       (40, 16, 8), (6, 4, 2)])
def test_chunk_len_follows_the_pallas_rule(L, chunk, Q):
    assert tssd.chunk_len(L, chunk) == Q


@pytest.mark.parametrize("L,chunk", [(32, 8), (64, 16), (64, 64), (48, 16)])
def test_ssd_scan_plain_matches_reference_and_pallas(L, chunk):
    """The sweep of tests/test_kernels.py:test_ssd_scan_sweep."""
    pairs = ssd_inputs(0, 2, L, 4, 8, 1, 16)
    j = [p[0] for p in pairs]
    got = tssd.ssd_scan_plain(*[p[1] for p in pairs], chunk=chunk)
    np.testing.assert_allclose(np32(got), np32(jref.ssd_scan(*j)), **SSD_F32)
    np.testing.assert_allclose(np32(got), np32(jops.ssd_scan(*j, chunk=chunk)),
                               **SSD_F32)


def test_ssd_scan_plain_multi_group():
    """G = 2: heads 0-1 read group 0, heads 2-3 group 1; D = 0."""
    pairs = ssd_inputs(1, 1, 32, 4, 8, 2, 8)
    pairs = pairs[:5] + (both(np.zeros(4), "float32"),)
    j = [p[0] for p in pairs]
    got = tssd.ssd_scan_plain(*[p[1] for p in pairs], chunk=8)
    np.testing.assert_allclose(np32(got), np32(jref.ssd_scan(*j)), **SSD_F32)
    np.testing.assert_allclose(np32(got), np32(jops.ssd_scan(*j, chunk=8)),
                               **SSD_F32)


def test_ssd_scan_plain_bf16_and_through_the_dispatch():
    """bf16 x/B/C as the model gives them; ``ops.ssd_scan`` takes the
    plain version on a CPU tensor and counts no launch."""
    pairs = ssd_inputs(2, 2, 64, 4, 16, 1, 16, dtype="bfloat16")
    before = LAUNCHES["ssd_scan"]
    got = tops.ssd_scan(*[p[1] for p in pairs], chunk=16)
    assert LAUNCHES["ssd_scan"] == before
    assert got.dtype == torch.bfloat16 and got.shape == (2, 64, 4, 16)
    close(got, jref.ssd_scan(*[p[0] for p in pairs]))


def test_ssd_scan_takes_the_plain_path_on_meta_tensors():
    pairs = ssd_inputs(3, 2, 16, 4, 8, 1, 16, dtype="bfloat16")
    meta = [p[1].to("meta") for p in pairs]
    out = tops.ssd_scan(*meta, chunk=8)
    assert out.device.type == "meta" and out.shape == (2, 16, 4, 8)


def _op_params(jop, seed):
    """Random values for every param of a JAX op, in both frameworks."""
    rng = np.random.default_rng(seed)
    pj, pt = {}, {}
    for name, pp in jop._params.items():
        a = rng.standard_normal(pp.shape) * 0.5
        if name == "A_log":
            a = np.log(rng.uniform(1.0, 16.0, pp.shape))
        dt = np.dtype(pp.dtype).name
        pj[name], pt[name] = both(a, dt)
    return pj, pt


def _smoke_ops(arch="mamba2-2.7b"):
    return jget_smoke(arch), tget_smoke(arch), JMeshInfo(), TMeshInfo()


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_ssd_scan_op_matches_the_model_reference(impl):
    """The port's ``SSDScanOp`` (views of x/B/C into the post-conv
    activations, through ``kops.ssd_scan``) against the JAX package's
    op: ``impl='xla'`` is its model path (``_ref``), ``impl='pallas'``
    its kernel in interpret mode."""
    jc, tc, jmesh, tmesh = _smoke_ops()
    jop = jm2.SSDScanOp(jc, jmesh, impl=impl)
    top = tm2.SSDScanOp(tc, tmesh)
    pj, pt = _op_params(jop, 4)
    _, _, _, H, ch = tm2.ssm_dims(tc, 1)
    rng = np.random.default_rng(5)
    xj, xt = both(rng.standard_normal((2, 32, ch)), "bfloat16")
    dj, dtt = both(rng.standard_normal((2, 32, H)), "bfloat16")
    got = top.kernel(pt, xt, dtt)
    assert got.shape == (2, 32, tm2.ssm_dims(tc, 1)[1])
    close(got, jop.kernel(pj, xj, dj))
    assert top.infer_out([TensorSpec((2, 32, ch), torch.bfloat16),
                          TensorSpec((2, 32, H), torch.bfloat16)]) == \
        TensorSpec(tuple(got.shape), torch.bfloat16)


def test_conv1d_matches_reference():
    jc, tc, jmesh, tmesh = _smoke_ops()
    jop, top = jm2.Conv1dOp(jc, jmesh), tm2.Conv1dOp(tc, tmesh)
    pj, pt = _op_params(jop, 6)
    width = jop.d_in_loc + jop.ch_loc + jop.H_loc
    xj, xt = both(np.random.default_rng(7).standard_normal((2, 24, width)),
                  "bfloat16")
    for g, w in zip(top.kernel(pt, xt), jop.kernel(pj, xj)):
        assert tuple(g.shape) == w.shape
        close(g, w)


def test_conv_decode_matches_reference():
    jc, tc, jmesh, tmesh = _smoke_ops()
    jop, top = jm2.ConvDecodeOp(jc, jmesh), tm2.ConvDecodeOp(tc, tmesh)
    pj, pt = _op_params(jop, 8)
    width = jop.d_in_loc + jop.ch_loc + jop.H_loc
    rng = np.random.default_rng(9)
    xj, xt = both(rng.standard_normal((3, 1, width)), "bfloat16")
    sj, st = both(rng.standard_normal((3, jc.ssm.conv_width - 1, jop.ch_loc)),
                  "bfloat16")
    got, want = top.kernel(pt, xt, st), jop.kernel(pj, xj, sj)
    assert len(got) == len(want) == 4          # z, xbc, dt, new conv_state
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16
        close(g, w)
    # the new state is the window shifted by one: the old rows 1.. and x
    np.testing.assert_array_equal(np32(got[3][:, :-1]), np32(st[:, 1:]))
    assert [tuple(s.shape) for s in top.infer_out(
        [TensorSpec(tuple(xt.shape), torch.bfloat16),
         TensorSpec(tuple(st.shape), torch.bfloat16)])] == \
        [tuple(g.shape) for g in got]


def test_ssd_decode_matches_reference():
    jc, tc, jmesh, tmesh = _smoke_ops()
    jop, top = jm2.SSDDecodeOp(jc, jmesh), tm2.SSDDecodeOp(tc, tmesh)
    pj, pt = _op_params(jop, 10)
    s = jc.ssm
    rng = np.random.default_rng(11)
    xj, xt = both(rng.standard_normal((3, 1, jop.ch_loc)), "bfloat16")
    dj, dtt = both(rng.standard_normal((3, 1, jop.H_loc)), "bfloat16")
    sj, st = both(rng.standard_normal((3, jop.H_loc, s.state, s.head_dim))
                  * 0.5, "bfloat16")
    (gy, gs), (wy, ws) = top.kernel(pt, xt, dtt, st), jop.kernel(pj, xj, dj,
                                                                 sj)
    assert gs.dtype == torch.bfloat16 and tuple(gs.shape) == ws.shape
    close(gy, wy)
    close(gs, ws)


def test_gated_norm_matches_reference():
    jc, tc, jmesh, tmesh = _smoke_ops()
    d = tm2.ssm_dims(tc, 1)[1]
    jop, top = jm2.GatedNormOp(d, jmesh), tm2.GatedNormOp(d, tmesh)
    pj, pt = _op_params(jop, 12)
    rng = np.random.default_rng(13)
    yj, yt = both(rng.standard_normal((2, 8, d)), "bfloat16")
    zj, zt = both(rng.standard_normal((2, 8, d)), "bfloat16")
    close(top.kernel(pt, yt, zt), jop.kernel(pj, yj, zj))


@pytest.mark.parametrize("arch,count", [("mamba2-2.7b", 2_701_899_776),
                                        ("zamba2-1.2b", 1_171_726_080)])
def test_published_ssm_config_counts(arch, count):
    cfg = tget_config(arch)
    assert cfg.param_count()[0] == count
    assert cfg.param_count() == jget_config(arch).param_count()
    assert dataclasses.asdict(cfg.smoke()) == \
        dataclasses.asdict(jget_smoke(arch))


def test_published_zamba2_shares_one_attention_block():
    """zamba2-1.2b as published: 6 groups of 6 Mamba2 layers, each
    followed by the shared block (one param subtree, six segment uids),
    then 2 trailing layers; each invocation keeps its own KV cache."""
    model = tcompile("zamba2-1.2b", device="cpu").model
    for phase in ("prefill", "decode"):
        segs, _ = model.build_segments(phase, 1, 1 if phase == "decode"
                                       else 8, s_max=8)
        shared = [s for s in segs if s.name == "shared_attn"]
        assert [s.key for s in shared] == [f"shared_attn@{i}"
                                           for i in range(6)]
        assert [(s.name, s.count) for s in segs if s.name.startswith(
            "mamba")] == [(f"mamba_g{i}", 6) for i in range(6)] + \
            [("mamba_tail", 2)]
    env = model.decode_cache_env(4, 64)
    assert sorted(k for k in env if k.endswith("k_cache")) == \
        sorted(f"attn{i}_k_cache" for i in range(6))
    assert env["mamba_tail.ssm_state"].shape == (2, 4, 64, 64, 64)
    assert model.decode_cache_layout()["mamba_g0.ssm_state"] == (1, -3)


# ---------------------------------------------------------------------------
# the smoke models against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jm = jbuild_model(jget_smoke(arch), JMeshInfo())
    jparams = jm.init_params(jax.random.PRNGKey(0), phase="prefill")
    prog = tcompile(arch, policy="sequential", smoke=True, device="cpu")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jm, jparams, prog, tparams


def prefill_inputs(B, S, vocab, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return {"ids": ids, "positions": pos}


def run_jax(jm, jparams, phase, B, S, batch, s_max=None):
    q = 1 if phase == "decode" else S
    segs, _ = jm.build_segments(phase, B, q, s_max=s_max or S)
    info = JCtx(local_batch=B, seq_len=s_max or S, phase=phase,
                arch=jm.cfg.name)
    fwd = jbuild_forward(segs, "sequential", info, lowered=False)
    return fwd(jparams, {k: jnp.asarray(v) for k, v in batch.items()})


def test_params_carry_across(pair):
    """Every leaf arrives as it is (f32 conv weights and SSM scalars,
    bf16 projections); the port draws the same tree from its generator,
    with the hybrid's shared block drawn once."""
    jm, jparams, prog, tparams = pair
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in flat_j:
        t = tparams
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).endswith(np.dtype(leaf.dtype).name)
        np.testing.assert_array_equal(np32(t), np32(leaf))
    mine = prog.init_params(0)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, mine)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0,
                                                            jparams))
    stack = "layers" if jm.cfg.family == "ssm" else "mamba_g0"
    assert mine[stack]["conv"]["cw"].dtype == torch.float32
    assert mine[stack]["ssd"]["A_log"].dtype == torch.float32
    assert bool((mine[stack]["ssd"]["A_log"] >= 0).all())      # log U(1,16)
    if jm.cfg.family == "hybrid":
        assert "shared_attn" in mine and "shared_attn@0" not in mine


def test_shared_block_params_are_reused_by_every_invocation():
    """Every invocation of zamba2's shared block reads the one subtree."""
    prog = tcompile("zamba2-1.2b", policy="sequential", smoke=True,
                    device="cpu")
    tparams = prog.init_params(0)
    step = prog.prefill(1, 8)
    seen = {}
    for key, rz in list(step.fn.realizers.items()):
        if not key.startswith("shared_attn@"):
            continue

        def spy(params, inputs, rz=rz, key=key):
            seen[key] = params["down"]["lin"]["w"].data_ptr()
            return rz(params, inputs)
        step.fn.realizers[key] = spy
    step(tparams, {k: torch.from_numpy(v) for k, v in
                   prefill_inputs(1, 8, prog.model.cfg.vocab).items()})
    want = tparams["shared_attn"]["down"]["lin"]["w"].data_ptr()
    assert sorted(seen) == ["shared_attn@0", "shared_attn@1"]
    assert set(seen.values()) == {want}


@pytest.mark.parametrize("B,S", [(2, 16), (1, 32), (2, 40)])
def test_prefill_logits_match(pair, B, S):
    jm, jparams, prog, tparams = pair
    batch = prefill_inputs(B, S, jm.cfg.vocab)
    want = run_jax(jm, jparams, "prefill", B, S, batch)
    got = prog.prefill(B, S)(tparams, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    assert got["logits"].shape == (B, 1, jm.cfg.vocab)
    close(got["logits"], want["logits"])
    # the prefill collects no state (no prefill -> decode handoff)
    assert not [k for k in got if k.endswith((".k", ".v", "_state"))]


def test_dynamic_prefill_matches_reference(pair, monkeypatch):
    """At 2048 tokens ``dynamic`` splits the Mamba2 stacks under NanoFlow
    and fuses zamba2's shared block under TokenWeave (its [all-reduce ->
    add -> RMSNorm] chain through the fused add+RMSNorm path); the logits
    agree with the JAX package's sequential prefill."""
    jm, jparams, prog, tparams = pair
    B, S = 2, 1024
    batch = prefill_inputs(B, S, jm.cfg.vocab, 1)
    want = run_jax(jm, jparams, "prefill", B, S, batch)
    fused_calls = []
    orig = tops.fused_add_rmsnorm

    def counting(*a, **k):
        fused_calls.append(a[0].shape)
        return orig(*a, **k)
    monkeypatch.setattr(tops, "fused_add_rmsnorm", counting)
    step = tcompile(jm.cfg, policy="dynamic", device="cpu").prefill(B, S)
    got = step(tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    close(got["logits"], want["logits"])
    seq = prog.prefill(B, S)(tparams, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    a, b = got["logits"].float(), seq["logits"].float()
    assert float((a - b).norm() / b.norm()) < 1e-2
    strat = step.strategies
    mamba = [k for k in strat if k == "layers" or k.startswith("mamba")]
    assert mamba and all(strat[k] == "nanoflow" for k in mamba)
    for k in mamba:
        assert step.fn.realizers[k].plan.split_sizes == (1, 1)
    shared = [k for k in strat if k.startswith("shared_attn@")]
    assert all(strat[k] == "tokenweave" for k in shared)
    for k in shared:
        plan = step.fn.realizers[k].plan
        assert [[h.name.split("/")[-1] for h in s.handles]
                for s in plan.steps if s.kind == "fused"] == \
            [["ar_attn", "add_attn", "ln_mlp"]]
    assert len(fused_calls) == len(shared)


def _random_caches(env, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(tuple(s.shape)) * 0.5).astype(np.float32)
            for k, s in env.items()}


def test_decode_logits_and_caches_match(pair):
    """One decode step from non-zero caches (conv/ssm states and, for the
    hybrid, each invocation's KV cache) at ragged lengths."""
    jm, jparams, prog, tparams = pair
    B, s_max = 3, 24
    clen = np.asarray([0, 5, 23], np.int32)
    rng = np.random.default_rng(14)
    batch = {"ids": rng.integers(0, jm.cfg.vocab, (B, 1)).astype(np.int32),
             "positions": clen[:, None].copy(), "cache_len": clen}
    cvals = _random_caches(prog.model.decode_cache_env(B, s_max), 15)
    assert sorted(cvals) == sorted(jm.decode_cache_env(B, s_max))
    jb = dict(batch, **{k: jnp.asarray(v).astype(jnp.bfloat16)
                        for k, v in cvals.items()})
    want = run_jax(jm, jparams, "decode", B, s_max, jb, s_max=s_max)
    step = prog.decode_tiers(B, s_max, tiers=(B,))[B]
    tc = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in cvals.items()}
    got = step(tparams, dict({k: torch.from_numpy(v)
                              for k, v in batch.items()}, **tc))
    close(got["logits"], want["logits"])
    for key in cvals:
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        close(got[key], want[key])
        if key.endswith("_cache"):
            # decode attention wrote the new KV into the cache it was given
            assert got[key].data_ptr() == tc[key].data_ptr()


# ---------------------------------------------------------------------------
# the serve engine against the reference
# ---------------------------------------------------------------------------

PROMPT_LENS = (3, 8, 13, 16)      # buckets 8 and 16: padded and full rows
NEW_TOKENS = (6, 3, 6, 4)         # tiers shrink 4 -> 2, rows compact
CFG = dict(max_batch=4, s_max=64, prefill_buckets=(8, 16, 32),
           prefill_batch=2)


def _bucket(n):
    return next(b for b in CFG["prefill_buckets"] if n <= b)


def _serve_both(arch, seed_caches=None):
    """Both engines on the same prompts; ``seed_caches`` (numpy, keyed like
    the decode caches) is written into both engines' caches first."""
    jm = jbuild_model(jget_smoke(arch), JMeshInfo())
    jparams = jm.init_params(jax.random.PRNGKey(0), phase="prefill")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jm.cfg.vocab, n).astype(np.int32)
               for n in PROMPT_LENS]
    ref = JServeEngine(jm, jparams, "dynamic",
                       JServeConfig(lowered=False, **CFG))
    prog = tcompile(arch, smoke=True, device="cpu")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    eng = prog.serve(tparams, ServeConfig(**CFG))
    for k, v in (seed_caches or {}).items():
        ref.cache.caches[k] = jnp.asarray(v).astype(ref.cache.caches[k].dtype)
        eng.cache.caches[k].copy_(torch.from_numpy(v))
    for i, p in enumerate(prompts):
        ref.submit(JRequest(i, p, max_new_tokens=NEW_TOKENS[i]))
        eng.submit(Request(i, p, max_new_tokens=NEW_TOKENS[i]))
    want = {r.rid: list(r.output) for r in ref.run()}
    held = None
    if seed_caches:
        eng._admit()                # prefill only: it must hand no state over
        held = {k: np32(c) for k, c in eng.cache.caches.items()}
    done = eng.run()
    got = {r.rid: list(r.output) for r in done}
    return jm, jparams, prompts, want, got, eng, ref, held


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    return _serve_both(request.param)


def reference_logits(jm, jparams, prompt, toks, i, init=None):
    """The JAX package's logits for token ``i`` of a served request whose
    earlier tokens were ``toks[:i]``.  Token 0 of a full-bucket prompt
    comes from the prefill; every later token, and token 0 of a padded
    prompt (which re-runs the prompt's last token), from decode steps of
    batch 1 that start from the request's cache row as it was before the
    request (``init``, zeros by default): the prefill hands no state
    over, and the request owns its row until it ends."""
    n = len(prompt)
    full = n == _bucket(n)
    if full and i == 0:
        out = run_jax(jm, jparams, "prefill", 1, n,
                      {"ids": prompt[None], "positions": np.arange(
                          n, dtype=np.int32)[None]})
        return np32(out["logits"][0, -1])
    s_max = CFG["s_max"]
    segs, _ = jm.build_segments("decode", 1, 1, s_max=s_max)
    fwd = jbuild_forward(segs, "sequential",
                         JCtx(local_batch=1, seq_len=s_max, phase="decode",
                              arch=jm.cfg.name), lowered=False)
    caches = {k: jnp.zeros(s.shape, s.dtype)
              for k, s in jm.decode_cache_env(1, s_max).items()}
    if init is not None:
        caches = {k: jnp.asarray(v).astype(caches[k].dtype)
                  for k, v in init.items()}
    inputs = ([] if full else [int(prompt[-1])]) + [int(t) for t in toks[:i]]
    pos0 = n if full else n - 1
    for k, tok in enumerate(inputs):
        c = np.asarray([pos0 + k], np.int32)
        out = fwd(jparams, {"ids": jnp.asarray([[tok]], jnp.int32),
                            "positions": jnp.asarray(c[:, None]),
                            "cache_len": jnp.asarray(c), **caches})
        caches = {key: out[key] for key in caches}
    return np32(out["logits"][0, -1])


def assert_tokens_match(jm, jparams, prompt, got, want, init=None):
    """Equal greedy tokens, or, at the first differing one, a near tie of
    the reference's top-1/top-2 logits (after it the continuations
    legitimately diverge)."""
    assert len(got) == len(want)
    first = next((i for i in range(len(got)) if got[i] != want[i]), None)
    if first is None:
        return
    logits = reference_logits(jm, jparams, prompt, want, first, init)
    top2 = np.sort(logits)[-2:]
    scale = max(1.0, float(np.abs(logits).max()))
    bound = 2 * (BF16["atol"] * scale + BF16["rtol"] * abs(float(top2[1])))
    margin = float(top2[1] - top2[0])
    assert margin < bound, (
        f"token {first} differs ({got[first]} vs {want[first]}) where the "
        f"reference's top-1/top-2 margin {margin:.4f} exceeds the flip "
        f"bound {bound:.4f}")


def test_every_request_finishes_in_vocab(served):
    jm, _, prompts, want, got, eng, ref, _ = served
    assert sorted(got) == sorted(want) == list(range(len(PROMPT_LENS)))
    for r in eng.finished:
        assert r.ok and len(r.output) == NEW_TOKENS[r.rid]
        assert all(0 <= t < jm.cfg.vocab for t in r.output)
    st = eng.stats
    assert st["prefill_steps"] == 2 and st["row_moves"] >= 1
    assert sum(1 for n in st["tier_steps"].values() if n) >= 2


@pytest.mark.parametrize("rid", range(len(PROMPT_LENS)))
def test_greedy_tokens_match_reference(served, rid):
    jm, jparams, prompts, want, got, _, _, _ = served
    assert_tokens_match(jm, jparams, prompts[rid], got[rid], want[rid])


def test_cache_keys_skip_the_recurrent_stacks(served):
    """Neither engine copies anything from the prefill into the decode
    caches of these families: no stack collects ``k``/``v`` or a state."""
    jm, _, _, _, _, eng, ref, _ = served
    assert eng._ck == ref._ck == []
    assert sorted(eng.cache.caches) == sorted(ref.cache.caches)
    for k, c in eng.cache.caches.items():
        assert tuple(c.shape) == ref.cache.caches[k].shape
        assert eng.cache.batch_dims[k] == ref.cache.batch_dims[k]


def test_move_row_carries_the_recurrent_states(served):
    """Tier compaction moves a request's conv/ssm states (and KV) with it."""
    eng = served[5]
    mgr = KVCacheManager(eng.model, 4, 32, device="cpu")
    for k, c in mgr.caches.items():
        c.copy_(torch.randn(c.shape))
    before = {k: c.clone() for k, c in mgr.caches.items()}
    mgr.allocate(7)
    mgr.allocate(8)
    mgr.release(0)
    mgr.move_row(1, 0)
    for k, c in mgr.caches.items():
        bd = mgr.batch_dims[k]
        assert torch.equal(c.select(bd, 0), before[k].select(bd, 1)), k
    assert any(k.endswith("ssm_state") for k in mgr.caches)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_starts_from_the_states_the_cache_held(arch):
    """With non-zero caches written into both engines before any request
    (as a reused row holds its last request's states), the prefill leaves
    them as they are and decode continues from them: both engines give
    the same tokens, and the reference recomputed from those row states
    explains any difference."""
    env = tcompile(arch, smoke=True, device="cpu").model.decode_cache_env(
        CFG["max_batch"], CFG["s_max"])
    seed = _random_caches(env, 16)
    jm, jparams, prompts, want, got, eng, ref, held = _serve_both(arch, seed)
    for k, v in seed.items():
        np.testing.assert_array_equal(
            held[k], np32(torch.from_numpy(v).to(torch.bfloat16)))
    layout = jm.decode_cache_layout()
    for rid, prompt in enumerate(prompts):
        row = {k: np.take(v, [rid], axis=layout[k][0])
               for k, v in seed.items()}     # request rid was given row rid
        assert_tokens_match(jm, jparams, prompt, got[rid], want[rid], row)
