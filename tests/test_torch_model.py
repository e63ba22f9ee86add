"""The port's dense LM (src/repro_torch/models) against the JAX package,
on the same parameters.

``repro``'s ``init_params(PRNGKey(0))`` is carried across with
``repro_torch.convert.params_from_numpy``.  Prefill and decode run through
``build_forward`` under the sequential plan in both packages (the JAX one
interpreted, ``lowered=False``) on the same seeded inputs; logits and KV
must agree within the bf16 tolerance of tests/test_kernels.py
(atol=rtol=3e-2), with atol scaled by the tensor's largest magnitude: the
two frameworks round bf16 at different places, and the port's CPU
attention is the flash kernels' plain versions (f32 softmax weights)
where the JAX package's default is ``_sdpa`` (bf16 weights), so a value
that cancels to near zero carries the round-off of the larger terms it
was summed from.  Then, within the port: split and fused plans equal the
sequential plan, and micro-batch reads are views.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.core import ScheduleContext as JCtx
from repro.models.base import build_forward as jbuild_forward
from repro.models.layers import MeshInfo as JMeshInfo
from repro.models.registry import build_model as jbuild_model
from repro_torch.api import compile as tcompile
from repro_torch.convert import params_from_numpy
from repro_torch.core import FULL, ScheduleContext, Realizer
from repro_torch.models.base import build_forward as tbuild_forward

ARCHS = ["smollm-135m", "chatglm3-6b", "minitron-8b", "deepseek-coder-33b"]
BF16 = dict(atol=3e-2, rtol=3e-2)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jm = jbuild_model(jget_smoke(arch), JMeshInfo())
    jparams = jm.init_params(jax.random.PRNGKey(0), phase="prefill")
    prog = tcompile(arch, policy="sequential", smoke=True, device="cpu")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jm, jparams, prog, tparams


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
    jm, jparams, prog, tparams = pair
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert flat_j
    for path, leaf in flat_j:
        t = tparams
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).endswith(np.dtype(leaf.dtype).name)
        np.testing.assert_array_equal(np32(t), np32(leaf))
    # the port draws the same tree structure from its own generator
    mine = prog.init_params(0)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, mine)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0,
                                                            jparams))


@pytest.mark.parametrize("B,S", [(2, 16), (1, 37)])
def test_prefill_logits_and_kv_match(pair, B, S):
    jm, jparams, prog, tparams = pair
    batch = prefill_inputs(B, S, jm.cfg.vocab)
    want = run_jax(jm, jparams, "prefill", B, S, batch)
    got = prog.prefill(B, S)(tparams, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    assert got["logits"].shape == (B, 1, jm.cfg.vocab)
    for key in ("logits", "layers.k", "layers.v"):
        close(got[key], want[key])
    assert (np32(got["logits"]).argmax(-1)
            == np32(want["logits"]).argmax(-1)).mean() >= 0.5


def test_decode_logits_and_caches_match(pair):
    jm, jparams, prog, tparams = pair
    B, s_max = 3, 24
    cfg = jm.cfg
    rng = np.random.default_rng(1)
    clen = np.asarray([0, 5, 23], np.int32)
    cache_shape = (cfg.n_layers, B, s_max, cfg.n_kv, cfg.hd)
    kc = (rng.standard_normal(cache_shape) * 0.5).astype(np.float32)
    vc = (rng.standard_normal(cache_shape) * 0.5).astype(np.float32)
    batch = {"ids": rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32),
             "positions": clen[:, None].copy(), "cache_len": clen}
    jb = dict(batch, k_cache=jnp.asarray(kc).astype(jnp.bfloat16),
              v_cache=jnp.asarray(vc).astype(jnp.bfloat16))
    want = run_jax(jm, jparams, "decode", B, s_max, jb, s_max=s_max)
    steps = prog.decode_tiers(B, s_max, tiers=(B,))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    k_t = torch.from_numpy(kc).to(torch.bfloat16)
    v_t = torch.from_numpy(vc).to(torch.bfloat16)
    got = steps[B](tparams, dict(tb, k_cache=k_t, v_cache=v_t))
    close(got["logits"], want["logits"])
    for key in ("k_cache", "v_cache"):
        close(got[key], want[key])
    # the decode step wrote the new KV into the cache it was given
    assert got["k_cache"].data_ptr() == k_t.data_ptr()


@pytest.mark.parametrize("policy", ["nanoflow", "tokenweave", "dynamic"])
def test_split_and_fused_plans_equal_sequential(pair, policy):
    jm, jparams, prog, tparams = pair
    B, S = 4, 1024             # 4096 tokens: nanoflow splits, dynamic fuses
    batch = {k: torch.from_numpy(v)
             for k, v in prefill_inputs(B, S, jm.cfg.vocab, 2).items()}
    want = prog.prefill(B, S)(tparams, batch)
    other = tcompile(jm.cfg.name.replace("-smoke", ""), policy=policy,
                     smoke=True, device="cpu").prefill(B, S)
    got = other(tparams, batch)
    if policy == "nanoflow":
        assert other.fn.realizers["layers"].plan.split_sizes == (2, 2)
    # TokenWeave normalizes the unrounded f32 sum where the sequential
    # plan normalizes its bf16 rounding, so values differ by bf16
    # round-off that grows through the layers: relative L2 error 1e-2
    close(got["logits"], want["logits"])
    for key in ("logits", "layers.k", "layers.v"):
        a, b = got[key].float(), want[key].float()
        assert float((a - b).norm() / b.norm()) < 1e-2, key


def test_tokenweave_plan_fuses_through_the_norm_kernel_path(pair):
    """TokenWeave fuses [all-reduce -> add -> RMSNorm] chains, as the JAX
    package does: a sequence-parallel config (chatglm3-6b as published)
    has none, and the same model with ``seq_parallel=False`` has one per
    layer, whose fused step equals the sequential plan."""
    import dataclasses
    jm, jparams, prog, tparams = pair
    for sp in (True, False):
        cfg = dataclasses.replace(prog.model.cfg, seq_parallel=sp)
        step = tcompile(cfg, policy="tokenweave", device="cpu").prefill(2, 16)
        plan = step.fn.realizers["layers"].plan
        fused = [s for s in plan.steps if s.kind == "fused"]
        if sp:
            assert not fused
            continue
        assert [s.replace_name for s in fused] == ["tokenweave"]
        assert [h.name.split("/")[-1] for h in fused[0].handles] == \
            ["ar_attn", "add_attn", "ln_mlp"]
        batch = {k: torch.from_numpy(v)
                 for k, v in prefill_inputs(2, 16, jm.cfg.vocab, 3).items()}
        want = tcompile(cfg, policy="sequential", device="cpu").prefill(
            2, 16)(tparams, batch)
        close(step(tparams, batch)["logits"], want["logits"])


def test_micro_batch_reads_are_views(pair):
    """Under a split plan, a micro-batch read of a FULL tensor shares the
    full tensor's storage (``narrow``, zero-copy)."""
    jm, jparams, prog, tparams = pair
    B, S = 4, 1024
    segs, _ = prog.model.build_segments("prefill", B, S, s_max=S)
    fwd = tbuild_forward(segs, "nanoflow",
                         ScheduleContext(local_batch=B, global_batch=B,
                                         seq_len=S, phase="prefill"))
    rz = fwd.realizers["layers"]
    assert isinstance(rz, Realizer) and rz.plan.split_sizes == (2, 2)
    slices = [(t, p) for rs in rz.analysis.reads for (t, p, m, _k) in rs
              if m == "slice"]
    assert slices
    for t, part in slices:
        full = torch.zeros(rz.graph.tensors[t].shape)
        view = rz._read({(t, FULL): full}, t, part, "slice", FULL)
        lo = full.data_ptr()
        hi = lo + full.numel() * full.element_size()
        assert lo <= view.data_ptr() < hi
        assert view.untyped_storage().data_ptr() == \
            full.untyped_storage().data_ptr()
