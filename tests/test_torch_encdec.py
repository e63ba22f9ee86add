"""The port's encoder-decoder family (src/repro_torch/models/whisper.py) and
its GELU MLP against the JAX package, on smoke whisper-tiny.

``repro``'s ``init_params(PRNGKey(0))`` is carried across with
``convert.params_from_numpy``.  Prefill, decode and the train step run in
both packages on the same seeded inputs: the JAX package interpreted
(``build_forward(..., lowered=False)``; its train step is
``_build_train_step(..., TrainStepConfig(lowered=False))``, jitted), the
port through ``api.compile`` on the CPU.  Tolerances are those of
tests/test_torch_model.py (bf16 atol=rtol=3e-2, atol scaled by the
reference's largest magnitude) and tests/test_torch_train.py (loss 2e-3
relative, grad norm 2e-2, each leaf's update within 5e-2 relative L2
under AdamW at lr 1 and eps 1, where an update is nearly linear in the
gradient).

Two behaviours of the JAX package are the port's too, and the tests
below show them: decode recomputes the cross-attention K/V from ``enc``
at every step, and attends to all ``s_max`` rows of ``enc`` with no
length mask, so an ``enc`` zero-padded past the prefill length dilutes
the cross-attention's softmax in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.core import ScheduleContext as JCtx
from repro.core.strategies.dynamic import dynamic_policy as jdynamic
from repro.models import whisper as jwhisper
from repro.models.base import build_forward as jbuild_forward
from repro.models.layers import GELUOp as JGELUOp
from repro.models.layers import MeshInfo as JMeshInfo
from repro.models.registry import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.train.step import TrainStepConfig as JTrainStepConfig
from repro.train.step import _build_train_step as jbuild_train_step
from repro_torch.api import compile as tcompile
from repro_torch.convert import params_from_numpy
from repro_torch.core.strategies.dynamic import dynamic_policy
from repro_torch.models import whisper as twhisper
from repro_torch.models.layers import GELUOp
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainStepConfig

ARCH = "whisper-tiny"
BF16 = dict(atol=3e-2, rtol=3e-2)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want):
    """bf16 tolerance, atol scaled by the reference's largest magnitude."""
    want = np32(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np32(got), want, atol=BF16["atol"] * scale,
                               rtol=BF16["rtol"])


def rel(a, b):
    a, b = np32(a), np32(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def bf16_both(a):
    """The same bf16 values for both packages: (jax array, torch tensor)."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def reference(arch, phase="prefill"):
    jm = jbuild_model(jget_smoke(arch), JMeshInfo())
    return jm, jm.init_params(jax.random.PRNGKey(0), phase=phase)


def run_jax(jm, jparams, phase, B, S, batch, s_max=None, policy="sequential"):
    q = 1 if phase == "decode" else S
    segs, _ = jm.build_segments(phase, B, q, s_max=s_max or S)
    info = JCtx(local_batch=B, global_batch=B, seq_len=s_max or S,
                phase=phase, arch=jm.cfg.name)
    fwd = jbuild_forward(segs, policy, info, lowered=False)
    return fwd(jparams, batch)


def train_both(arch, batch, jpolicy="sequential", tpolicy="sequential"):
    """One train step of the smoke model in both packages from the same
    weights and batch (numpy arrays; bf16 ones given as (jax, torch)
    pairs).  AdamW at lr 1, eps 1: each leaf's update is nearly linear in
    its gradient.  Returns (jax metrics, port metrics, jax params before
    and after, port params after, the port's step)."""
    jm, jp0 = reference(arch, "train")
    B, S = batch["ids"].shape
    jcfg = JTrainStepConfig(optimizer=jadamw.AdamWConfig(lr=1.0, eps=1.0),
                            lowered=False, warmup=1, total_steps=10)
    jfn, _, _, jinit = jbuild_train_step(
        jm, jpolicy, B, S, jcfg,
        JCtx(local_batch=B, global_batch=B, seq_len=S, phase="train",
             arch=jm.cfg.name))
    prog = tcompile(arch, policy=tpolicy, smoke=True, device="cpu")
    tstep = prog.train_step(B, S, cfg=TrainStepConfig(
        optimizer=AdamWConfig(lr=1.0, eps=1.0), warmup=1, total_steps=10))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp0),
                           device="cpu")
    jb = {k: v[0] if isinstance(v, tuple) else jnp.asarray(v)
          for k, v in batch.items()}
    tb = {k: v[1] if isinstance(v, tuple) else torch.from_numpy(v)
          for k, v in batch.items()}
    jp, _, jmet = jax.jit(jfn)(jp0, jinit(jp0), jb, jnp.int32(0))
    tp, _, tmet = tstep(tp, tstep.init_opt(tp), tb, 0)
    return ({k: float(v) for k, v in jmet.items()},
            {k: float(v) for k, v in tmet.items()}, jp0, jp, tp, tstep)


def check_step(jmet, tmet, jp0, jp, tp):
    assert tmet["tokens"] == jmet["tokens"]
    assert tmet["loss"] == pytest.approx(jmet["loss"], rel=2e-3)
    assert tmet["grad_norm"] == pytest.approx(jmet["grad_norm"], rel=2e-2)
    j0 = dict(jax.tree_util.tree_leaves_with_path(jp0))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        t = tp
        for k in path:
            t = t[k.key]
        old = np32(j0[path])
        assert rel(np32(t) - old, np32(leaf) - old) < 5e-2, path


def token_batch(B, S, vocab, seed):
    rng = np.random.default_rng(seed)
    return {"ids": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "positions": np.broadcast_to(np.arange(S, dtype=np.int32),
                                         (B, S)).copy()}


# ---------------------------------------------------------------------------
# the new ops
# ---------------------------------------------------------------------------


def test_gelu_is_the_tanh_form():
    """``GELUOp`` is ``jax.nn.gelu``'s default, the tanh approximation,
    within f32 round-off (1e-6), and not PyTorch's default erf form,
    which is up to ~5e-4 away from it near |x| = 2."""
    x = np.linspace(-6.0, 6.0, 4001, dtype=np.float32).reshape(1, 1, -1)
    want = np.asarray(JGELUOp().kernel(None, jnp.asarray(x)))
    got = GELUOp().kernel(None, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 100 * 1e-6
    # bf16 in, bf16 out, through f32
    jx, tx = bf16_both(x)
    close(GELUOp().kernel(None, tx), JGELUOp().kernel(None, jx))


@pytest.mark.parametrize("d", [384, 32, 2, 3])
def test_sinusoid_matches_reference(d):
    pos = np.arange(0, 1596, 7, dtype=np.int32).reshape(2, -1)
    want = np.asarray(jwhisper._sinusoid(jnp.asarray(pos), d))
    got = twhisper._sinusoid(torch.from_numpy(pos), d).numpy()
    assert got.shape == want.shape == pos.shape + (2 * (d // 2),)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-4)


def test_published_config_and_param_count():
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.enc_layers, cfg.d_model, cfg.n_heads, cfg.hd,
            cfg.vocab, cfg.act, cfg.rope) == (4, 4, 384, 6, 64, 51865,
                                              "gelu", "none")
    assert cfg.param_count() == jget(ARCH).param_count()


# ---------------------------------------------------------------------------
# smoke whisper-tiny against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    jm, jparams = reference(ARCH)
    prog = tcompile(ARCH, policy="sequential", smoke=True, device="cpu")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jm, jparams, prog, tparams


def test_params_carry_across(pair):
    jm, jparams, prog, tparams = pair
    flat = jax.tree_util.tree_leaves_with_path(jparams)
    # the encoder's embedding adds positions only: no params
    assert {p[0].key for p, _ in flat} == {"encoder", "embed", "decoder",
                                           "head"}
    for path, leaf in flat:
        t = tparams
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(np32(t), np32(leaf))
    # tied: the head has only its norm; GELU's wi is d -> d_ff
    assert set(tparams["head"]) == {"ln"}
    d, ff = jm.cfg.d_model, jm.cfg.d_ff
    assert tuple(tparams["encoder"]["mlp"]["wi"]["lin"]["w"].shape) == \
        (jm.cfg.enc_layers, d, ff)
    mine = prog.init_params(0)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, mine)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0,
                                                            jparams))


def prefill_batch(B, S, cfg, seed):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jf, tf = bf16_both(frames)
    tok = token_batch(B, S, cfg.vocab, seed)
    jb = {"frames": jf, **{k: jnp.asarray(v) for k, v in tok.items()}}
    tb = {"frames": tf, **{k: torch.from_numpy(v) for k, v in tok.items()}}
    return jb, tb


@pytest.mark.parametrize("B,S", [(2, 16), (1, 37)])
def test_prefill_logits_kv_and_enc_match(pair, B, S):
    jm, jparams, prog, tparams = pair
    jb, tb = prefill_batch(B, S, jm.cfg, 0)
    want = run_jax(jm, jparams, "prefill", B, S, jb)
    got = prog.prefill(B, S)(tparams, tb)
    assert got["logits"].shape == (B, 1, jm.cfg.vocab)
    assert got["enc"].shape == (B, S, jm.cfg.d_model)
    assert got["decoder.k"].shape == (jm.cfg.n_layers, B, S, jm.cfg.n_kv,
                                      jm.cfg.hd)
    for key in ("logits", "enc", "decoder.k", "decoder.v"):
        close(got[key], want[key])


def decode_batch(cfg, B, s_max, enc, seed, clen=None):
    rng = np.random.default_rng(seed)
    clen = np.asarray(clen or [0, 5, s_max - 1][:B], np.int32)
    shape = (cfg.n_layers, B, s_max, cfg.n_kv, cfg.hd)
    kc, kt = bf16_both(rng.standard_normal(shape) * 0.5)
    vc, vt = bf16_both(rng.standard_normal(shape) * 0.5)
    je, te = bf16_both(enc)
    ids = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    jb = {"ids": jnp.array(ids), "positions": jnp.array(clen[:, None]),
          "cache_len": jnp.array(clen), "enc": je, "k_cache": kc,
          "v_cache": vc}
    tb = {"ids": torch.from_numpy(ids),
          "positions": torch.from_numpy(clen[:, None].copy()),
          "cache_len": torch.from_numpy(clen), "enc": te, "k_cache": kt,
          "v_cache": vt}
    return jb, tb


def test_decode_logits_and_caches_match(pair):
    jm, jparams, prog, tparams = pair
    B, s_max = 3, 24
    enc = np.random.default_rng(3).standard_normal(
        (B, s_max, jm.cfg.d_model))
    jb, tb = decode_batch(jm.cfg, B, s_max, enc, 1)
    want = run_jax(jm, jparams, "decode", B, s_max, jb, s_max=s_max)
    kt = tb["k_cache"]
    got = prog.decode_tiers(B, s_max, tiers=(B,))[B](tparams, tb)
    for key in ("logits", "k_cache", "v_cache"):
        close(got[key], want[key])
    # the step wrote the new K/V into the caches it was given
    assert got["k_cache"].data_ptr() == kt.data_ptr()


def test_decode_over_prefill_enc_padded_is_unmasked_as_in_reference(pair):
    """Decode from a prefill's ``enc`` zero-padded to ``s_max`` (the
    reference's static shape): both packages attend to the padding rows,
    so the logits equal each other and differ from a decode over the
    unpadded ``enc`` (``s_max`` = the prefill length)."""
    jm, jparams, prog, tparams = pair
    B, S, s_max = 2, 12, 20
    jpre, tpre = prefill_batch(B, S, jm.cfg, 5)
    enc = np32(run_jax(jm, jparams, "prefill", B, S, jpre)["enc"])
    close(prog.prefill(B, S)(tparams, tpre)["enc"], enc)
    out = {}
    for width in (S, s_max):
        padded = np.zeros((B, width, jm.cfg.d_model), np.float32)
        padded[:, :S] = enc
        jb, tb = decode_batch(jm.cfg, B, width, padded, 6, clen=[3] * B)
        want = run_jax(jm, jparams, "decode", B, width, jb, s_max=width)
        got = prog.decode_tiers(B, width, tiers=(B,))[B](tparams, tb)
        close(got["logits"], want["logits"])
        out[width] = np32(got["logits"]), np32(want["logits"])
    for i in range(2):
        assert np.abs(out[S][i] - out[s_max][i]).max() > 1e-2


def test_decode_recomputes_cross_kv_from_enc(pair):
    """The decode layer projects ``enc`` to cross K/V inside the step (no
    cross cache): its graph has the cross ``kv_proj`` on ``enc`` at
    ``s_max`` rows, and a step over another ``enc`` gives other logits."""
    jm, jparams, prog, tparams = pair
    B, s_max = 2, 16
    step = prog.decode_tiers(B, s_max, tiers=(B,))[B]
    dec = [s for s in step.segments if s.name == "decoder"][0]
    g = dec.graph
    kv = [n for n in g.nodes.values() if n.name.endswith("cross_kv/kv_proj/kv_proj")]
    assert len(kv) == 1
    (src,) = kv[0].inputs
    assert src == g.inputs["enc"] and g.tensors[src].shape[1] == s_max
    rng = np.random.default_rng(9)
    outs = []
    for _ in range(2):
        _, tb = decode_batch(jm.cfg, B, s_max,
                             rng.standard_normal((B, s_max, 32)), 2)
        outs.append(step(tparams, tb)["logits"])
    assert float((outs[0] - outs[1]).abs().max()) > 1e-2


@pytest.mark.parametrize("policy", ["nanoflow", "tokenweave"])
def test_split_and_fused_plans_equal_sequential(pair, policy):
    jm, jparams, prog, tparams = pair
    B, S = 4, 1024             # 4096 tokens: nanoflow splits
    _, tb = prefill_batch(B, S, jm.cfg, 2)
    want = prog.prefill(B, S)(tparams, tb)
    other = tcompile(ARCH, policy=policy, smoke=True,
                     device="cpu").prefill(B, S)
    got = other(tparams, tb)
    if policy == "nanoflow":
        for key in ("encoder", "decoder"):
            assert other.fn.realizers[key].plan.split_sizes == (2, 2)
    else:
        # not sequence parallel: [all-reduce -> add -> RMSNorm] fuses
        for key in ("encoder", "decoder"):
            steps = other.fn.realizers[key].plan.steps
            assert any(s.replace_name == "tokenweave" for s in steps), key
    for key in ("logits", "enc", "decoder.k", "decoder.v"):
        a, b = got[key].float(), want[key].float()
        assert float((a - b).norm() / b.norm()) < 1e-2, key


@pytest.mark.parametrize("policy", ["sequential", "dynamic"])
def test_train_step_matches_reference(policy):
    """Loss and every gradient (through AdamW at lr 1, eps 1) of the train
    step, frames random, the embedding tied."""
    cfg = jget_smoke(ARCH)
    B, S = 2, 16
    rng = np.random.default_rng(11)
    ids = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    labels = ids[:, 1:].copy()
    labels[:, -3:] = -100
    batch = {"ids": ids[:, :-1].copy(), "labels": labels,
             "positions": token_batch(B, S, cfg.vocab, 0)["positions"],
             "frames": bf16_both(rng.standard_normal((B, S, cfg.d_model)))}
    pols = {"sequential": ("sequential", "sequential"),
            "dynamic": (jdynamic(split_tokens=16, seq_tokens=4),
                        dynamic_policy(split_tokens=16, seq_tokens=4))}
    jmet, tmet, jp0, jp, tp, step = train_both(ARCH, batch, *pols[policy])
    check_step(jmet, tmet, jp0, jp, tp)
    assert set(step.fn.strategies) == {"enc_embed", "encoder", "embed",
                                       "decoder", "head"}
    if policy == "dynamic":
        assert step.fn.strategies["decoder"] == "tokenweave"
