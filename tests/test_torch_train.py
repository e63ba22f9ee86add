"""The port's training path (src/repro_torch: optim, data, ft, train,
``Program.train_step``) against the JAX package.

Inputs are seeded numpy arrays handed to both packages; the smoke
models' weights are the reference's ``init_params(PRNGKey(0),
phase="train")``, carried across with ``convert.params_from_numpy``.  The
reference's train step runs through ``_build_train_step(...,
TrainStepConfig(lowered=False))``: its default lowered realize captures a
jaxpr with ``jax.core.jaxpr_as_fun``, which jax 0.9 removed.

Tolerances, and why:
  * AdamW, schedules, quantization and compression repeat the reference's
    f32 arithmetic: int8 codes equal, floats within 1e-6 relative (f32
    operations in another order), bf16 params within one bf16 ulp.
  * The train step: loss within 2e-3 relative and grad_norm within 2e-2
    relative.  The two frameworks round bf16 at other places (the
    reference's attention rounds its probabilities to bf16 and its
    autodiff rounds dh * g in bf16; the port's plain versions keep f32
    to each op's output), and a gradient norm sums those differences
    over every leaf.  The updated params: each leaf's update (new - old)
    within 5e-2 relative L2 of the reference's.  The parity runs take
    AdamW with eps 1 and lr 1: each update is then nearly linear in the
    (clipped) gradient, whose elements are far below 1, and well above a
    bf16 ulp of the weights, so the params after a step hold the two
    packages' gradients to each other.  At Adam's usual eps the first
    steps are lr * sign(g), and a near-zero gradient whose sign differs
    between the packages would move its weight by 2 lr.  The optimizer's
    own arithmetic is held exactly above.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.core import ScheduleContext as JCtx
from repro.core.strategies.dynamic import dynamic_policy as jdynamic
from repro.core.strategies.nanoflow import NanoFlow as JNanoFlow
from repro.data import pipeline as jpipe
from repro.dist import collectives as jcol
from repro.ft import checkpoint as jckpt
from repro.models.layers import MeshInfo as JMeshInfo
from repro.models.registry import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro.train.step import TrainStepConfig as JTrainStepConfig
from repro.train.step import _build_train_step as jbuild_train_step
from repro_torch.api import compile as tcompile
from repro_torch.convert import params_from_numpy
from repro_torch.core.strategies.dynamic import dynamic_policy
from repro_torch.core.strategies.nanoflow import NanoFlow
from repro_torch.data import (DataConfig, MemmapBackend, SyntheticBackend,
                              TokenPipeline)
from repro_torch.dist import collectives as col
from repro_torch.ft import (CheckpointManager, FailureSimulator,
                            restore_latest, save_checkpoint)
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule, dequantize_state,
                               linear_warmup, quantize_state)
from repro_torch.train import TrainLoopConfig, TrainStepConfig, train_loop
from repro_torch.tree import leaves, leaves_with_paths

ARCHS = ["smollm-135m", "chatglm3-6b"]
LR, EPS = 1.0, 1.0          # updates linear in the gradients (see above)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def rel(a, b):
    a, b = np32(a), np32(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def jtree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# optimizer, schedules, quantization, compression
# ---------------------------------------------------------------------------


def _opt_inputs(seed):
    rng = np.random.default_rng(seed)
    p = {"a": rng.standard_normal(37).astype(np.float32),
         "b": {"c": rng.standard_normal((5, 70)).astype(np.float32)}}
    grads = [{"a": rng.standard_normal(37).astype(np.float32) * 3,
              "b": {"c": rng.standard_normal((5, 70)).astype(np.float32)}}
             for _ in range(3)]
    return p, grads


@pytest.mark.parametrize("quantized", [False, True])
def test_adamw_matches_reference(quantized):
    p, grads = _opt_inputs(0)
    cfg_j = jadamw.AdamWConfig(lr=1e-2, quantized=quantized, block=64)
    cfg_t = AdamWConfig(lr=1e-2, quantized=quantized, block=64)
    jp = {"a": jnp.asarray(p["a"]).astype(jnp.bfloat16),
          "b": {"c": jnp.asarray(p["b"]["c"])}}
    tp = params_from_numpy(jtree(jp), device="cpu")
    jo, to = jadamw.adamw_init(jp, cfg_j), adamw_init(tp, cfg_t)
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1)
        jp, jo, jn = jadamw.adamw_update(
            jp, jax.tree_util.tree_map(jnp.asarray, g), jo, cfg_j,
            lr=jnp.float32(lr))
        tp2, to2, tn = adamw_update(
            tp, params_from_numpy(g, device="cpu"), to, cfg_t,
            lr=torch.tensor(lr))
        assert tp2 is tp and to2 is to           # updated in place
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    assert int(to["count"]) == int(jo["count"]) == 3
    # bf16 param: one ulp; f32 param and the states: f32 round-off
    np.testing.assert_allclose(np32(tp["a"]), np32(jp["a"]), rtol=2 ** -7,
                               atol=0)
    np.testing.assert_allclose(np32(tp["b"]["c"]), np32(jp["b"]["c"]),
                               rtol=1e-6, atol=1e-7)
    for path in (("a",), ("b", "c")):
        js, ts = jo["state"], to["state"]
        for k in path:
            js, ts = js[k], ts[k]
        np.testing.assert_allclose(np32(ts["m"]), np32(js["m"]), rtol=1e-5,
                                   atol=1e-7)
        if quantized:
            np.testing.assert_array_equal(ts["v"]["q"].numpy(),
                                          np.asarray(js["v"]["q"]))
            np.testing.assert_allclose(ts["v"]["scale"].numpy(),
                                       np.asarray(js["v"]["scale"]),
                                       rtol=1e-6)
        else:
            np.testing.assert_allclose(np32(ts["v"]), np32(js["v"]),
                                       rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("seed", range(4))
def test_quantize_state_codes_equal_reference(seed):
    rng = np.random.default_rng(seed)
    v = np.abs(rng.standard_normal(300)).astype(np.float32) * 10
    v[rng.integers(0, 300, 20)] = 0.0
    v[:5] = 1e-6
    jq = jadamw.quantize_state(jnp.asarray(v), 64)
    tq = quantize_state(torch.from_numpy(v), 64)
    np.testing.assert_array_equal(tq["q"].numpy(), np.asarray(jq["q"]))
    np.testing.assert_array_equal(tq["scale"].numpy(),
                                  np.asarray(jq["scale"]))
    np.testing.assert_allclose(
        dequantize_state(tq, (300,)).numpy(),
        np.asarray(jadamw.dequantize_state(jq, (300,))), rtol=1e-6)


def test_schedules_match_reference():
    for s in range(0, 130, 3):
        for warmup, total in ((10, 100), (1, 20), (100, 10000)):
            np.testing.assert_allclose(
                float(cosine_schedule(s, warmup, total, 3e-4)),
                float(jsched.cosine_schedule(s, warmup, total, 3e-4)),
                rtol=1e-6)
            np.testing.assert_allclose(
                float(linear_warmup(s, warmup, 1e-3)),
                float(jsched.linear_warmup(s, warmup, 1e-3)), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compressed_psum_matches_reference(dtype):
    """Unbound, ``compressed_psum`` still quantizes to int8 with error
    feedback, in both packages alike."""
    rng = np.random.default_rng(1)
    jerr = terr = None
    for _ in range(3):
        x = rng.standard_normal(257).astype(np.float32)
        jx = jnp.asarray(x).astype(dtype)
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
        jr, jerr = jcol.compressed_psum(jx, "data", jerr)
        tr, terr = col.compressed_psum(tx, "data", terr)
        assert tr.dtype == tx.dtype and terr.dtype == tx.dtype
        np.testing.assert_array_equal(np32(tr), np32(jr))
        np.testing.assert_allclose(np32(terr), np32(jerr), rtol=1e-6,
                                   atol=1e-7)
        assert not np.array_equal(np32(tr), np32(tx))   # it quantized


# ---------------------------------------------------------------------------
# data pipeline and checkpoints
# ---------------------------------------------------------------------------


def test_pipeline_matches_reference(tmp_path):
    S = 8
    for n_hosts, host in ((1, 0), (2, 1)):
        kw = dict(seq_len=S, global_batch=4, n_hosts=n_hosts,
                  host_index=host, seed=3)
        tb, jb = SyntheticBackend(100), jpipe.SyntheticBackend(100)
        for step in (0, 5, 17):
            a = tb.batch(DataConfig(**kw), step)
            b = jb.batch(jpipe.DataConfig(**kw), step)
            for k in ("ids", "labels"):
                np.testing.assert_array_equal(a[k], b[k])
    tokens = np.arange(10 * (S + 1), dtype=np.int32)
    path = tmp_path / "tokens.bin"
    tokens.tofile(path)
    for step in (0, 3):
        a = MemmapBackend(str(path), S).batch(DataConfig(S, 2), step)
        b = jpipe.MemmapBackend(str(path), S).batch(jpipe.DataConfig(S, 2),
                                                    step)
        np.testing.assert_array_equal(a["ids"], b["ids"])
        np.testing.assert_array_equal(a["labels"], b["labels"])
    # the cursor: seek and state_dict as the reference's
    tp = TokenPipeline(SyntheticBackend(100), DataConfig(S, 4))
    jp = jpipe.TokenPipeline(jpipe.SyntheticBackend(100),
                             jpipe.DataConfig(S, 4))
    for _ in range(3):
        np.testing.assert_array_equal(next(tp)["ids"], next(jp)["ids"])
    assert tp.state_dict() == jp.state_dict()
    tp.seek(1)
    jp.seek(1)
    np.testing.assert_array_equal(next(tp)["ids"], next(jp)["ids"])
    resumed = TokenPipeline(SyntheticBackend(100), DataConfig(S, 4))
    resumed.load_state_dict(jp.state_dict())
    np.testing.assert_array_equal(next(resumed)["ids"], next(jp)["ids"])


def _ckpt_tree():
    rng = np.random.default_rng(2)
    return {"a": torch.from_numpy(rng.standard_normal((2, 3)).astype(
                np.float32)),
            "b": {"c": torch.from_numpy(rng.standard_normal(4).astype(
                      np.float32)).to(torch.bfloat16),
                  "d": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoints_read_across_packages(tmp_path):
    """The port's checkpoint layout and manifest are the reference's: each
    package restores what the other saved, bf16 bits included."""
    tree = _ckpt_tree()
    save_checkpoint(str(tmp_path / "t"), 12, tree, data_state={"step": 12})
    jex = jax.tree_util.tree_map(lambda t: np.zeros(t.shape), jtree(
        params_from_numpy_np(tree)))
    step, back, ds = jckpt.restore_latest(str(tmp_path / "t"), jex)
    assert step == 12 and ds == {"step": 12}
    assert back["b"]["c"].dtype == jnp.bfloat16
    for (_, a), b in zip(leaves_with_paths(tree),
                         jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np32(a), np.asarray(b, np.float32))
    jckpt.save_checkpoint(str(tmp_path / "j"), 3, back)
    step, again, _ = restore_latest(str(tmp_path / "j"), tree)
    assert step == 3
    for a, b in zip(leaves(tree), leaves(again)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with open(tmp_path / "t" / "step_00000012" / "manifest.json") as f:
        t_manifest = f.read()
    jckpt.save_checkpoint(str(tmp_path / "j2"), 12, back,
                          data_state={"step": 12})
    with open(tmp_path / "j2" / "step_00000012" / "manifest.json") as f:
        assert f.read() == t_manifest


def params_from_numpy_np(tree):
    """A torch tree as numpy (bf16 through ml_dtypes), for the JAX side."""
    import ml_dtypes
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = params_from_numpy_np(v)
        elif v.dtype == torch.bfloat16:
            out[k] = v.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        else:
            out[k] = v.numpy()
    return out


def test_checkpoint_atomic_async_and_retention(tmp_path):
    tree = _ckpt_tree()
    save_checkpoint(str(tmp_path), 1, tree)
    os.makedirs(tmp_path / "step_00000002.tmp")      # a crashed save
    assert restore_latest(str(tmp_path), tree)[0] == 1
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (3, 4, 5):
        mgr.save_async(s, tree)
        tree["a"].add_(1.0)       # the snapshot was taken: no aliasing
    mgr.wait()
    steps = sorted(d for d in os.listdir(tmp_path)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    assert steps == ["step_00000004", "step_00000005"]
    step, back, _ = restore_latest(str(tmp_path), tree)
    assert step == 5
    np.testing.assert_array_equal(back["a"].numpy(), tree["a"].numpy() - 1)


# ---------------------------------------------------------------------------
# the loss ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("S,chunk", [(12, 5), (16, 16)])
def test_head_loss_op_matches_reference(tied, S, chunk):
    """``HeadLossOp``: per-sample loss sums and token counts, and the
    gradients of x and W, against the reference's op (its chunks padded
    with ignored labels) and ``jax.vjp``, chunk by chunk."""
    from repro.models.layers import HeadLossOp as JHeadLossOp
    from repro_torch.models.layers import HeadLossOp, MeshInfo
    B, d, V = 3, 16, 40
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    w = (rng.standard_normal((V, d) if tied else (d, V)) * 0.3).astype(
        np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[0, :4] = -100
    g_ls = rng.standard_normal(B).astype(np.float32)
    tie = ("embed", "emb") if tied else None
    jop = JHeadLossOp(d, V, JMeshInfo(), tie_path=tie, chunk=chunk)
    top = HeadLossOp(d, V, MeshInfo(), tie_path=tie, chunk=chunk)
    jx, jw = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w))
    (jls, jcnt), vjp = jax.vjp(
        lambda x_, w_: jop.kernel({"w": w_}, x_, jnp.asarray(labels)),
        jx, jw)
    jdx, jdw = vjp((jnp.asarray(g_ls), jnp.zeros(B, jnp.float32)))
    tx, tw = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
              for a in (x, w))
    ls, cnt = top.kernel({"w": tw}, tx, torch.from_numpy(labels))
    dx, dw = torch.autograd.grad(ls, (tx, tw), torch.from_numpy(g_ls))
    np.testing.assert_array_equal(cnt.detach().numpy(), np.asarray(jcnt))
    np.testing.assert_allclose(ls.detach().numpy(), np.asarray(jls),
                               rtol=1e-5)
    # dx, dW: bf16 outputs (the reference sums dW's chunks in bf16)
    for a, b in ((dx, jdx), (dw, jdw)):
        assert rel(a, b) < 1e-2
        np.testing.assert_allclose(np32(a), np32(b), rtol=2e-2,
                                   atol=2e-2 * np.abs(np32(b)).max())


def test_sharded_xent_op_matches_reference():
    from repro.models.layers import ShardedXentOp as JXent
    from repro_torch.models.layers import MeshInfo, ShardedXentOp
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 7, 30)).astype(np.float32) * 3
    labels = rng.integers(0, 30, (2, 7)).astype(np.int32)
    jl, vjp = jax.vjp(lambda l_: JXent(JMeshInfo(), 30).kernel(
        {}, l_, jnp.asarray(labels)), jnp.asarray(logits))
    (jg,) = vjp(jnp.float32(1.0))
    tl = torch.from_numpy(logits).requires_grad_()
    loss = ShardedXentOp(MeshInfo(), 30).kernel({}, tl,
                                                torch.from_numpy(labels))
    (tg,) = torch.autograd.grad(loss, tl)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-7)


# ---------------------------------------------------------------------------
# the train step against the reference
# ---------------------------------------------------------------------------


def _policy(name, jax_side):
    """Strategy of the test: the registry's, or one whose thresholds split
    or fuse at the test's 64 tokens."""
    if name == "nanoflow":
        return (JNanoFlow if jax_side else NanoFlow)(min_tokens=16)
    if name == "dynamic":
        return (jdynamic if jax_side else dynamic_policy)(
            split_tokens=16, seq_tokens=4)
    return name


def _train_batch(vocab, B, S, seed, accum=0):
    rng = np.random.default_rng(seed)
    shape = (accum, B, S + 1) if accum else (B, S + 1)
    ids = rng.integers(0, vocab, shape).astype(np.int32)
    labels = ids[..., 1:].copy()
    labels[..., -3:] = -100                      # ignored positions
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), shape[:-1] + (S,))
    return {"ids": ids[..., :-1].copy(), "labels": labels,
            "positions": pos.copy()}


_REFERENCE: dict = {}


def _reference(arch):
    """The reference's smoke model and train-phase weights, once a run."""
    if arch not in _REFERENCE:
        jm = jbuild_model(jget_smoke(arch), JMeshInfo())
        _REFERENCE[arch] = jm, jm.init_params(jax.random.PRNGKey(0),
                                               phase="train")
    return _REFERENCE[arch]


def _jit_step(*args):
    fn, segs, binputs, init = jbuild_train_step(*args)
    return jax.jit(fn), segs, binputs, init


def _run_both(arch, policy, B=4, S=16, steps=2, accum=0, **tcfg):
    """``steps`` train steps of the smoke model in both packages from the
    same weights and batches.  Returns (jax metrics, port metrics, jax
    params before and after, port params after, port step)."""
    jm, jp0 = _reference(arch)
    jopt_cfg = jadamw.AdamWConfig(
        lr=LR, eps=EPS, quantized=tcfg.get("quantized", False), block=64)
    topt_cfg = AdamWConfig(lr=LR, eps=EPS,
                           quantized=tcfg.pop("quantized", False), block=64)
    jcfg = JTrainStepConfig(optimizer=jopt_cfg, lowered=False, warmup=1,
                            total_steps=10, grad_accum=max(accum, 1),
                            **tcfg)
    tcfg = TrainStepConfig(optimizer=topt_cfg, warmup=1, total_steps=10,
                           grad_accum=max(accum, 1), **tcfg)
    jfn, _, _, jinit = _jit_step(
        jm, _policy(policy, True), B, S, jcfg,
        JCtx(local_batch=B, global_batch=B, seq_len=S, phase="train",
             arch=jm.cfg.name))
    prog = tcompile(arch, policy=_policy(policy, False), smoke=True,
                    device="cpu")
    tstep = prog.train_step(B, S, cfg=tcfg)
    tp = params_from_numpy(jtree(jp0), device="cpu")
    jp, jo, to = jp0, jinit(jp0), tstep.init_opt(tp)
    jms, tms = [], []
    for i in range(steps):
        batch = _train_batch(jm.cfg.vocab, B, S, 10 + i, accum)
        jp, jo, jmet = jfn(jp, jo, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, jnp.int32(i))
        tp, to, tmet = tstep(tp, to, {k: torch.from_numpy(v)
                                      for k, v in batch.items()}, i)
        jms.append({k: float(v) for k, v in jmet.items()})
        tms.append({k: float(v) for k, v in tmet.items()})
    return jms, tms, jp0, jp, tp, tstep


def _check_step(jms, tms, jp0, jp, tp, limits=None):
    """``limits``: leaf path (a tuple of keys) -> its update's relative L2
    limit, where it is not 5e-2."""
    for jm_, tm_ in zip(jms, tms):
        assert tm_["tokens"] == jm_["tokens"]
        assert tm_["lr"] == pytest.approx(jm_["lr"], rel=1e-6)
        assert tm_["loss"] == pytest.approx(jm_["loss"], rel=2e-3)
        assert tm_["grad_norm"] == pytest.approx(jm_["grad_norm"], rel=2e-2)
    j0 = dict(jax.tree_util.tree_leaves_with_path(jp0))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        keys = tuple(k.key for k in path)
        t = tp
        for k in keys:
            t = t[k]
        old = np32(j0[path])
        limit = (limits or {}).get(keys, 5e-2)
        assert rel(np32(t) - old, np32(leaf) - old) < limit, path


@pytest.mark.parametrize("policy", ["sequential", "nanoflow", "tokenweave",
                                    "dynamic"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, policy):
    jms, tms, jp0, jp, tp, step = _run_both(arch, policy)
    _check_step(jms, tms, jp0, jp, tp)
    want = {"sequential": "sequential", "nanoflow": "nanoflow",
            "tokenweave": "tokenweave",
            # smollm has [all-reduce -> add -> norm] chains (not sequence
            # parallel): TokenWeave; chatglm3-6b is sequence parallel
            "dynamic": "tokenweave" if arch == "smollm-135m"
            else "nanoflow"}[policy]
    assert step.strategies["layers"] == want
    if policy == "nanoflow" or want == "nanoflow":
        assert step.fn.forward.realizers["layers"].plan.split_sizes == (2, 2)


@pytest.mark.parametrize("remat,remat_policy", [(False, "full"),
                                                (True, "dots")])
def test_train_step_remat_variants_match_reference(remat, remat_policy):
    jms, tms, jp0, jp, tp, step = _run_both(
        "smollm-135m", "sequential", remat=remat, remat_policy=remat_policy)
    _check_step(jms, tms, jp0, jp, tp)
    assert step.fn.forward.remat is remat
    assert step.fn.forward.remat_policy == remat_policy


def test_remat_recomputes_the_layers():
    """Under remat the backward runs each layer's plan a second time, and
    the gradients equal the ones without remat."""
    from repro_torch.core.backend import Realizer
    calls = []
    orig = Realizer.__call__

    def counting(self, *a, **kw):
        calls.append(1)
        return orig(self, *a, **kw)

    out = {}
    for remat in (False, True):
        prog = tcompile("smollm-135m", policy="sequential", smoke=True,
                        device="cpu")
        step = prog.train_step(2, 16, cfg=TrainStepConfig(remat=remat))
        p = prog.init_params(0, device="cpu", phase="train")
        batch = {k: torch.from_numpy(v)
                 for k, v in _train_batch(prog.model.cfg.vocab, 2, 16,
                                          5).items()}
        calls.clear()
        Realizer.__call__ = counting
        try:
            _, _, m = step(p, step.init_opt(p), batch, 0)
        finally:
            Realizer.__call__ = orig
        out[remat] = (len(calls), float(m["grad_norm"]), p)
    n_layers = 2
    assert out[True][0] == out[False][0] + n_layers
    assert out[True][1] == out[False][1]
    for a, b in zip(leaves(out[True][2]), leaves(out[False][2])):
        assert torch.equal(a, b)


def test_grad_accum_matches_reference_and_doubled_batch():
    jms, tms, jp0, jp, tp, _ = _run_both("smollm-135m", "sequential",
                                         B=2, steps=1, accum=2)
    _check_step(jms, tms, jp0, jp, tp)
    # against one step on the doubled batch: the reference sums the two
    # micro-batches' gradients (each of its own mean loss), so the norm is
    # twice the doubled batch's while the loss is the same mean
    prog = tcompile("smollm-135m", policy="sequential", smoke=True,
                    device="cpu")
    batch = _train_batch(prog.model.cfg.vocab, 2, 16, 10, accum=2)
    _, jp0 = _reference("smollm-135m")
    p = params_from_numpy(jtree(jp0), device="cpu")
    step = prog.train_step(4, 16, cfg=TrainStepConfig(
        optimizer=AdamWConfig(lr=LR, eps=EPS), warmup=1, total_steps=10))
    flat = {k: torch.from_numpy(v.reshape((4,) + v.shape[2:]))
            for k, v in batch.items()}
    _, _, m = step(p, step.init_opt(p), flat, 0)
    assert tms[0]["loss"] == pytest.approx(float(m["loss"]), rel=1e-5)
    assert tms[0]["grad_norm"] == pytest.approx(2 * float(m["grad_norm"]),
                                                rel=1e-2)
    assert tms[0]["tokens"] == float(m["tokens"])


@pytest.mark.parametrize("compress,quantized", [(True, False), (False, True),
                                                (True, True)])
def test_compressed_grads_and_quantized_opt_match_reference(compress,
                                                            quantized):
    jms, tms, jp0, jp, tp, _ = _run_both(
        "smollm-135m", "sequential", steps=3, compress_grads=compress,
        quantized=quantized)
    _check_step(jms, tms, jp0, jp, tp)


def test_program_train_step_handle_and_verify():
    prog = tcompile("chatglm3-6b", policy="sequential", smoke=True,
                    device="cpu", verify="strict")
    step = prog.train_step(2, 16)
    assert step.init_opt is not None and callable(step.fn)
    assert set(step.batch_inputs) == {"ids", "labels", "positions"}
    assert [s.name for s in step.segments] == ["embed", "layers", "head"]
    labels = [lab for lab, _ in prog.verify_reports()]
    assert labels == ["train/embed", "train/layers", "train/head"]
    assert prog.verify().ok
    # the train tree has the serve tree's layout (the head's weight is
    # its ``out`` op's in both), so trained weights serve as they are
    p = prog.init_params(0, device="cpu", phase="train")
    serve = prog.init_params(0, device="cpu")
    assert [k for k, _ in leaves_with_paths(p)] == \
        [k for k, _ in leaves_with_paths(serve)]
    # the store shares the second bucket's plans with the first
    before = prog.stats["shares"]
    prog.train_step(2, 32)
    assert prog.stats["shares"] > before


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_ssm_families_train_step_handle_and_verify(arch):
    """The SSM and hybrid families train: ``TrainHead`` for the train
    phase, a step that builds and verifies, and a train tree with the
    serve tree's layout (their parity: tests/test_torch_ssm_train.py)."""
    from repro_torch.models.base import TrainHead
    prog = tcompile(arch, policy="sequential", smoke=True, device="cpu",
                    verify="strict")
    assert isinstance(prog.model.make_head("train"), TrainHead)
    step = prog.train_step(2, 16)
    assert step.init_opt is not None and callable(step.fn)
    assert set(step.batch_inputs) == {"ids", "labels", "positions"}
    assert prog.verify().ok
    p = prog.init_params(0, device="cpu", phase="train")
    serve = prog.init_params(0, device="cpu")
    assert [k for k, _ in leaves_with_paths(p)] == \
        [k for k, _ in leaves_with_paths(serve)]


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


def test_train_loop_crash_restart_end_to_end(tmp_path):
    """The port's version of tests/test_substrate.py's: crash mid-run,
    restore from the checkpoint, finish; the data cursor resumes exactly,
    and the re-run steps repeat the uncrashed run's losses."""
    prog = tcompile("smollm-135m", policy="sequential", smoke=True,
                    device="cpu")
    B, S = 2, 16
    step = prog.train_step(B, S, cfg=TrainStepConfig(
        optimizer=AdamWConfig(lr=1e-3), remat=False, warmup=1,
        total_steps=20))
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)

    def to_dev(b):
        return {"ids": torch.from_numpy(b["ids"]),
                "labels": torch.from_numpy(b["labels"]), "positions": pos}

    hists = {}
    for name, crash in (("clean", ()), ("crash", (6,))):
        params = prog.init_params(0, device="cpu", phase="train")
        opt = step.init_opt(params)
        pipe = TokenPipeline(SyntheticBackend(prog.model.cfg.vocab),
                             DataConfig(seq_len=S, global_batch=B))
        sim = FailureSimulator(crash_steps=crash)
        _, _, hist = train_loop(
            step.fn, params, opt, pipe,
            TrainLoopConfig(steps=10, ckpt_dir=str(tmp_path / name),
                            ckpt_every=4, log_every=100),
            failure_sim=sim, to_device=to_dev)
        assert sim.injected == [("crash", c) for c in crash]
        hists[name] = hist
    steps_run = [h["step"] for h in hists["crash"]]
    assert steps_run[-1] == 9
    # steps 4, 5 re-run after restoring the step-4 checkpoint
    assert steps_run.count(4) == 2 and steps_run.count(5) == 2
    rerun = hists["crash"][6:]
    assert [h["step"] for h in rerun] == list(range(4, 10))
    for h, want in zip(rerun, hists["clean"][4:]):
        assert h["loss"] == want["loss"]
    assert restore_latest(str(tmp_path / "crash"),
                          {"params": params, "opt": opt})[0] == 10


def test_train_loop_straggler_flag(tmp_path):
    prog = tcompile("smollm-135m", policy="sequential", smoke=True,
                    device="cpu")
    step = prog.train_step(2, 16, cfg=TrainStepConfig(remat=False))
    params = prog.init_params(0, device="cpu", phase="train")
    pos = torch.arange(16, dtype=torch.int32).expand(2, 16)
    # a step takes ~30 ms here, the straggler sleeps 3 s: far from the
    # deadline on either side, on a loaded machine too
    sim = FailureSimulator(straggle_steps=(2,), straggle_s=3.0)
    _, _, hist = train_loop(
        step.fn, params, step.init_opt(params),
        TokenPipeline(SyntheticBackend(prog.model.cfg.vocab),
                      DataConfig(seq_len=16, global_batch=2)),
        TrainLoopConfig(steps=4, step_deadline_s=2.0, log_every=100),
        failure_sim=sim,
        to_device=lambda b: {"ids": torch.from_numpy(b["ids"]),
                             "labels": torch.from_numpy(b["labels"]),
                             "positions": pos})
    assert [h.get("straggler", 0.0) for h in hist] == [0.0, 0.0, 1.0, 0.0]
