"""The train step captured as one CUDA Graph (``train/step.py``
``TrainStep``), the multi-tensor AdamW kernel (``kernels/adamw.py``,
``csrc/adamw.cu``) and the loop's in-place restore.

On the CPU the step runs eagerly and the AdamW wrapper takes its plain
version, the eager chain; these cases hold:

  * the lr's host arithmetic: a step given as a Python int and as a 0-d
    int tensor gives the same bits;
  * the loop's restore writes into the live tensors (every param and
    optimizer leaf keeps its address) and repeats the uncrashed losses
    exactly;
  * ``adamw_update``, now routing f32-state leaves through
    ``kernels.adamw.adamw`` and building its constants on the device,
    against the JAX package's ``adamw_update``, with the tolerances of
    ``tests/test_torch_train.py:test_adamw_matches_reference`` (one bf16
    ulp for a bf16 param, f32 round-off for the rest; the int8 codes
    equal);
  * a CPU program's step is the eager step: same bits, no capture;
  * under ``compress_grads`` the error-feedback residuals stay in their
    tensors, with the bits of the reference's f32 start.

The ``cuda``-marked cases run on the card (skipped here): the replayed
graph against ``fn.eager`` bit for bit, the kernel against its plain
chain bit for bit, one capture per set of storages and none after a
restore; a MoE layer stack under DBO (its memory ops on a side stream)
the same way, and its remat gradients against the kept activations'
bit for bit (the recompute runs on the forward's stream whichever
node starts it).  The JAX package is imported only by the cases that compare
with it, so this file runs on a machine without it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api import compile as tcompile
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data import DataConfig, SyntheticBackend, TokenPipeline
from repro_torch.ft import FailureSimulator
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import adamw as kadamw
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.train import TrainLoopConfig, TrainStepConfig, train_loop
from repro_torch.tree import leaves, tree_map


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree.detach().clone()


def _same_bits(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.cpu(), y.cpu())


def _batch(vocab, B, S, seed, dev="cpu"):
    b = SyntheticBackend(vocab).batch(
        DataConfig(seq_len=S, global_batch=B, seed=seed), 0)
    pos = torch.arange(S, dtype=torch.int32).expand(B, S).contiguous()
    return {"ids": torch.from_numpy(b["ids"]).to(dev),
            "labels": torch.from_numpy(b["labels"]).to(dev),
            "positions": pos.to(dev)}


def _smoke_step(B=2, S=16, **kw):
    prog = tcompile("smollm-135m", policy="sequential", smoke=True,
                    device="cpu")
    tcfg = TrainStepConfig(optimizer=AdamWConfig(lr=1e-3), remat=False,
                           warmup=2, total_steps=20, **kw)
    return prog, prog.train_step(B, S, cfg=tcfg)


# ---------------------------------------------------------------------------
# the CPU path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("step_no", [0, 1, 7])
def test_step_as_int_or_tensor_gives_the_same_bits(dtype, step_no):
    prog, step = _smoke_step()
    params = prog.init_params(0, device="cpu", phase="train")
    other = _copy(params)
    opt, other_opt = step.init_opt(params), step.init_opt(other)
    batch = _batch(prog.model.cfg.vocab, 2, 16, 3)
    _, _, m = step(params, opt, batch, step_no)
    _, _, m2 = step(other, other_opt, batch, torch.tensor(step_no,
                                                          dtype=dtype))
    _same_bits(params, other)
    _same_bits(opt, other_opt)
    _same_bits(m, m2)
    assert m["lr"].dtype == torch.float32 and m["lr"].device.type == "cpu"


def _loop(step, params, opt, prog, ckpt, steps, crash=()):
    sim = FailureSimulator(crash_steps=crash)
    B, S = 2, 16
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    pipe = TokenPipeline(SyntheticBackend(prog.model.cfg.vocab),
                         DataConfig(seq_len=S, global_batch=B))
    out = train_loop(
        step.fn, params, opt, pipe,
        TrainLoopConfig(steps=steps, ckpt_dir=ckpt, ckpt_every=3,
                        log_every=100),
        failure_sim=sim,
        to_device=lambda b: {"ids": torch.from_numpy(b["ids"]),
                             "labels": torch.from_numpy(b["labels"]),
                             "positions": pos})
    return out, sim


def test_crash_restart_keeps_the_storages_and_the_losses(tmp_path):
    prog, step = _smoke_step()
    hists = {}
    for name, crash in (("clean", ()), ("crash", (5,))):
        params = prog.init_params(0, device="cpu", phase="train")
        opt = step.init_opt(params)
        ptrs = [t.data_ptr() for t in leaves(params) + leaves(opt)]
        (p, o, hist), sim = _loop(step, params, opt, prog,
                                  str(tmp_path / name), 8, crash)
        assert sim.injected == [("crash", c) for c in crash]
        assert p is params and o is opt
        assert [t.data_ptr() for t in leaves(p) + leaves(o)] == ptrs
        hists[name] = hist
    rerun = hists["crash"][5:]
    assert [h["step"] for h in rerun] == list(range(3, 8))
    for h, want in zip(rerun, hists["clean"][3:]):
        assert h["loss"] == want["loss"]
        assert h["grad_norm"] == want["grad_norm"]


def test_restore_at_start_writes_into_the_live_tensors(tmp_path):
    """A loop started on a directory that holds a checkpoint resumes from
    it in the tensors passed in, and ends where an unbroken run ends."""
    prog, step = _smoke_step()
    ckpt = str(tmp_path / "ck")
    params = prog.init_params(0, device="cpu", phase="train")
    _loop(step, params, step.init_opt(params), prog, ckpt, 3)
    fresh = prog.init_params(1, device="cpu", phase="train")
    fresh_opt = step.init_opt(fresh)
    ptrs = [t.data_ptr() for t in leaves(fresh) + leaves(fresh_opt)]
    (p, o, hist), _ = _loop(step, fresh, fresh_opt, prog, ckpt, 6)
    assert [h["step"] for h in hist] == [3, 4, 5]
    assert [t.data_ptr() for t in leaves(p) + leaves(o)] == ptrs
    clean = prog.init_params(0, device="cpu", phase="train")
    (cp, co, chist), _ = _loop(step, clean, step.init_opt(clean), prog,
                               str(tmp_path / "clean"), 6)
    assert [h["loss"] for h in hist] == [h["loss"] for h in chist[3:]]
    _same_bits(p, cp)
    _same_bits(o, co)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_compressed_grads_residuals_stay_in_place(grad_accum):
    """``compress_grads``: ``init_opt`` makes the residuals in the grads'
    dtype and the step writes them in place (their addresses stay, as a
    graph needs), with the bits of a state that starts from the
    reference's f32 zeros, which the step rebinds."""
    B = 2 * grad_accum
    prog, step = _smoke_step(B=B, compress_grads=True,
                             grad_accum=grad_accum)
    params = prog.init_params(0, device="cpu", phase="train")
    other = _copy(params)
    opt, other_opt = step.init_opt(params), step.init_opt(other)
    other_opt["grad_errors"] = tree_map(lambda e: torch.zeros(e.shape),
                                        other_opt["grad_errors"])
    want = torch.float32 if grad_accum > 1 else None
    ptrs = [t.data_ptr() for t in leaves(opt)]
    for p, e in zip(leaves(params), leaves(opt["grad_errors"])):
        assert e.dtype == (want or p.dtype)
    for i in range(3):
        batch = _batch(prog.model.cfg.vocab, B, 16, 3 + i)
        if grad_accum > 1:
            batch = {k: v.reshape((grad_accum, 2) + v.shape[1:])
                     for k, v in batch.items()}
        step(params, opt, batch, i)
        step(other, other_opt, batch, i)
        assert [t.data_ptr() for t in leaves(opt)] == ptrs
        _same_bits(params, other)
        _same_bits(opt, other_opt)


def _opt_case(seed, dtypes):
    rng = np.random.default_rng(seed)
    shapes = [(37,), (5, 70), (1,), (577,)]
    p = {f"l{i}": rng.standard_normal(s).astype(np.float32)
         for i, s in enumerate(shapes)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) * 3
              for k, v in p.items()} for _ in range(3)]
    return p, grads, {f"l{i}": dtypes[i % len(dtypes)]
                      for i in range(len(shapes))}


@pytest.mark.parametrize("grad_clip", [0.0, 1.0])
@pytest.mark.parametrize("quantized", [False, True])
def test_adamw_update_matches_reference(quantized, grad_clip):
    """As ``test_adamw_matches_reference`` holds it, with mixed bf16/f32
    leaves, the leaf sizes the kernel tiles raggedly and clipping on and
    off."""
    import jax
    import jax.numpy as jnp

    from repro.optim import adamw as jadamw
    p, grads, dt = _opt_case(1, ("bfloat16", "float32"))
    cfg_j = jadamw.AdamWConfig(lr=1e-2, quantized=quantized, block=64,
                               grad_clip=grad_clip)
    cfg_t = AdamWConfig(lr=1e-2, quantized=quantized, block=64,
                        grad_clip=grad_clip)
    jp = {k: jnp.asarray(v).astype(dt[k]) for k, v in p.items()}
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    jo, to = jadamw.adamw_init(jp, cfg_j), adamw_init(tp, cfg_t)
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1)
        jg = {k: jnp.asarray(v).astype(dt[k]) for k, v in g.items()}
        jp, jo, jn = jadamw.adamw_update(jp, jg, jo, cfg_j,
                                         lr=jnp.float32(lr))
        tg = params_from_numpy(jax.tree_util.tree_map(np.asarray, jg),
                               device="cpu")
        tp2, to2, tn = adamw_update(tp, tg, to, cfg_t, lr=torch.tensor(lr))
        assert tp2 is tp and to2 is to
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    assert int(to["count"]) == int(jo["count"]) == 3
    for k in p:
        got = tp[k].float().numpy()
        want = np.asarray(jnp.asarray(jp[k], jnp.float32))
        if dt[k] == "bfloat16":
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        js, ts = jo["state"][k], to["state"][k]
        np.testing.assert_allclose(ts["m"].numpy(), np.asarray(js["m"]),
                                   rtol=1e-5, atol=1e-7)
        if quantized:
            np.testing.assert_array_equal(ts["v"]["q"].numpy(),
                                          np.asarray(js["v"]["q"]))
        else:
            np.testing.assert_allclose(ts["v"].numpy(), np.asarray(js["v"]),
                                       rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("quantized", [False, True])
def test_adamw_update_routes_f32_state_to_the_multi_tensor_pass(
        quantized, monkeypatch):
    """Every leaf with f32 m and v goes through ``kernels.adamw.adamw``
    in one call; the int8 second moment keeps its eager chain."""
    calls = []
    real = kadamw.adamw

    def spy(ps, *a, **kw):
        calls.append(len(ps))
        return real(ps, *a, **kw)

    monkeypatch.setattr(kadamw, "adamw", spy)
    p, grads, dt = _opt_case(2, ("float32",))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    cfg = AdamWConfig(quantized=quantized, block=64)
    opt = adamw_init(tp, cfg)
    adamw_update(tp, {k: torch.from_numpy(v) for k, v in grads[0].items()},
                 opt, cfg)
    assert calls == [0 if quantized else len(p)]


@pytest.mark.parametrize("grad_clip", [0.0, 1.0])
def test_multi_tensor_plain_is_the_eager_chain(grad_clip):
    """On the CPU ``adamw`` is ``adamw_chain`` leaf by leaf, bit for bit,
    with ``scale`` None as a clip factor of 1."""
    p, grads, dt = _opt_case(3, ("bfloat16", "float32"))
    ps = [torch.from_numpy(v).to(getattr(torch, dt[k])) for k, v in p.items()]
    gs = [torch.from_numpy(grads[0][k]).to(getattr(torch, dt[k]))
          for k in p]
    ms = [torch.randn(t.shape, generator=torch.Generator().manual_seed(i))
          for i, t in enumerate(ps)]
    vs = [m * m for m in ms]
    lr, c1, c2 = (torch.tensor(x) for x in (1e-3, 0.1, 0.05))
    scale = torch.tensor(0.5) if grad_clip else None
    consts = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    want = [kadamw.adamw_chain(p_, g, m, v, lr,
                               1.0 if scale is None else scale, c1, c2,
                               **consts)
            for p_, g, m, v in zip(ps, gs, ms, vs)]
    kadamw.adamw(ps, gs, ms, vs, lr, scale, c1, c2, **consts)
    for (pn, mn, vn), p_, m, v in zip(want, ps, ms, vs):
        assert torch.equal(p_, pn.to(p_.dtype))
        assert torch.equal(m, mn) and torch.equal(v, vn)


@pytest.mark.parametrize("numels,want", [
    ([576], ([0], 1)),
    ([1, 4096, 4097, 0, 65024 * 4096], ([0, 1, 2, 4, 4], 65028)),
    ([0], ([0], 0)),
])
def test_tile_starts_cover_every_element_once(numels, want):
    assert kadamw.tile_starts(numels, 4096) == want


def test_cpu_program_step_is_the_eager_step():
    prog, step = _smoke_step()
    params = prog.init_params(0, device="cpu", phase="train")
    other = _copy(params)
    opt, other_opt = step.init_opt(params), step.init_opt(other)
    for i in range(2):
        batch = _batch(prog.model.cfg.vocab, 2, 16, 10 + i)
        _, _, m = step.fn(params, opt, batch, i)
        _, _, m2 = step.fn.eager(other, other_opt, batch, i)
        _same_bits(m, m2)
    _same_bits(params, other)
    _same_bits(opt, other_opt)
    assert step.fn.stats == {"graph_captures": 0, "capture_s": 0.0,
                             "graph_replays": 0, "graph_nbytes": 0}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the graphed step and the AdamW "
                    "kernel run only on the card")
    return torch.device("cuda")


def _cut_step(B=2, S=512, remat_policy="full", quantized=False,
              compress_grads=False):
    cfg = dataclasses.replace(get_config("smollm-135m"), n_layers=2)
    prog = tcompile(cfg)
    tcfg = TrainStepConfig(
        optimizer=AdamWConfig(lr=1e-3, quantized=quantized), warmup=2,
        total_steps=20, remat_policy=remat_policy,
        compress_grads=compress_grads)
    return prog, prog.train_step(B, S, cfg=tcfg)


@pytest.mark.cuda
@pytest.mark.parametrize("remat_policy,quantized", [
    ("full", False), ("dots", False), ("full", True)])
def test_graphed_step_equals_eager_bitwise(cuda, remat_policy, quantized):
    """smollm-135m cut to 2 layers at B=2 S=512: three replays of the
    graph against three eager steps from the same copies; under the
    selective remat policy (its context_fn under capture) and with the
    int8 second moment (its eager chain inside the graph) too."""
    _graph_against_eager(cuda, remat_policy=remat_policy,
                         quantized=quantized)


@pytest.mark.cuda
def test_graphed_step_with_compressed_grads_equals_eager_bitwise(cuda):
    """``compress_grads``: the error-feedback residuals are written into
    the state's tensors, so one graph replays on and each replay reads
    the residuals the step before wrote."""
    _graph_against_eager(cuda, compress_grads=True)


@pytest.mark.cuda
def test_graphed_step_refuses_a_state_it_would_rebind(cuda):
    """A ``compress_grads`` state without residuals (not made by
    ``init_opt``): the step adds them, which a graph cannot replay."""
    prog, step = _cut_step(B=1, S=256, compress_grads=True)
    params = prog.init_params(0, phase="train")
    opt = adamw_init(params, step.fn.cfg.optimizer)
    batch = _batch(prog.model.cfg.vocab, 1, 256, 1, cuda)
    with pytest.raises(ValueError, match="rebound"):
        step.fn(params, opt, batch, 0)


def _graph_against_eager(cuda, **kw):
    prog, step = _cut_step(**kw)
    quantized = kw.get("quantized", False)
    params = prog.init_params(0, phase="train")
    opt = step.init_opt(params)
    batch = _batch(prog.model.cfg.vocab, 2, 512, 5, cuda)
    step.fn(params, opt, batch, 0)              # the first call captures
    assert step.fn.stats["graph_captures"] == 1
    ep, eo = _copy(params), _copy(opt)
    for i in range(1, 4):
        b = _batch(prog.model.cfg.vocab, 2, 512, 5 + i, cuda)
        before = LAUNCHES["adamw"]
        _, _, m = step.fn(params, opt, b, i)
        m = {k: v.clone() for k, v in m.items()}
        assert LAUNCHES["adamw"] == before + (0 if quantized else 1)
        _, _, em = step.fn.eager(ep, eo, b, i)
        torch.cuda.synchronize()
        _same_bits(m, em)
        _same_bits(params, ep)
        _same_bits(opt, eo)
    assert step.fn.stats["graph_captures"] == 1
    assert step.fn.stats["graph_replays"] == 3


@pytest.mark.cuda
def test_one_capture_per_set_of_storages_and_none_after_a_restore(
        cuda, tmp_path):
    prog, step = _cut_step(B=1, S=256)
    batch = _batch(prog.model.cfg.vocab, 1, 256, 1, cuda)
    a = prog.init_params(0, phase="train")
    b = _copy(a)
    oa, ob = step.init_opt(a), step.init_opt(b)
    for i in range(2):
        step.fn(a, oa, batch, i)
    assert step.fn.stats["graph_captures"] == 1
    step.fn(b, ob, batch, 0)
    assert step.fn.stats["graph_captures"] == 2
    step.fn(a, oa, batch, 2)
    assert step.fn.stats["graph_captures"] == 2

    class Repeat:
        def __init__(self):
            self.step = 0

        def seek(self, s):
            self.step = s

        def state_dict(self):
            return {"step": self.step}

        def load_state_dict(self, st):
            self.step = int(st["step"])

        def __iter__(self):
            return self

        def __next__(self):
            self.step += 1
            return batch

    # the checkpoint after step 1 is restored when step 3 crashes
    sim = FailureSimulator(crash_steps=(3,))
    before = step.fn.stats["graph_captures"]
    _, _, hist = train_loop(step.fn, b, ob, Repeat(),
                            TrainLoopConfig(steps=6, ckpt_dir=str(tmp_path),
                                            ckpt_every=2, log_every=100),
                            failure_sim=sim)
    assert sim.injected == [("crash", 3)]
    assert [h["step"] for h in hist] == [0, 1, 2, 2, 3, 4, 5]
    assert hist[3]["loss"] == hist[2]["loss"]
    assert step.fn.stats["graph_captures"] == before


ODD_SIZES = [(1,), (577,), (4097, 3), (65024, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("grad_clip", [0.0, 1.0])
@pytest.mark.parametrize("count", [1, 1000])
def test_adamw_kernel_matches_plain_bitwise(cuda, count, grad_clip):
    """Odd sizes, bf16 and f32 params and grads mixed, a misaligned leaf
    (a view one element in), a transposed grad, one launch for every
    leaf."""
    gen = torch.Generator(device=cuda).manual_seed(count)
    dtypes = [torch.bfloat16, torch.float32]
    ps, gs = [], []
    for i, shape in enumerate(ODD_SIZES + [(1000,)]):
        dt = dtypes[i % 2]
        ps.append(torch.randn(shape, generator=gen, device=cuda).to(dt))
        gs.append((torch.randn(shape, generator=gen, device=cuda)
                   * 1e-2).to(dtypes[(i // 2) % 2]))
    base = torch.randn(1001, generator=gen, device=cuda)
    ps[-1] = base[1:]                       # 4 bytes past an aligned base
    # a grad in another layout (autograd hands some over transposed)
    gs[2] = gs[2].t().contiguous().t()
    ms = [torch.randn(p.shape, generator=gen, device=cuda) * 1e-3
          for p in ps]
    vs = [torch.rand(p.shape, generator=gen, device=cuda) * 1e-5
          for p in ps]
    cf = torch.tensor(float(count), device=cuda)
    c1 = 1.0 - torch.pow(torch.full((), 0.9, device=cuda), cf)
    c2 = 1.0 - torch.pow(torch.full((), 0.95, device=cuda), cf)
    lr = torch.full((), 3e-4, device=cuda)
    scale = torch.full((), 0.37, device=cuda) if grad_clip else None
    consts = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    want = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
    kadamw.adamw_plain(*want[:1], gs, *want[1:], lr, scale, c1, c2,
                       **consts)
    before = LAUNCHES["adamw"]
    kadamw.adamw(ps, gs, ms, vs, lr, scale, c1, c2, **consts)
    torch.cuda.synchronize()
    assert LAUNCHES["adamw"] == before + 1
    for got, ref in zip(ps + ms + vs, want[0] + want[1] + want[2]):
        assert torch.equal(got, ref)


def _moe_cut(remat=True):
    """deepseek-moe-16b's family at widths the kernels take (d_model 256,
    2 heads of 128, 8 experts of width 128 top-2 and a shared one): the
    dense first layer and a stack of 2 MoE layers, which remat
    recomputes layer by layer; B=2 S=1024 resolves ``dynamic`` to DBO."""
    cfg = get_config("deepseek-moe-16b")
    cfg = dataclasses.replace(
        cfg, n_layers=3, d_model=256, n_heads=2, n_kv=2, d_ff=512,
        vocab=1024, moe=dataclasses.replace(
            cfg.moe, n_experts=8, top_k=2, d_ff_expert=128, n_shared=1))
    prog = tcompile(cfg, policy="dynamic")
    tcfg = TrainStepConfig(optimizer=AdamWConfig(lr=1e-3), warmup=2,
                           total_steps=20, remat=remat)
    step = prog.train_step(2, 1024, cfg=tcfg)
    assert step.strategies["layers"] == "dbo"
    return prog, step


@pytest.mark.cuda
def test_moe_graphed_step_equals_eager_bitwise(cuda):
    prog, step = _moe_cut()
    params = prog.init_params(0, phase="train")
    opt = step.init_opt(params)
    vocab = prog.model.cfg.vocab
    step.fn(params, opt, _batch(vocab, 2, 1024, 5, cuda), 0)
    ep, eo = _copy(params), _copy(opt)
    counts = dict(LAUNCHES)
    for i in range(1, 4):
        b = _batch(vocab, 2, 1024, 5 + i, cuda)
        _, _, m = step.fn(params, opt, b, i)
        m = {k: v.clone() for k, v in m.items()}
        _, _, em = step.fn.eager(ep, eo, b, i)
        torch.cuda.synchronize()
        _same_bits(m, em)
        _same_bits(params, ep)
        _same_bits(opt, eo)
    assert step.fn.stats["graph_captures"] == 1
    for name in ("grouped_ffn", "grouped_ffn_gate_bwd"):
        assert LAUNCHES[name] > counts.get(name, 0), name


@pytest.mark.cuda
def test_moe_remat_gradients_equal_kept_activations_bitwise(cuda):
    prog, step = _moe_cut(remat=True)
    _, kept = _moe_cut(remat=False)
    params = prog.init_params(0, phase="train")
    batch = _batch(prog.model.cfg.vocab, 2, 1024, 9, cuda)
    for _ in range(2):
        got = step.fn.grads(params, batch)
        want = kept.fn.grads(params, batch)
        torch.cuda.synchronize()
        _same_bits(got[0], want[0])
        assert torch.equal(got[1][0], want[1][0])
