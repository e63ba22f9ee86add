"""The port's VLM family (src/repro_torch/models/vlm.py) and M-RoPE
(``layers.rope_mrope``, ``LMBase.batch_inputs``) against the JAX
package, on smoke qwen2-vl-7b and on M-RoPE at the published sections.

The inputs follow Qwen2-VL's layout: the first positions are image
patches on a (t, h, w) grid, whose three position streams are the
patch's coordinates and whose ``vis`` rows are random; the text after
them continues from the grid's largest position + 1 with the three
streams equal, and ``vis`` zero there.  Params, reference runs and
tolerances as in tests/test_torch_encdec.py.  M-RoPE's positions are
``(3, B, S)`` with the batch at dim 1, so a micro-batch split reads them
through a view along dim 1 that is not contiguous.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models.layers import rope_full as jrope_full
from repro.models.layers import rope_mrope as jrope_mrope
from repro_torch.api import compile as tcompile
from repro_torch.convert import params_from_numpy
from repro_torch.core import FULL, Realizer
from repro_torch.core.strategies.nanoflow import NanoFlow
from repro_torch.models.layers import rope_full, rope_mrope
from test_torch_encdec import (bf16_both, check_step, close, np32, reference,
                               run_jax, train_both)

ARCH = "qwen2-vl-7b"


def mrope_positions(B, S, grid):
    """(3, B, S) int32: a (t, h, w) grid of image patches, then text whose
    three streams continue equal from the grid's largest position + 1."""
    t, h, w = grid
    n = t * h * w
    img = np.stack([a.ravel() for a in np.meshgrid(
        np.arange(t), np.arange(h), np.arange(w), indexing="ij")])
    start = int(img.max()) + 1
    txt = np.broadcast_to(np.arange(start, start + S - n), (3, S - n))
    pos = np.concatenate([img, txt], 1).astype(np.int32)
    return np.broadcast_to(pos[:, None, :], (3, B, S)).copy()


def vlm_batch(B, S, cfg, grid, seed):
    """(jax batch, port batch) of a prefill: ids, M-RoPE positions and
    ``vis`` random on the grid's patches, zero on the text."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(grid))
    vis = np.zeros((B, S, cfg.d_model), np.float32)
    vis[:, :n] = rng.standard_normal((B, n, cfg.d_model))
    jv, tv = bf16_both(vis)
    ids = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    pos = mrope_positions(B, S, grid)
    return ({"ids": jnp.array(ids), "positions": jnp.array(pos), "vis": jv},
            {"ids": torch.from_numpy(ids), "positions": torch.from_numpy(pos),
             "vis": tv})


@pytest.mark.parametrize("sections,hd", [((16, 24, 24), 128),
                                         ((2, 1, 1), 8)])
def test_rope_mrope_matches_reference(sections, hd):
    B, S, H = 2, 40, 3
    rng = np.random.default_rng(0)
    jq, tq = bf16_both(rng.standard_normal((B, S, H, hd)))
    jk, tk = bf16_both(rng.standard_normal((B, S, H, hd)))
    pos = mrope_positions(B, S, (2, 3, 4))
    want = jrope_mrope(jq, jk, jnp.asarray(pos), sections=sections)
    got = rope_mrope(tq, tk, torch.from_numpy(pos), sections=sections)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == (B, S, H, hd)
        close(a, b)
    # the frequencies run over the whole head dim, sliced by section:
    # with the three streams equal, M-RoPE is the full RoPE
    flat = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    same = rope_mrope(tq, tk, torch.from_numpy(
        np.broadcast_to(flat, (3, B, S)).copy()), sections=sections)
    full = rope_full(tq, tk, torch.from_numpy(flat))
    jfull = jrope_full(jq, jk, jnp.asarray(flat))
    for a, b, c in zip(same, full, jfull):
        assert torch.equal(a, b)
        close(a, c)


def test_positions_are_three_streams_with_the_batch_at_dim_1():
    prog = tcompile(ARCH, smoke=True, device="cpu")
    jm, _ = reference(ARCH)
    for phase, S in (("train", 16), ("prefill", 16), ("decode", 1)):
        _, tin = prog.model.build_segments(phase, 4, S, s_max=32)
        _, jin = jm.build_segments(phase, 4, S, s_max=32)
        spec, bd = tin["positions"]
        assert (tuple(spec.shape), bd) == ((3, 4, S), 1)
        assert (tuple(jin["positions"][0].shape), jin["positions"][1]) == \
            ((3, 4, S), 1)
        assert ("vis" in tin) == (phase != "decode") == ("vis" in jin)


@pytest.fixture(scope="module")
def pair():
    jm, jparams = reference(ARCH)
    prog = tcompile(ARCH, policy="sequential", smoke=True, device="cpu")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jm, jparams, prog, tparams


def test_params_carry_across(pair):
    jm, jparams, prog, tparams = pair
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        t = tparams
        for k in path:
            t = t[k.key]
        np.testing.assert_array_equal(np32(t), np32(leaf))
    mine = prog.init_params(0)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, mine)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0,
                                                            jparams))


@pytest.mark.parametrize("B,S,grid", [(2, 16, (1, 2, 4)), (1, 37, (2, 3, 3))])
def test_prefill_logits_and_kv_match(pair, B, S, grid):
    jm, jparams, prog, tparams = pair
    jb, tb = vlm_batch(B, S, jm.cfg, grid, 0)
    want = run_jax(jm, jparams, "prefill", B, S, jb)
    got = prog.prefill(B, S)(tparams, tb)
    for key in ("logits", "layers.k", "layers.v"):
        close(got[key], want[key])
    # the patches reach the logits: zero vis gives others
    zero = dict(tb, vis=torch.zeros_like(tb["vis"]))
    assert float((prog.prefill(B, S)(tparams, zero)["logits"]
                  - got["logits"]).abs().max()) > 1e-2


def test_decode_logits_and_caches_match(pair):
    jm, jparams, prog, tparams = pair
    cfg = jm.cfg
    B, s_max = 3, 24
    rng = np.random.default_rng(1)
    clen = np.asarray([0, 5, 23], np.int32)
    shape = (cfg.n_layers, B, s_max, cfg.n_kv, cfg.hd)
    kc, kt = bf16_both(rng.standard_normal(shape) * 0.5)
    vc, vt = bf16_both(rng.standard_normal(shape) * 0.5)
    ids = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    # a text token after a 4-patch grid: its three streams are equal
    pos = np.broadcast_to((clen + 2)[None, :, None], (3, B, 1)).copy()
    jb = {"ids": jnp.array(ids), "positions": jnp.array(pos),
          "cache_len": jnp.array(clen), "k_cache": kc, "v_cache": vc}
    tb = {"ids": torch.from_numpy(ids), "positions": torch.from_numpy(pos),
          "cache_len": torch.from_numpy(clen), "k_cache": kt, "v_cache": vt}
    want = run_jax(jm, jparams, "decode", B, s_max, jb, s_max=s_max)
    got = prog.decode_tiers(B, s_max, tiers=(B,))[B](tparams, tb)
    for key in ("logits", "k_cache", "v_cache"):
        close(got[key], want[key])
    assert got["k_cache"].data_ptr() == kt.data_ptr()


def test_train_step_matches_reference():
    cfg = jget_smoke(ARCH)
    B, S = 2, 16
    jb, tb = vlm_batch(B, S, cfg, (1, 2, 4), 11)
    rng = np.random.default_rng(12)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[:, -3:] = -100
    batch = {"ids": np.asarray(tb["ids"]), "labels": labels,
             "positions": np.asarray(tb["positions"]),
             "vis": (jb["vis"], tb["vis"])}
    jmet, tmet, jp0, jp, tp, _ = train_both(ARCH, batch)
    check_step(jmet, tmet, jp0, jp, tp)


@pytest.mark.parametrize("n_split", [2, 4])
def test_split_positions_equal_sequential_and_are_views(pair, n_split):
    """NanoFlow splits the (3, B, S) positions along dim 1 (DBO splits
    only MoE layers, in both packages): the logits and K/V equal the
    sequential plan's, and each micro-batch's read of the positions is a
    view of the full tensor (not contiguous, the batch being dim 1)."""
    jm, jparams, prog, tparams = pair
    B, S = 4, 1024
    _, tb = vlm_batch(B, S, jm.cfg, (1, 16, 32), 2)
    want = prog.prefill(B, S)(tparams, tb)
    policy = "nanoflow" if n_split == 2 else NanoFlow(min_tokens=1,
                                                      n_split=n_split)
    step = tcompile(ARCH, policy=policy, smoke=True,
                    device="cpu").prefill(B, S)
    rz = step.fn.realizers["layers"]
    mb = B // n_split
    assert isinstance(rz, Realizer) and rz.plan.split_sizes == (mb,) * n_split
    got = step(tparams, tb)
    for key in ("logits", "layers.k", "layers.v"):
        a, b = got[key].float(), want[key].float()
        assert float((a - b).norm() / b.norm()) < 1e-2, key
    pos_t = rz.graph.inputs["positions"]
    full = tb["positions"]
    reads = [p for rs in rz.analysis.reads for (t, p, m, _k) in rs
             if t == pos_t and m == "slice"]
    assert sorted(set(reads)) == list(range(n_split))
    for part in range(n_split):
        view = rz._read({(pos_t, FULL): full}, pos_t, part, "slice", FULL)
        assert view.shape == (3, mb, S) and not view.is_contiguous()
        assert view.untyped_storage().data_ptr() == \
            full.untyped_storage().data_ptr()
        assert torch.equal(view, full[:, mb * part:mb * (part + 1)])
