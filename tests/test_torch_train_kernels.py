"""The backward kernels' plain versions (src/repro_torch/kernels) against
the JAX package, and the autograd Functions that carry them.

On the CPU every backward wrapper takes its plain version:

  * ``flash_attention_bwd_plain`` against torch.autograd of
    ``flash_attention_plain`` and against the reference's
    ``_sdpa_chunked_bwd`` (``jax.vjp`` of ``_sdpa_chunked`` over K/V read
    through the GQA slot map, so the VJP of the gather sums dK and dV over
    each K/V head's q heads);
  * ``fused_add_rmsnorm_bwd_plain`` against ``repro.kernels.ops._farn_bwd``;
  * ``rmsnorm_bwd_plain`` against ``jax.vjp`` of the reference's
    ``RMSNormOp.kernel``;
  * each autograd Function (``FlashAttention``, ``RMSNorm``,
    ``FusedAddRMSNorm``) against torch.autograd of its plain forward
    (``GroupedFFN``'s in tests/test_torch_moe_train.py, ``SSDScan``'s and
    ``ssd_scan_bwd_plain``'s in tests/test_torch_ssm_train.py, which
    share this file's ``ssd_inputs``).

Tolerances: in f32, 1e-4 relative (sums over up to 128 keys or 128
columns in another order; JAX's vjp of the plain norm multiplies dh by g
before the f32 chain, as the port does); in bf16, 3e-2 (tests/
test_kernels.py's bf16 tolerance: the two frameworks round bf16 at other
places — JAX's autodiff rounds dh * g and the attention probabilities to
bf16, the port's plain versions keep f32 to the output), atol scaled by
the reference's largest magnitude.

The geometry cases hold the backward kernels' work splits
(``flash_bwd_geometry``, ``flash_bwd_heads``, ``norm_bwd_geometry``,
``ssd_bwd_geometry``, ``ssd_bwd_heads``, ``ssd_bwd_workspace_words``),
pure functions of the shapes, on the CPU.  The ``cuda``-marked cases
hold the kernels to their plain versions on the card (skipped here);
the JAX package is imported only by the cases that compare with it, so
those run on a machine without it too.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd_scan as ssd

F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=3e-2, rtol=3e-2)


def tol(dtype):
    return BF16 if dtype == "bfloat16" else F32


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    import jax.numpy as jnp
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want, dtype="float32"):
    want = np32(want)
    t = tol(dtype)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np32(got), want, atol=t["atol"] * scale,
                               rtol=t["rtol"])


def arrays(seed, dtype, *shapes):
    """Seeded numpy values as torch tensors of ``dtype``."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        a = rng.standard_normal(shape).astype(np.float32)
        out.append(torch.from_numpy(a).to(getattr(torch, dtype)))
    return out


def to_jax(t):
    import jax.numpy as jnp
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


# (B, S, H, Hk, hd): GQA and not, hd 64 and 128
ATTN = [(2, 32, 4, 2, 64), (1, 48, 3, 3, 64), (2, 32, 4, 1, 128),
        (1, 40, 2, 2, 128)]


def attn_inputs(seed, dtype, B, S, H, Hk, hd):
    q, k, v, do = arrays(seed, dtype, (B, S, H, hd), (B, S, Hk, hd),
                         (B, S, Hk, hd), (B, S, H, hd))
    kvh = (torch.arange(H) // (H // Hk)).to(torch.int32)
    return q, k, v, do, kvh


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Hk,hd", ATTN)
def test_flash_bwd_plain_matches_autograd(B, S, H, Hk, hd, causal):
    q, k, v, do, kvh = attn_inputs(0, "float32", B, S, H, Hk, hd)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o = fa.flash_attention_plain(q, k, v, causal=causal, kv_head=kvh)
    want = torch.autograd.grad(o, (q, k, v), do)
    lse = fa.flash_attention_lse_plain(q, k, causal, kvh)
    got = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                       kv_head=kvh)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        close(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Hk,hd", ATTN)
def test_flash_bwd_plain_matches_reference(B, S, H, Hk, hd, causal, dtype):
    """Against ``jax.vjp`` of the reference's ``_sdpa_chunked`` (its
    custom VJP is ``_sdpa_chunked_bwd``), in chunks of 16 q rows."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models.layers import _sdpa_chunked
    q, k, v, do, kvh = attn_inputs(1, dtype, B, S, H, Hk, hd)
    slot = jnp.asarray(kvh.numpy())

    def f(q_, k_, v_):
        return _sdpa_chunked(q_, jnp.take(k_, slot, axis=2),
                             jnp.take(v_, slot, axis=2), causal, 16)

    # f32 products in full f32 wherever JAX runs (a GPU's default is TF32)
    with jax.default_matmul_precision("highest"):
        o_j, vjp = jax.vjp(f, to_jax(q), to_jax(k), to_jax(v))
        want = vjp(to_jax(do))
    o = fa.flash_attention_plain(q, k, v, causal=causal, kv_head=kvh)
    lse = fa.flash_attention_lse_plain(q, k, causal, kvh)
    got = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                       kv_head=kvh)
    close(o, o_j, dtype)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        close(a, b, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(7, 64), (33, 256)])
def test_fused_bwd_plain_matches_farn_bwd(n, d, dtype):
    pytest.importorskip("jax")
    from repro.kernels.ops import _farn_bwd
    x, y, g, dh, ds_out = arrays(2, dtype, (n, d), (n, d), (d,), (n, d),
                                 (n, d))
    s, _ = rn.fused_add_rmsnorm_plain(x, y, g)
    want = _farn_bwd(256, (to_jax(s), to_jax(g)), (to_jax(ds_out),
                                                   to_jax(dh)))
    got = rn.fused_add_rmsnorm_bwd_plain(s, g, dh, ds_out)
    assert got[0] is got[1]
    for a, b in zip(got, want):
        assert a.dtype == s.dtype or a.dtype == g.dtype
        close(a, b, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(7, 64), (33, 256)])
def test_rmsnorm_bwd_plain_matches_reference_vjp(n, d, dtype):
    jax = pytest.importorskip("jax")
    from repro.models.layers import RMSNormOp
    op = RMSNormOp(d)
    x, g, dh = arrays(3, dtype, (n, d), (d,), (n, d))
    _, vjp = jax.vjp(lambda x_, g_: op.kernel({"g": g_}, x_), to_jax(x),
                     to_jax(g))
    want = vjp(to_jax(dh))
    got = rn.rmsnorm_bwd_plain(x, g, dh)
    for a, b in zip(got, want):
        assert a.dtype == x.dtype
        close(a, b, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_matches_autograd_of_plain(causal, dtype):
    B, S, H, Hk, hd = 2, 24, 4, 2, 64
    q, k, v, do, kvh = attn_inputs(4, dtype, B, S, H, Hk, hd)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want_o = fa.flash_attention_plain(*leaves, causal=causal, kv_head=kvh)
    want = torch.autograd.grad(want_o, leaves, do)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fa.flash_attention(*leaves, causal=causal, kv_head=kvh)
    assert o.grad_fn is not None and "FlashAttention" in type(
        o.grad_fn).__name__
    got = torch.autograd.grad(o, leaves, do)
    close(o, want_o, dtype)
    for a, b in zip(got, want):
        close(a, b, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_functions_match_autograd_of_plain(dtype):
    n, d = 9, 128
    x, y, g, dh, ds_out = arrays(5, dtype, (n, d), (n, d), (d,), (n, d),
                                 (n, d))
    # rmsnorm: dg of the Function sums dh * round(x r), as JAX's autodiff
    # does; autograd of the plain forward differentiates the same rounding
    lv = [t.clone().requires_grad_() for t in (x, g)]
    want = torch.autograd.grad(rn.rmsnorm_plain(*lv), lv, dh)
    lv = [t.clone().requires_grad_() for t in (x, g)]
    h = rn.rmsnorm(*lv)
    assert "RMSNorm" in type(h.grad_fn).__name__
    for a, b in zip(torch.autograd.grad(h, lv, dh), want):
        close(a, b, dtype)
    # fused: both outputs' cotangents, and one of them alone
    for cts in ((ds_out, dh), (None, dh), (ds_out, None)):
        lv = [t.clone().requires_grad_() for t in (x, y, g)]
        outs = rn.fused_add_rmsnorm_plain(*lv)
        pairs = [(o, c) for o, c in zip(outs, cts) if c is not None]
        want = torch.autograd.grad([o for o, _ in pairs], lv,
                                   [c for _, c in pairs], allow_unused=True)
        want = [torch.zeros_like(t) if w is None else w
                for t, w in zip(lv, want)]
        lv = [t.clone().requires_grad_() for t in (x, y, g)]
        outs = rn.fused_add_rmsnorm(*lv)
        assert "FusedAddRMSNorm" in type(outs[0].grad_fn).__name__
        pairs = [(o, c) for o, c in zip(outs, cts) if c is not None]
        got = torch.autograd.grad([o for o, _ in pairs], lv,
                                  [c for _, c in pairs])
        # the fused backward works from the rounded residual s (bf16),
        # autograd of the plain forward from its f32 sum
        for a, b in zip(got, want):
            close(a, b, dtype)


def test_no_gradient_no_function_and_no_lse():
    """Without a gradient to record (the serve path) the wrappers run the
    forward alone."""
    q, k, v, _, kvh = attn_inputs(6, "bfloat16", 1, 16, 2, 1, 64)
    assert fa.flash_attention(q, k, v, kv_head=kvh).grad_fn is None
    x, g = arrays(7, "bfloat16", (4, 64), (64,))
    assert rn.rmsnorm(x, g).grad_fn is None
    with torch.no_grad():
        qq = q.clone().requires_grad_()
        assert fa.flash_attention(qq, k, v, kv_head=kvh).grad_fn is None


# ---------------------------------------------------------------------------
# the backward kernels' geometry: pure functions of the shapes
# ---------------------------------------------------------------------------

H100_SMS = 132


def _maps(H, Hk):
    """kv_head maps of H q heads onto Hk K/V heads: contiguous groups,
    interleaved, and uneven (every head of the last half on one K/V head)."""
    maps = [[h // (H // Hk) for h in range(H)] if H % Hk == 0 else None,
            [h % Hk for h in range(H)],
            [min(h, Hk - 1) if h < H // 2 else Hk - 1 for h in range(H)]]
    return [m for m in maps if m is not None]


@pytest.mark.parametrize("B,H,Hk,S,hd", [
    (8, 9, 3, 2048, 64), (2, 32, 2, 2048, 128), (1, 32, 2, 300, 128),
    (1, 6, 2, 200, 64), (2, 4, 4, 48, 64), (1, 7, 3, 1000, 128),
    (3, 16, 1, 129, 64)])
def test_flash_bwd_geometry_puts_every_head_in_one_unit(B, H, Hk, S, hd):
    """Whatever the map, the dK/dV units of a K/V head take each of its q
    heads exactly once, in head order, and no other head."""
    geo = fa.flash_bwd_geometry(B, H, Hk, S, S, hd, H100_SMS)
    splits = geo["splits"]
    assert geo["dkdv_units"] == B * Hk * -(-S // 128) * splits
    for kv_head in _maps(H, Hk):
        heads = fa.flash_bwd_heads(kv_head, Hk, splits)
        assert sorted(heads) == [(k, s) for k in range(Hk)
                                 for s in range(splits)]
        for kvh in range(Hk):
            walked = [h for s in range(splits) for h in heads[kvh, s]]
            assert walked == [h for h in range(H) if kv_head[h] == kvh]


def test_flash_bwd_geometry_splits_only_where_the_card_is_not_full():
    """smollm-135m's train shape (B=8, 9/3 heads, S=2048) has 384 dK/dV
    units: no split, bf16 written directly, no workspace; chatglm3-6b's
    (B=2, 32/2 heads) has 64, so each K/V head's 16 q heads go to 4 units
    of 4: 256 units, at least one an SM."""
    sm = fa.flash_bwd_geometry(8, 9, 3, 2048, 2048, 64, H100_SMS)
    assert (sm["splits"], sm["dkdv_units"], sm["workspace"]) == (1, 384, None)
    assert sm["step_rows"] == 128 and sm["dq_units"] == 8 * 9 * 16
    glm = fa.flash_bwd_geometry(2, 32, 2, 2048, 2048, 128, H100_SMS)
    assert glm["splits"] == 4 and glm["dkdv_units"] == 256 >= H100_SMS
    assert glm["step_rows"] == 64
    heads = fa.flash_bwd_heads([h // 16 for h in range(32)], 2, 4)
    assert heads[1, 2] == [24, 25, 26, 27]


@pytest.mark.parametrize("B,H,Hk,Sq,Sk,hd,sms", [
    (2, 32, 2, 2048, 2048, 128, 132), (1, 32, 2, 300, 300, 128, 132),
    (8, 9, 3, 2048, 2048, 64, 132), (1, 8, 1, 100, 260, 64, 16),
    (4, 32, 8, 513, 513, 128, 132), (1, 3, 3, 1, 7, 64, 132)])
def test_flash_bwd_workspace_follows_the_split(B, H, Hk, Sq, Sk, hd, sms):
    """The split doubles while the units are fewer than the SMs, up to the
    heads of a K/V head; the f32 workspace holds dK and dV of every split
    where there is more than one; the delta pass's rows pad Sq to 128."""
    geo = fa.flash_bwd_geometry(B, H, Hk, Sq, Sk, hd, sms)
    base, s = B * Hk * -(-Sk // 128), geo["splits"]
    assert s & (s - 1) == 0 and 1 <= s <= max(1, H // Hk)
    assert base * s >= sms or s * 2 > H // Hk
    assert s == 1 or base * (s // 2) < sms
    assert geo["workspace"] == (None if s == 1
                                else (2, s, B, Sk, Hk, hd))
    assert geo["sq_pad"] % 128 == 0 and 0 <= geo["sq_pad"] - Sq < 128
    assert geo["aux"] == (2, B, H, geo["sq_pad"])
    assert geo["dq_units"] == B * H * geo["sq_pad"] // 128


@pytest.mark.parametrize("n", [1, 333, 16384])
def test_norm_bwd_geometry_covers_every_width(n):
    """Every width the backward takes, 8 to 8192 in steps of 8: a row on
    1, 4 or 8 warps whose lanes hold at most 4 packs, the fewest that
    cover it; whole rows in a block; 4 blocks an SM at one warp a row of
    up to 2 packs, 3 at 3 or 4 packs, 2 from 4 warps a row, 1 of 8."""
    for d in range(8, 8193, 8):
        geo = rn.norm_bwd_geometry(n, d, H100_SMS)
        w, p = geo["warps_per_row"], geo["packs"]
        assert w == (1 if d <= 1024 else 4 if d <= 4096 else 8)
        assert 1 <= p <= 4 and 256 * w * p >= d
        assert p == 1 or 256 * w * (p - 1) < d
        assert geo["threads"] == (256 if w == 8 else 128)
        assert geo["rows_at_once"] * w * 32 == geo["threads"]
        per_sm = {8: 1, 4: 2}.get(w, 3 if p >= 3 else 4)
        assert geo["blocks_per_sm"] == per_sm
        assert geo["blocks"] == min(H100_SMS * per_sm,
                                    -(-n // geo["rows_at_once"]))


@pytest.mark.parametrize("n,d,blocks", [(16384, 576, 396),
                                        (4096, 4096, 264), (2, 576, 1),
                                        (40, 2048, 40), (9, 8192, 9),
                                        (16384, 512, 528)])
def test_norm_bwd_geometry_at_the_train_shapes(n, d, blocks):
    """smollm-135m's train step (16384 x 576: a warp a row of 3 packs)
    fills 3 blocks an SM, chatglm3-6b's width (4 warps of 4 packs) 2;
    short runs take a block a row (4 rows a block at one warp a row)."""
    assert rn.norm_bwd_geometry(n, d, H100_SMS)["blocks"] == blocks


@pytest.mark.parametrize("d", [0, 4, 44, 8200, 16384])
def test_norm_bwd_geometry_refuses_widths_the_kernel_does_not_take(d):
    with pytest.raises(ValueError):
        rn.norm_bwd_geometry(64, d, H100_SMS)


# (b, L, H, G, N, chunk): mamba2-2.7b's and zamba2-1.2b's train
# micro-batches (Q = 128), then odd shapes: L not a multiple of the chunk
# (Q = 32; Q = 4), L below it (Q = 37), G = 2 and 3, b = 3
SSD_TRAIN = [(1, 2048, 80, 1, 128, 128), (1, 2048, 64, 1, 64, 128)]
SSD_ODD = [(3, 96, 4, 2, 128, 64), (2, 37, 4, 1, 64, 128),
           (1, 300, 2, 2, 128, 128), (2, 256, 6, 3, 64, 128)]
# shapes whose head sets differ in size (5 heads a group in sets of 2 and
# 3 on a 16-SM card) and whose chunk is no multiple of 16 (Q = 50, N = 64),
# with the SM count the geometry is given (None: the card's)
SSD_SETS = [(1, 512, 10, 2, 128, 128), (2, 100, 6, 1, 64, 50)]
SSD_SMS = {(1, 512, 10, 2, 128, 128): 16}


def _ssd_units(b, L, H, G, N, chunk, sms):
    """The (batch row, chunk, heads) of each unit of the backward's states
    and chunk passes, in block order as the kernels decode it: head sets
    fastest, then groups, chunks, batch rows."""
    Q = ssd.chunk_len(L, chunk)
    geo = ssd.ssd_bwd_geometry(b, L, H, G, N, Q, sms)
    sets, nc = geo["sets"], L // Q
    heads = ssd.ssd_bwd_heads(H, G, sets)
    units = []
    for u in range(geo["units"]):
        k, rest = u % sets, u // sets
        grp, rest = rest % G, rest // G
        units.append((rest // nc, rest % nc, heads[grp, k]))
    return geo, units


@pytest.mark.parametrize("sms", [H100_SMS, 16, 3])
@pytest.mark.parametrize("b,L,H,G,N,chunk", SSD_TRAIN + SSD_ODD + SSD_SETS)
def test_ssd_bwd_geometry_puts_every_head_in_one_unit(b, L, H, G, N, chunk,
                                                      sms):
    """Of each chunk, every head of a group lands in exactly one unit, in
    head order, beside only heads of its own group; the units cover every
    (chain, chunk) once."""
    geo, units = _ssd_units(b, L, H, G, N, chunk, sms)
    R, sets = H // G, geo["sets"]
    assert 1 <= sets <= R and geo["heads_per_unit"] == -(-R // sets)
    heads = ssd.ssd_bwd_heads(H, G, sets)
    for grp in range(G):
        walked = [h for k in range(sets) for h in heads[grp, k]]
        assert walked == list(range(grp * R, (grp + 1) * R))
        assert all(heads[grp, k] for k in range(sets))
    seen = [(bi, h, n) for bi, n, hs in units for h in hs]
    nc = L // ssd.chunk_len(L, chunk)
    assert sorted(seen) == [(bi, h, n) for bi in range(b) for h in range(H)
                            for n in range(nc)]
    assert max(len(hs) for _, _, hs in units) == geo["heads_per_unit"]


@pytest.mark.parametrize("b,L,H,G,N,chunk,sets", [
    (1, 2048, 80, 1, 128, 128, 8), (1, 2048, 64, 1, 64, 128, 8)])
def test_ssd_bwd_geometry_fills_the_card_at_the_train_shapes(b, L, H, G, N,
                                                             chunk, sets):
    """mamba2-2.7b's and zamba2-1.2b's NanoFlow halves (1280 and 1024
    head-chunks): 8 sets of 10 and of 8 heads, 128 units in one wave on
    132 SMs, so the busiest SM runs the even share rounded up; a unit of
    fewer or more heads would leave it more."""
    Q = ssd.chunk_len(L, chunk)
    geo = ssd.ssd_bwd_geometry(b, L, H, G, N, Q, H100_SMS)
    share = -(-(b * H * (L // Q)) // H100_SMS)
    assert geo["sets"] == sets and geo["units"] == 128 <= H100_SMS
    assert geo["span"] == geo["heads_per_unit"] == share


def test_ssd_bwd_geometry_takes_whole_groups_where_units_are_few():
    """Where one wave holds every head set, a set is one head (the shortest
    span); on a card of few SMs a unit takes its whole group, and dB and
    dC need no workspace rows."""
    assert ssd.ssd_bwd_geometry(2, 256, 6, 3, 64, 128, H100_SMS)["sets"] == 2
    geo = ssd.ssd_bwd_geometry(1, 512, 8, 1, 128, 128, 4)
    assert geo["sets"] == 1 and geo["heads_per_unit"] == 8
    assert geo["words"] == ssd.ssd_bwd_workspace_words(1, 512, 8, 1, 128,
                                                       128, 1)
    assert geo["words"] == 2 * 8 * 4 * 128 * 64 + 8 * 4 * (3 + 64)


@pytest.mark.parametrize("b,L,H,G,N,Q,nbytes,per_head", [
    (1, 2048, 80, 1, 128, 128, 101_006_336, 251_673_600),
    (1, 2048, 64, 1, 64, 128, 42_086_400, 100_675_584)])
def test_ssd_bwd_workspace_at_the_train_shapes(b, L, H, G, N, Q, nbytes,
                                               per_head):
    """The per-call workspace at mamba2-2.7b's train shape is 101.0 MB: the
    states' slabs (83.9 MB, their bf16 parts written over their f32 terms)
    and dB and dC of 8 head sets (16.8 MB).  A per-head layout (f32 states
    beside per-head dB and dC) takes 251.7 MB; zamba2-1.2b's 42.1 MB
    against 100.7 MB."""
    sets = ssd.ssd_bwd_geometry(b, L, H, G, N, Q, H100_SMS)["sets"]
    words = ssd.ssd_bwd_workspace_words(b, L, H, G, N, Q, sets)
    assert words * 4 == nbytes
    nc = L // Q
    assert 4 * (2 * b * H * nc * N * 64 + 2 * b * L * H * N
                + 3 * b * H * nc) == per_head > nbytes


# ---------------------------------------------------------------------------
# on the card: the kernels against their plain backwards
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the backward kernels run only "
                    "on the card")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Hk,hd", ATTN + [(1, 200, 4, 2, 64),
                                                (2, 130, 2, 1, 128)])
def test_flash_bwd_kernel_matches_plain(cuda, B, S, H, Hk, hd, causal):
    q, k, v, do, kvh = (t.to(cuda) for t in attn_inputs(
        8, "bfloat16", B, S, H, Hk, hd))
    o, lse = fa._flash_fwd(q, k, v, causal, kvh, lse=True)
    want_lse = fa.flash_attention_lse_plain(q, k, causal, kvh)
    assert float((lse - want_lse).abs().max()) < 1e-3
    before = LAUNCHES["flash_attention_bwd"]
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                 kv_head=kvh)
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                        kv_head=kvh)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_bwd"] == before + 1
    # P and dS enter the tensor cores as bf16 (2^-9 relative each)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _rel(a, b) < 2e-2
    # the same bits twice: no atomics
    again = fa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                   kv_head=kvh)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1, 576), (333, 576), (4096, 4096),
                                 (100, 2048)])
def test_norm_bwd_kernels_match_plain(cuda, n, d):
    x, y, g, dh, ds_out = (t.to(cuda) for t in arrays(
        9, "bfloat16", (n, d), (n, d), (d,), (n, d), (n, d)))
    got = rn.rmsnorm_bwd(x, g, dh)
    want = rn.rmsnorm_bwd_plain(x, g, dh)
    for a, b in zip(got, want):
        assert _rel(a, b) < 1e-2
    s, _ = rn.fused_add_rmsnorm_plain(x, y, g)
    got = rn.fused_add_rmsnorm_bwd(s, g, dh, ds_out)
    want = rn.fused_add_rmsnorm_bwd_plain(s, g, dh, ds_out)
    assert got[0] is got[1]
    for a, b in zip(got, want):
        assert _rel(a, b) < 1e-2
    again = rn.fused_add_rmsnorm_bwd(s, g, dh, ds_out)
    assert torch.equal(got[2], again[2])


@pytest.mark.cuda
def test_functions_launch_the_backward_kernels(cuda):
    q, k, v, do, kvh = (t.to(cuda) for t in attn_inputs(
        10, "bfloat16", 2, 128, 4, 2, 64))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    counts = dict(LAUNCHES)
    o = fa.flash_attention(*leaves, causal=True, kv_head=kvh)
    torch.autograd.grad(o, leaves, do)
    x, y, g = (t.to(cuda).requires_grad_() for t in arrays(
        11, "bfloat16", (64, 576), (64, 576), (576,)))
    torch.autograd.grad(rn.rmsnorm(x, g).float().sum(), (x, g))
    s, h = rn.fused_add_rmsnorm(x, y, g)
    torch.autograd.grad((s.float().sum() + h.float().sum()), (x, y, g))
    for name in ("flash_attention", "flash_attention_bwd", "rmsnorm",
                 "rmsnorm_bwd", "fused_add_rmsnorm", "fused_add_rmsnorm_bwd"):
        assert LAUNCHES[name] == counts.get(name, 0) + 1, name
    assert math.isfinite(float(o.float().sum()))


def _flash_case(cuda, seed, B, Sq, Sk, H, Hk, hd, kv_head=None):
    q, do = arrays(seed, "bfloat16", (B, Sq, H, hd), (B, Sq, H, hd))
    k, v = arrays(seed + 1, "bfloat16", (B, Sk, Hk, hd), (B, Sk, Hk, hd))
    if kv_head is None:
        kv_head = [h // (H // Hk) for h in range(H)]
    kvh = torch.tensor(kv_head, dtype=torch.int32)
    return [t.to(cuda) for t in (q, k, v, do, kvh)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Sq,Sk,H,Hk,hd,kv_head", [
    # the split dK/dV pass at a group of 16 (16 units of one head each)
    (1, 300, 300, 32, 2, 128, None),
    # hd 64 at a length no tile divides, a group of 3
    (1, 200, 200, 6, 2, 64, None),
    # Sq != Sk, both ways
    (2, 100, 260, 4, 2, 64, None), (1, 260, 100, 4, 1, 128, None),
    # a map that is not contiguous groups, split over units
    (1, 150, 150, 8, 2, 128, [1, 0, 1, 1, 0, 1, 1, 1]),
    # whisper-tiny's train step (1500 keys: the last tile short), and
    # qwen2-vl-7b's group of 7
    (8, 1500, 1500, 6, 6, 64, None), (2, 2048, 2048, 28, 4, 128, None)])
def test_flash_bwd_kernel_shapes(cuda, B, Sq, Sk, H, Hk, hd, kv_head, causal):
    """The kernel against its plain version where the work splits over
    heads, rows and keys run past every tile, Sq != Sk and kv_head is any
    map; one launch a call, and the same bits twice."""
    q, k, v, do, kvh = _flash_case(cuda, 12, B, Sq, Sk, H, Hk, hd, kv_head)
    o, lse = fa._flash_fwd(q, k, v, causal, kvh, lse=True)
    before = LAUNCHES["flash_attention_bwd"]
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                 kv_head=kvh)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_bwd"] == before + 1
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                        kv_head=kvh)
    # P and dS enter the tensor cores as bf16 (2^-9 relative each)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.isfinite(a).all()
        assert _rel(a, b) < 2e-2
    again = fa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                   kv_head=kvh)
    assert LAUNCHES["flash_attention_bwd"] == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1, 576), (333, 576), (16384, 576),
                                 (1001, 2048), (4096, 4096), (77, 4096),
                                 (130, 8192), (5, 1000), (12000, 384),
                                 (4096, 3584)])
def test_rmsnorm_bwd_kernel_matches_plain(cuda, n, d):
    """Both row geometries (1 warp a row up to 1024, 4 and 8 beyond), row
    counts that leave a block's run short, and dg the same bits twice."""
    x, g, dh = (t.to(cuda) for t in arrays(13, "bfloat16", (n, d), (d,),
                                            (n, d)))
    before = LAUNCHES["rmsnorm_bwd"]
    got = rn.rmsnorm_bwd(x, g, dh)
    torch.cuda.synchronize()
    assert LAUNCHES["rmsnorm_bwd"] == before + 1
    want = rn.rmsnorm_bwd_plain(x, g, dh)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _rel(a, b) < 1e-2
    again = rn.rmsnorm_bwd(x, g, dh)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,pad", [(1, 576, 0), (333, 576, 0),
                                     (16384, 576, 0), (1001, 2048, 0),
                                     (4096, 4096, 0), (77, 4096, 0),
                                     (130, 8192, 0), (5, 1000, 0),
                                     (300, 576, 64), (12000, 384, 0),
                                     (4096, 3584, 0)])
def test_fused_add_rmsnorm_bwd_kernel_matches_plain(cuda, n, d, pad):
    """The fused backward at both row geometries, runs shorter than a
    block, d = 8192 and d = 1000, and (pad > 0) rows read in place as
    column views of wider buffers (row stride > d): one launch a call, the
    same bits twice, ds within the kernel's l2 of chip_smoke's ``TOL``
    and dg, unrounded as ``_farn_bwd`` has it, within ``DG_L2``.

    ``DG_L2`` = 2e-4: the plain version's dg summed in f32 in other orders
    (rows reversed, blocks of rows, f64), each rounded to bf16, lies at
    most 3.7e-5 (relative L2, on the CPU) from its own at these cases,
    while rounding s * r to bf16 before the product (the rmsnorm
    backward's dg) moves it by 2.4e-3 to 2.8e-3; the test checks that the
    rounded variant fails."""
    DG_L2 = 2e-4

    def operand(seed):
        (wide,) = arrays(seed, "bfloat16", (n, d + pad))
        return wide.to(cuda)[:, :d]
    x, y, dh, ds_out = (operand(20 + i) for i in range(4))
    (g,) = (t.to(cuda) for t in arrays(24, "bfloat16", (d,)))
    s, _ = rn.fused_add_rmsnorm_plain(x, y, g)
    if pad:
        s = torch.cat([s, s[:, :pad]], 1)[:, :d]
        assert s.stride(0) == d + pad and dh.stride(0) == d + pad
    before = LAUNCHES["fused_add_rmsnorm_bwd"]
    got = rn.fused_add_rmsnorm_bwd(s, g, dh, ds_out)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_add_rmsnorm_bwd"] == before + 1
    want = rn.fused_add_rmsnorm_bwd_plain(s, g, dh, ds_out)
    assert got[0] is got[1]
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.isfinite(a).all()
    assert _rel(got[0], want[0]) < 4e-3
    assert _rel(got[2], want[2]) < DG_L2
    sf, dhf = s.float(), dh.float()
    r = torch.rsqrt(torch.mean(sf * sf, -1, keepdim=True) + rn.EPS)
    rounded = torch.sum(dhf * (sf * r).to(torch.bfloat16).float(), 0)
    assert _rel(rounded.to(torch.bfloat16), want[2]) > DG_L2
    again = rn.fused_add_rmsnorm_bwd(s, g, dh, ds_out)
    assert LAUNCHES["fused_add_rmsnorm_bwd"] == before + 2
    assert torch.equal(got[0], again[0]) and torch.equal(got[2], again[2])


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_norm_bwd_instantiations_hold_their_blocks(cuda, fused):
    """Every instantiation of both backwards keeps the geometry's
    ``blocks_per_sm`` resident, with no spills, so its grid is one
    wave."""
    for w, p in ((1, 1), (1, 2), (1, 3), (1, 4), (4, 2), (4, 3), (4, 4),
                 (8, 3), (8, 4)):
        info = rn.norm_bwd_info(w, p, fused)
        geo = rn.norm_bwd_geometry(1 << 20, 256 * w * p, H100_SMS)
        assert (geo["warps_per_row"], geo["packs"]) == (w, p)
        assert info["threads"] == geo["threads"]
        assert info["local_bytes"] == 0, (w, p, info)
        assert info["blocks_per_sm"] == geo["blocks_per_sm"]
        assert info["resident_per_sm"] >= geo["blocks_per_sm"], (w, p)


# ---------------------------------------------------------------------------
# on the card: the grouped FFN's gradient
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 7), (3, 5, 61), (2, 7, 64),
                                   (64, 240, 1408)])
def test_gate_bwd_kernel_matches_plain(cuda, shape):
    """f32 arithmetic in both, each output rounded once to bf16: within
    one bf16 ulp (2^-7 relative), plus 1e-5 of the largest magnitude
    where silu'(h1) cancels near h1 = -1.28; the vector path and the
    element tail alike."""
    h1, h3, dh = (t.to(cuda) for t in arrays(13, "bfloat16", shape, shape,
                                                 shape))
    before = LAUNCHES["grouped_ffn_gate_bwd"]
    got = gm.grouped_ffn_gate_bwd(h1, h3, dh)
    want = gm.grouped_ffn_gate_bwd_plain(h1, h3, dh)
    torch.cuda.synchronize()
    assert LAUNCHES["grouped_ffn_gate_bwd"] == before + 1
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        a, b = a.float(), b.float()
        allowed = 2 ** -7 * b.abs() + 1e-5 * b.abs().max()
        assert bool(((a - b).abs() <= allowed).all())


@pytest.mark.cuda
@pytest.mark.parametrize("E,N,D,Fd", [(4, 37, 128, 64), (8, 100, 256, 192),
                                      (2, 1, 128, 128)])
def test_grouped_ffn_function_matches_autograd(cuda, E, N, D, Fd):
    """``GroupedFFN`` on the card (the forward kernel, the bf16 products
    and the gate kernel) against torch.autograd of the f32 plain version:
    the products round h1, h3, dh, dh1, dh3 and h to bf16, so 2e-2
    relative L2."""
    x, w1, w3, w2, dy = (t.to(cuda) for t in arrays(
        14, "bfloat16", (E, N, D), (E, D, Fd), (E, D, Fd), (E, Fd, D),
        (E, N, D)))
    w1, w3, w2 = (w * w.shape[1] ** -0.5 for w in (w1, w3, w2))
    ins = [t.clone().requires_grad_() for t in (x, w1, w3, w2)]
    counts = dict(LAUNCHES)
    y = gm.grouped_ffn(*ins)
    got = torch.autograd.grad(y, ins, dy)
    torch.cuda.synchronize()
    for name in ("grouped_ffn", "grouped_ffn_gate_bwd"):
        assert LAUNCHES[name] == counts.get(name, 0) + 1, name
    ref = [t.float().requires_grad_() for t in (x, w1, w3, w2)]
    want = torch.autograd.grad(gm.grouped_ffn_plain(*ref), ref, dy.float())
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert _rel(a, b) < 2e-2


# ---------------------------------------------------------------------------
# the SSD scan's gradient
# ---------------------------------------------------------------------------

def ssd_inputs(seed, b, L, H, G, N, P=64, dtype=torch.bfloat16,
               fdtype=torch.float32, views=True):
    """Seeded scan operands as the model hands them over: x, B and C in
    ``dtype``, column views of one (b, L, H P + 2 G N) activation where
    ``views``; dt = softplus(n - 1), A = -exp(U(0, log 16)), D ~ N(1,
    1/4) in ``fdtype``; and a cotangent dy in ``dtype``."""
    rng = np.random.default_rng(seed)

    def t(a, dt):
        return torch.from_numpy(np.asarray(a, np.float64)).to(dt)

    xbc = t(rng.standard_normal((b, L, H * P + 2 * G * N)), dtype)
    x = xbc[..., :H * P].unflatten(-1, (H, P))
    Bm = xbc[..., H * P:H * P + G * N].unflatten(-1, (G, N))
    Cm = xbc[..., H * P + G * N:].unflatten(-1, (G, N))
    if not views:
        x, Bm, Cm = x.contiguous(), Bm.contiguous(), Cm.contiguous()
    dt = torch.nn.functional.softplus(
        t(rng.standard_normal((b, L, H)) - 1.0, fdtype))
    A = -torch.exp(t(rng.uniform(0.0, math.log(16.0), H), fdtype))
    D = t(rng.normal(1.0, 0.5, H), fdtype)
    dy = t(rng.standard_normal((b, L, H, P)), dtype)
    return x, dt, A, Bm, Cm, D, dy


def _bf16_close(a, b):
    """One bf16 rounding of each side (2^-7 relative) plus 2e-3 of the
    largest magnitude where f32 sums in another order cancel, and 1e-2
    relative L2."""
    a, b = a.float(), b.float()
    allowed = 2 ** -7 * b.abs() + 2e-3 * b.abs().max()
    return bool(((a - b).abs() <= allowed).all()) and _rel(a, b) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("b,L,H,G,N,chunk", SSD_TRAIN + SSD_ODD + SSD_SETS)
def test_ssd_scan_bwd_kernel_matches_plain(cuda, monkeypatch, b, L, H, G, N,
                                           chunk):
    """The kernels against ``ssd_scan_bwd_plain`` on the card: both in f32
    from the same bf16 operands, the sums in another order; dx, dB and dC
    each rounded once to bf16 (``_bf16_close``), ddt, dA and dD within
    1e-3 relative L2.  Two calls give the same bits.  ``SSD_SMS`` gives
    the geometry another SM count, for head sets of unequal size."""
    sms = SSD_SMS.get((b, L, H, G, N, chunk))
    if sms is not None:
        monkeypatch.setattr(ssd, "sm_count", lambda index: sms)
    x, dt, A, Bm, Cm, D, dy = (t.to(cuda) for t in ssd_inputs(
        20, b, L, H, G, N))
    before = LAUNCHES["ssd_scan_bwd"]
    got = ssd.ssd_scan_bwd(x, dt, A, Bm, Cm, D, dy, chunk=chunk)
    want = ssd.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, D, dy, chunk=chunk)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan_bwd"] == before + 1
    for name, a, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        assert bool(torch.isfinite(a.float()).all()), name
        if a.dtype == torch.bfloat16:
            assert _bf16_close(a, w), name
        else:
            assert _rel(a, w) < 1e-3, (name, _rel(a, w))
    again = ssd.ssd_scan_bwd(x, dt, A, Bm, Cm, D, dy.clone(), chunk=chunk)
    for a, w in zip(got, again):
        assert torch.equal(a, w)


@pytest.mark.cuda
def test_ssd_scan_bwd_takes_any_cotangent_layout(cuda):
    """dy as a transposed copy's view (not kernel-ready) gives the bits of
    the contiguous dy."""
    x, dt, A, Bm, Cm, D, dy = (t.to(cuda) for t in ssd_inputs(
        21, 2, 128, 4, 1, 64))
    odd = dy.transpose(1, 2).contiguous().transpose(1, 2)
    assert not odd.is_contiguous()
    got = ssd.ssd_scan_bwd(x, dt, A, Bm, Cm, D, odd)
    want = ssd.ssd_scan_bwd(x, dt, A, Bm, Cm, D, dy)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_ssd_scan_op_trains_through_the_kernels(cuda, arch):
    """``SSDScanOp`` at the published widths on CUDA tensors with a
    gradient to flow: the forward kernel and the backward kernels launch,
    and every scan input (the post-conv activations, the raw dt) and
    parameter (A_log, D, dt_bias) gets a finite, nonzero gradient, within
    1e-2 relative L2 of the CPU's (the plain versions)."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import MeshInfo
    from repro_torch.models.mamba2 import SSDScanOp
    op = SSDScanOp(get_config(arch), MeshInfo())
    rng = np.random.default_rng(22)
    L, H = 256, op.H_loc
    xbc0 = torch.from_numpy(rng.standard_normal((1, L, op.ch_loc)).astype(
        np.float32)).bfloat16()
    dt0 = torch.from_numpy(rng.standard_normal((1, L, H)).astype(
        np.float32)).bfloat16()
    p0 = {"A_log": torch.from_numpy(np.log(rng.uniform(1, 16, H)).astype(
              np.float32)),
          "D": torch.from_numpy(rng.normal(1, 0.5, H).astype(np.float32)),
          "dt_bias": torch.from_numpy(rng.normal(0, 0.5, H).astype(
              np.float32))}
    wgt = torch.from_numpy(rng.standard_normal((1, L, op.d_in_loc)).astype(
        np.float32))
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        ins = [t.to(dev).requires_grad_() for t in
               (xbc0, dt0, p0["A_log"], p0["D"], p0["dt_bias"])]
        p = dict(zip(("A_log", "D", "dt_bias"), ins[2:]))
        counts = dict(LAUNCHES)
        y = op.kernel(p, ins[0], ins[1])
        grads[dev.type] = torch.autograd.grad(
            (y.float() * wgt.to(dev)).sum(), ins)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            for name in ("ssd_scan", "ssd_scan_bwd"):
                assert LAUNCHES[name] == counts.get(name, 0) + 1, name
    for name, g, c in zip(("xbc", "dt", "A_log", "D", "dt_bias"),
                          grads["cuda"], grads["cpu"]):
        assert bool(torch.isfinite(g.float()).all()), name
        assert float(g.float().norm()) > 0, name
        assert _rel(g.cpu(), c) < 1e-2, (name, _rel(g.cpu(), c))
