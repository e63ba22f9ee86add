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
    ``FusedAddRMSNorm``) against torch.autograd of its plain forward.

Tolerances: in f32, 1e-4 relative (sums over up to 128 keys or 128
columns in another order; JAX's vjp of the plain norm multiplies dh by g
before the f32 chain, as the port does); in bf16, 3e-2 (tests/
test_kernels.py's bf16 tolerance: the two frameworks round bf16 at other
places — JAX's autodiff rounds dh * g and the attention probabilities to
bf16, the port's plain versions keep f32 to the output), atol scaled by
the reference's largest magnitude.

The ``cuda``-marked cases hold the kernels to their plain versions on the
card (skipped here); the JAX package is imported only by the cases that
compare with it, so those run on a machine without it too.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn

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
