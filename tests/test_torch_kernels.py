"""The port's kernels (src/repro_torch/kernels) against the JAX package.

On the CPU every wrapper takes its plain PyTorch version; those are held
against ``repro.kernels.ref`` and, for decode attention and the two
norms, against the Pallas kernel run in interpret mode (the flash Pallas
kernel calls ``pl.load``, which the installed jax no longer has).  The
sweeps are those of tests/test_kernels.py, with its tolerances:
f32 atol=2e-5 rtol=1e-4, bf16 atol=rtol=3e-2.  Inputs come from seeded
numpy and reach both frameworks bit-identical.

The Hopper kernels themselves are held against these plain versions on
the card in tests/test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import ops as tops
from repro_torch.kernels import tokenweave as ttw

F32 = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=3e-2, rtol=3e-2)
DTYPES = ["float32", "bfloat16"]


def tol(dtype):
    return BF16 if dtype == "bfloat16" else F32


def arrays(seed, dtype, *shapes):
    """The same values as (jax, torch) pairs, rounded once per dtype."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        a = rng.standard_normal(shape).astype(np.float32)
        out.append((jnp.asarray(a).astype(dtype),
                    torch.from_numpy(a).to(getattr(torch, dtype))))
    return out


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(a, b, dtype="float32"):
    np.testing.assert_allclose(np32(a), np32(b), **tol(dtype))


# ---------------------------------------------------------------------------
# rmsnorm / fused add+rmsnorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,d", [(4, 32), (64, 96), (128, 256), (7, 40)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_plain_matches_reference(n, d, dtype):
    (xj, xt), (gj, gt) = arrays(0, dtype, (n, d), (d,))
    got = tops.rmsnorm(xt, gt)
    close(got, jref.rmsnorm(xj, gj), dtype)
    close(got, jops.rmsnorm(xj, gj), dtype)      # Pallas, interpret mode
    assert got.dtype == xt.dtype


@pytest.mark.parametrize("n,d", [(8, 16), (33, 64), (256, 128)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_add_rmsnorm_plain_matches_reference(n, d, dtype):
    (xj, xt), (yj, yt), (gj, gt) = arrays(1, dtype, (n, d), (n, d), (d,))
    s, h = tops.fused_add_rmsnorm(xt, yt, gt)
    for want in (jref.fused_add_rmsnorm(xj, yj, gj),
                 jops.fused_add_rmsnorm(xj, yj, gj)):
        close(s, want[0], dtype)
        close(h, want[1], dtype)


def test_tokenweave_unsharded_is_fused_add_rmsnorm():
    """Without a bound ``model`` axis the collective halves are the
    identity (tests/test_kernels.py::test_tokenweave_fused_unsharded)."""
    (xj, xt), (yj, yt), (gj, gt) = arrays(2, "float32", (2, 16, 32),
                                          (2, 16, 32), (32,))
    s, h = ttw.fused_ar_add_rmsnorm(yt, xt, gt)
    s2, h2 = jops.fused_ar_add_rmsnorm(yj, xj, gj)
    np.testing.assert_allclose(np32(s), np32(s2), atol=1e-5)
    np.testing.assert_allclose(np32(h), np32(h2), atol=1e-5)


def test_norms_take_the_plain_path_on_meta_tensors():
    x = torch.empty((3, 5, 64), dtype=torch.bfloat16, device="meta")
    g = torch.empty((64,), dtype=torch.bfloat16, device="meta")
    before = dict(LAUNCHES)
    assert tops.rmsnorm(x, g).shape == x.shape
    s, h = tops.fused_add_rmsnorm(x, x, g)
    assert s.device.type == h.device.type == "meta"
    assert dict(LAUNCHES) == before


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,H,hd", [(1, 32, 2, 16), (2, 64, 4, 32),
                                      (2, 128, 1, 64), (1, 96, 3, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_reference(B, S, H, hd, causal):
    (qj, qt), (kj, kt), (vj, vt) = arrays(3, "float32", (B, S, H, hd),
                                          (B, S, H, hd), (B, S, H, hd))
    close(tops.flash_attention(qt, kt, vt, causal=causal),
          jref.flash_attention(qj, kj, vj, causal=causal))


def test_flash_plain_bf16():
    (qj, qt), (kj, kt), (vj, vt) = arrays(4, "bfloat16", (2, 64, 2, 32),
                                          (2, 64, 2, 32), (2, 64, 2, 32))
    close(tops.flash_attention(qt, kt, vt), jref.flash_attention(qj, kj, vj),
          "bfloat16")


@pytest.mark.parametrize("sq,sk", [(16, 16), (48, 64), (64, 96), (16, 96)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_rectangular(sq, sk, causal):
    """Sq != Sk, causal mask aligned top-left."""
    (qj, qt), (kj, kt), (vj, vt) = arrays(5, "float32", (1, sq, 2, 16),
                                          (1, sk, 2, 16), (1, sk, 2, 16))
    close(tops.flash_attention(qt, kt, vt, causal=causal),
          jref.flash_attention(qj, kj, vj, causal=causal))


def test_flash_plain_gqa_slot_map_equals_expanded_kv():
    """kv_head reads each q head's K/V head in place: the same function
    as the JAX package's expanded (``jnp.take``) K/V."""
    H, Hk = 6, 2
    (qj, qt), (kj, kt), (vj, vt) = arrays(6, "float32", (2, 40, H, 16),
                                          (2, 40, Hk, 16), (2, 40, Hk, 16))
    slot = np.arange(H) // (H // Hk)
    got = tops.flash_attention(qt, kt, vt,
                               kv_head=torch.from_numpy(slot).int())
    want = jref.flash_attention(qj, jnp.take(kj, slot, axis=2),
                                jnp.take(vj, slot, axis=2))
    close(got, want)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,H,hd", [(2, 128, 4, 32), (4, 64, 2, 16)])
@pytest.mark.parametrize("frac", [0, 1, 2])
def test_decode_plain_matches_reference_and_pallas(B, S, H, hd, frac):
    (kj, kt), (vj, vt), (qj, qt) = arrays(7, "float32", (B, S, H, hd),
                                          (B, S, H, hd), (B, 1, H, hd))
    clen = (1, S // 2, S)[frac]
    got = tops.decode_attention(qt, kt, vt, torch.tensor(clen, dtype=torch.int32))
    close(got, jref.decode_attention(qj, kj, vj, jnp.int32(clen)))
    close(got, jops.decode_attention(qj, kj, vj, jnp.int32(clen)))


def test_decode_plain_ragged_lengths():
    """Per-request cache lengths (continuous batching)."""
    B, S, H, hd = 4, 64, 2, 16
    (kj, kt), (vj, vt), (qj, qt) = arrays(8, "float32", (B, S, H, hd),
                                          (B, S, H, hd), (B, 1, H, hd))
    lens = np.asarray([3, 17, 64, 1], np.int32)
    got = tops.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    close(got, jref.decode_attention(qj, kj, vj, jnp.asarray(lens)))
    close(got, jops.decode_attention(qj, kj, vj, jnp.asarray(lens)))


def test_decode_plain_bf16_with_slot_map():
    B, S, H, Hk, hd = 3, 96, 4, 2, 32
    (kj, kt), (vj, vt), (qj, qt) = arrays(9, "bfloat16", (B, S, Hk, hd),
                                          (B, S, Hk, hd), (B, 1, H, hd))
    slot = np.arange(H) // (H // Hk)
    lens = np.asarray([96, 50, 7], np.int32)
    got = tops.decode_attention(qt, kt, vt, torch.from_numpy(lens),
                                kv_head=torch.from_numpy(slot).int())
    want = jref.decode_attention(qj, jnp.take(kj, slot, axis=2),
                                 jnp.take(vj, slot, axis=2),
                                 jnp.asarray(lens))
    close(got, want, "bfloat16")
