"""The port's kernels (src/repro_torch/kernels) against the JAX package.

On the CPU every wrapper takes its plain PyTorch version; those are held
against ``repro.kernels.ref`` and, for decode attention, the two norms
and the grouped expert FFN, against the Pallas kernel run in interpret
mode (the flash Pallas kernel calls ``pl.load``, which the installed jax
no longer has).  The sweeps are those of tests/test_kernels.py, with its
tolerances: f32 atol=2e-5 rtol=1e-4 (grouped FFN atol=1e-4 rtol=1e-3),
bf16 atol=rtol=3e-2.  Inputs come from seeded numpy and reach both
frameworks bit-identical.

The Hopper kernels themselves are held against these plain versions on
the card in tests/test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import LAUNCHES, kernel_ready
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rmsnorm as trn
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


@pytest.mark.parametrize("S", [1, 17, 127, 128, 129, 1100, 4096, 4097,
                               4200, 32768, 100000])
def test_decode_chunk_covers_the_cache_in_at_most_32_chunks(S):
    chunk, n = tdec.decode_chunk(S)
    assert chunk % tdec.TILE_KEYS == 0 and 1 <= n <= tdec.MAX_CHUNKS
    assert (n - 1) * chunk < S <= n * chunk
    # the least such chunk: one tile less would need more than 32
    assert chunk == tdec.TILE_KEYS or \
        -(-S // (chunk - tdec.TILE_KEYS)) > tdec.MAX_CHUNKS


@pytest.mark.parametrize("S,H,Hk,hd", [(4096, 32, 2, 128), (4096, 16, 16, 128),
                                       (1100, 9, 3, 64), (8192, 32, 32, 128)])
def test_decode_geometry_never_changes_with_the_batch(S, H, Hk, hd):
    """The chunk, and so each row's blocks and merge order, is the same at
    every batch size: a row's output is bitwise the same at every tier."""
    one = tdec.decode_geometry(1, S, H, Hk, hd)
    for B in range(1, 9):
        geo = tdec.decode_geometry(B, S, H, Hk, hd)
        assert (geo["chunk"], geo["n_chunks"], geo["group"]) == (
            one["chunk"], one["n_chunks"], one["group"])
        assert geo["grid"] == (one["n_chunks"], B * Hk)
        assert geo["work_words"] == (B * H * (geo["n_chunks"] + 4) * (hd + 2)
                                     + B * Hk * 5)


@pytest.mark.parametrize("H,Hk,group", [(32, 2, 16), (16, 16, 32), (32, 32, 32),
                                        (9, 3, 32), (32, 4, 32), (48, 2, 10),
                                        (64, 2, 8)])
def test_decode_merge_group_bounds_a_merge(H, Hk, group):
    """A merge holds ~256 partial rows of a GQA group, one level where the
    group is small; a row of 32 chunks needs at most 4 first merges."""
    assert tdec.decode_merge_group(H, Hk) == group
    assert -(-tdec.MAX_CHUNKS // group) <= tdec.MERGE_GROUPS


@pytest.mark.parametrize("d,warps,packs", [
    (8, 1, 1), (40, 1, 1), (256, 1, 1), (264, 1, 2), (576, 1, 3),
    (1536, 1, 8), (2048, 4, 2), (2560, 4, 3), (4096, 4, 4), (8192, 4, 8)])
def test_norm_geometry_covers_the_row_at_least_cost(d, warps, packs):
    assert trn.norm_geometry(d) == (warps, packs)
    assert 256 * warps * packs >= d
    smaller = [p for p in trn.NORM_PACKS if p < packs]
    assert not smaller or 256 * warps * smaller[-1] < d


@pytest.mark.parametrize("d", [0, 44, 4100, 8200, 16384])
def test_norm_geometry_refuses_widths_the_kernel_does_not_take(d):
    with pytest.raises(ValueError):
        trn.norm_geometry(d)


@pytest.mark.parametrize("n,d,block_rows", [
    (4096, 4096, 256), (8192, 4096, 256), (8192, 4096, 32), (4096, 4096, 1),
    (4096, 4096, 128), (7, 576, 256), (33, 40, 1), (100, 8192, 3),
    (8192, 2048, 100), (1, 8, 1), (4096, 4096, 2), (100000, 1536, 64),
    (50000, 8192, 40)])
@pytest.mark.parametrize("x_bytes,paired", [(2, True), (2, False),
                                            (4, False)])
def test_fused_geometry_keeps_the_knob_and_fits_the_ring(
        n, d, block_rows, x_bytes, paired):
    """ceil(n / block_rows) blocks whatever the shape; consumer warps
    within the kernel's cap, in whole rows; a ring of at least one stage
    and at most a block's rows within 227 KB, as many as fit; a row
    covered by its warps' packs (``norm_geometry``); where the ring wraps,
    whole groups of stages."""
    geo = trn.fused_geometry(n, d, block_rows, x_bytes=x_bytes,
                             paired=paired)
    cw = geo["consumer_warps"]
    cap = (8 if geo["packs"] == 8 else 20 if paired and x_bytes == 2
           else 16)
    want = min(cap, 20)
    assert cw <= cap and cw % geo["warps_per_row"] == 0
    stage = 2 * d * x_bytes + 16
    assert cw == want // geo["warps_per_row"] * geo["warps_per_row"] or (
        (cw + geo["warps_per_row"]) // geo["warps_per_row"] * stage
        > trn.SMEM_PER_BLOCK)
    assert geo["ctas"] == -(-n // block_rows)
    assert (geo["warps_per_row"], geo["packs"]) == trn.norm_geometry(d)
    assert geo["groups"] * geo["warps_per_row"] == cw
    assert geo["threads"] == 32 * (1 + cw)
    assert 1 <= geo["stages"] <= min(block_rows, n, 64)
    assert geo["smem_bytes"] == geo["stages"] * stage + 2 * cw * 4
    assert geo["smem_bytes"] <= trn.SMEM_PER_BLOCK
    if geo["stages"] < min(block_rows, n):      # the ring wraps
        assert geo["stages"] % geo["groups"] == 0
    # as many stages as fit (up to the rows and the cap), in whole groups
    fit = (trn.SMEM_PER_BLOCK - 2 * cw * 4) // stage
    assert (geo["stages"] == min(block_rows, n, 64)
            or geo["stages"] > fit - geo["groups"])


def test_fused_geometry_gives_tokenweave_its_block_counts():
    """TokenWeave's block_rows 256 at chatglm3-6b's and zamba2-1.2b's
    prefills: 16 and 32 blocks of 20 consumer warps (5 rows at once),
    each block alone on its SM with a ring of 10 rows of x and y at d =
    4096 bf16 (the most that fits, in whole groups); 32 rows a block
    (256 blocks) keep the same ring."""
    for n, ctas in ((4096, 16), (8192, 32)):
        geo = trn.fused_geometry(n, 4096, 256)
        assert (geo["ctas"], geo["consumer_warps"], geo["groups"],
                geo["stages"]) == (ctas, 20, 5, 10)
    geo = trn.fused_geometry(8192, 4096, 32)
    assert (geo["ctas"], geo["stages"]) == (256, 10)


@pytest.mark.parametrize("d,block_rows", [(44, 256), (8200, 256), (0, 1),
                                          (4096, 0), (4096, -3)])
def test_fused_geometry_refuses_what_the_kernel_does_not_take(d, block_rows):
    with pytest.raises(ValueError):
        trn.fused_geometry(64, d, block_rows)


def test_rmsnorm_rows_alignment_check():
    """Rows the kernel reads in place: 16-byte aligned starts; others are
    copied first."""
    x = torch.zeros((4, 2056), dtype=torch.bfloat16)
    assert kernel_ready(x) is x and kernel_ready(x[:, 8:]) is not None
    assert kernel_ready(x[:, 8:]).data_ptr() == x[:, 8:].data_ptr()
    assert kernel_ready(x[:, 4:]).data_ptr() % 16 == 0
    assert kernel_ready(x[:, 4:]).data_ptr() != x[:, 4:].data_ptr()
    y = torch.zeros((4, 2052), dtype=torch.bfloat16)
    assert kernel_ready(y) is not y
    z = torch.zeros((1, 2052), dtype=torch.bfloat16)
    assert kernel_ready(z) is z


def test_kernel_ready_realigns_a_contiguous_view_at_a_misaligned_base():
    """A contiguous bf16 (4, 64) view 8 bytes into its storage: the
    helper copies it to a 16-byte aligned base with the same values
    (``.contiguous()`` hands it back unchanged); an aligned tensor
    passes through without a copy."""
    buf = torch.arange(4 * 64 + 8, dtype=torch.float32).to(torch.bfloat16)
    base = kernel_ready(buf)
    assert base is buf and buf.data_ptr() % 16 == 0
    view = buf[4:4 + 4 * 64].view(4, 64)
    assert view.is_contiguous() and view.data_ptr() % 16 == 8
    assert view.contiguous().data_ptr() == view.data_ptr()
    got = kernel_ready(view)
    assert got.data_ptr() % 16 == 0 and got.shape == (4, 64)
    assert torch.equal(got, view)
    aligned = buf[8:8 + 4 * 64].view(4, 64)
    assert kernel_ready(aligned) is aligned


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_ready_copies_rows_whose_stride_breaks_16_bytes(dtype):
    """Row strides are held in bytes: a 24-byte row stride is copied, a
    48-byte one read in place; a broadcast (stride 0) dimension is
    copied, an extent-1 dimension may have any stride."""
    x = torch.zeros((3, 48 // torch.tensor([], dtype=dtype).element_size()),
                    dtype=dtype)
    step = 16 // x.element_size()
    assert kernel_ready(x[:, :step]).data_ptr() == x.data_ptr()
    odd = torch.zeros((3, 24 // x.element_size()), dtype=dtype)[:, :step]
    got = kernel_ready(odd)
    assert got.data_ptr() != odd.data_ptr() and got.is_contiguous()
    assert torch.equal(got, odd)
    wide = x[:1].expand(3, x.shape[1])
    assert kernel_ready(wide).stride(0) == x.shape[1]
    one = x[:1, :step]
    assert kernel_ready(one).data_ptr() == one.data_ptr()


# ---------------------------------------------------------------------------
# grouped expert FFN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E,N,D,F", [(2, 16, 24, 32), (4, 64, 48, 96),
                                     (1, 128, 64, 256), (4, 4, 48, 96)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_ffn_plain_matches_reference_and_pallas(E, N, D, F, dtype):
    """The sweep of tests/test_kernels.py plus decode's N=4 capacity."""
    rng = np.random.default_rng(10)
    vals = [rng.standard_normal(s).astype(np.float32) * c for s, c in
            (((E, N, D), 0.5), ((E, D, F), 0.1), ((E, D, F), 0.1),
             ((E, F, D), 0.1))]
    js = [jnp.asarray(a).astype(dtype) for a in vals]
    ts = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in vals]
    got = tops.grouped_ffn(*ts)
    assert got.dtype == ts[0].dtype and got.shape == (E, N, D)
    t = dict(atol=1e-4, rtol=1e-3) if dtype == "float32" else BF16
    for want in (jref.grouped_ffn(*js), jops.grouped_ffn(*js)):
        np.testing.assert_allclose(np32(got), np32(want), **t)


def test_grouped_ffn_plain_maps_zero_rows_to_zero_and_skips_meta():
    x = torch.zeros((3, 5, 16), dtype=torch.bfloat16)
    w = torch.ones((3, 16, 8), dtype=torch.bfloat16)
    assert not tops.grouped_ffn(x, w, w, w.transpose(1, 2)).any()
    before = dict(LAUNCHES)
    m = tops.grouped_ffn(x.to("meta"), w.to("meta"), w.to("meta"),
                         w.transpose(1, 2).to("meta"))
    assert m.device.type == "meta" and m.shape == x.shape
    assert dict(LAUNCHES) == before
