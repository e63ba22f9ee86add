"""The Hopper kernels of src/repro_torch/kernels against their plain
PyTorch versions, on the card.  Every case carries the ``cuda`` marker
and skips without a CUDA device; the file imports neither JAX nor the
JAX package, so it runs on the GPU machine too:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py

Tolerances (the same as chip_smoke.py's): every element within
atol + rtol*|plain| and the relative L2 error within l2, per kernel.
  flash   2^-8 * P|V| + 2^-7 * |plain|, l2 1e-2: the kernel rounds each
          probability to bf16 for the PV product (2^-9 relative), which
          moves an output by at most 2^-9 * P|V|, P|V| being the plain
          attention of |v| (factor 2 margin), plus one output ulp
  decode  atol 1e-3, rtol 1e-2, l2 1e-2: f32 sums; the probabilities
          enter the PV product as a bf16 high and low part (~2^-16
          relative), and only the output is rounded (1 ulp < 1e-2
          relative)
  norms   atol 1e-3, rtol 1.6e-2, l2 4e-3: f32 sums; x*rsqrt rounded to
          bf16, then *g rounded (2 ulps)
  grouped_ffn
          2^-8 * |h|@|W2| + 2^-7 * |plain|, l2 1e-2: the kernel keeps
          h = silu(x W1) * (x W3) in bf16 (2^-9 relative), which moves an
          output by at most 2^-9 * |h|@|W2| (factor 2 margin); F is summed
          in f32 and the output rounded once (one ulp)
  ssd_scan
          atol 1e-3, rtol 2^-7, l2 1e-2: the kernel's products run on the
          tensor cores in f32, C B^T and C exactly (bf16 products), M, the
          state and w*x each as a bf16 high and low part (~2^-17
          relative); sums in other orders (f32 round-off ~1e-4 of the
          terms' sum); only the output is rounded to bf16, and two f32
          values that straddle a rounding boundary land one ulp (<= 2^-7
          relative) apart
"""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import grouped_matmul as tgm
from repro_torch.kernels import rmsnorm as trn
from repro_torch.kernels import ssd_scan as tssd

FLASH = dict(atol=0.0, pv=2 ** -8, rtol=2 ** -7, l2=1e-2)
DECODE = dict(atol=1e-3, rtol=1e-2, l2=1e-2)
NORM = dict(atol=1e-3, rtol=1.6e-2, l2=4e-3)
GFFN = dict(atol=0.0, pv=2 ** -8, rtol=2 ** -7, l2=1e-2)
SSD = dict(atol=1e-3, rtol=2 ** -7, l2=1e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


def _dev(seed, dev, *shapes):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
            for s in shapes]


def _close(a, b, tol, pv=None):
    a, b = a.float(), b.float()
    allowed = tol["atol"] + tol["rtol"] * b.abs()
    if pv is not None:
        allowed = allowed + tol["pv"] * pv.float()
    bad = (a - b).abs() > allowed
    assert not bad.any(), (int(bad.sum()), float((a - b).abs().max()))
    assert float((a - b).norm() / b.norm()) <= tol["l2"]


def _flash_close(got, q, k, v, **kw):
    _close(got, tfa.flash_attention_plain(q, k, v, **kw), FLASH,
           pv=tfa.flash_attention_plain(q, k, v.abs(), **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,Hk,hd,causal", [
    (2, 256, 256, 8, 2, 128, True), (1, 200, 200, 4, 4, 64, True),
    (2, 96, 160, 4, 1, 64, False), (1, 130, 70, 2, 2, 128, True),
    # whisper-tiny: the encoder and the prefill's cross-attention (1500
    # keys, the last tile short), one decode row against 2048 encoder rows
    (4, 1500, 1500, 6, 6, 64, False), (4, 1, 2048, 6, 6, 64, False),
    # GQA groups of 7 (qwen2-vl-7b, deepseek-coder-33b)
    (1, 2048, 2048, 28, 4, 128, True), (1, 2048, 2048, 56, 8, 128, True)])
def test_flash_kernel_matches_plain(cuda, B, Sq, Sk, H, Hk, hd, causal):
    q, k, v = _dev(0, cuda, (B, Sq, H, hd), (B, Sk, Hk, hd), (B, Sk, Hk, hd))
    slot = (torch.arange(H, device=cuda) // (H // Hk)).int()
    n = LAUNCHES["flash_attention"]
    got = tfa.flash_attention(q, k, v, causal=causal, kv_head=slot)
    assert LAUNCHES["flash_attention"] == n + 1
    _flash_close(got, q, k, v, causal=causal, kv_head=slot)


@pytest.mark.cuda
def test_flash_kernel_reads_strided_views(cuda):
    """q/k/v as views into one fused projection (the model's layout)."""
    B, S, H, hd = 2, 128, 4, 64
    qkv = _dev(1, cuda, (B, S, 3 * H * hd))[0]
    q, k, v = (t.reshape(B, S, H, hd) for t in qkv.split(H * hd, dim=-1))
    _flash_close(tfa.flash_attention(q, k, v), q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("Hk", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sk", [127, 128, 129, 257])
@pytest.mark.parametrize("Sq", [127, 128, 129, 257])
def test_flash_kernel_at_tile_edges(cuda, Sq, Sk, causal, Hk, hd):
    """One key or row either side of the kernel's 128-row q tiles and
    128-key K/V tiles, GQA (4 q heads on 1 kv head) and not."""
    B, H = 2, 4
    q, k, v = _dev(12, cuda, (B, Sq, H, hd), (B, Sk, Hk, hd), (B, Sk, Hk, hd))
    slot = (torch.arange(H, device=cuda) // (H // Hk)).int()
    got = tfa.flash_attention(q, k, v, causal=causal, kv_head=slot)
    _flash_close(got, q, k, v, causal=causal, kv_head=slot)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_kernel_is_batch_invariant(cuda, hd):
    """Each row of a B=1 call equals the same row of a B=2 call bitwise
    (NanoFlow's halves against the whole batch)."""
    B, S, H, Hk = 2, 300, 8, 2
    q, k, v = _dev(13, cuda, (B, S, H, hd), (B, S, Hk, hd), (B, S, Hk, hd))
    slot = (torch.arange(H, device=cuda) // (H // Hk)).int()
    whole = tfa.flash_attention(q, k, v, kv_head=slot)
    for r in range(B):
        row = tfa.flash_attention(q[r:r + 1], k[r:r + 1], v[r:r + 1],
                                  kv_head=slot)
        assert torch.equal(row[0], whole[r])


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
def test_decode_kernel_matches_plain(cuda, hd):
    B, S, H, Hk = 4, 1100, 8, 2
    q, kc, vc = _dev(2, cuda, (B, 1, H, hd), (B, S, Hk, hd), (B, S, Hk, hd))
    slot = (torch.arange(H, device=cuda) // (H // Hk)).int()
    # 1300 > S: the kernel must stop at the cache's end like the plain one
    clen = torch.tensor([1300, 513, 512, 1], dtype=torch.int32, device=cuda)
    n = LAUNCHES["decode_attention"]
    got = tdec.decode_attention(q, kc, vc, clen, kv_head=slot)
    assert LAUNCHES["decode_attention"] == n + 1
    _close(got, tdec.decode_attention_plain(q, kc, vc, clen, kv_head=slot),
           DECODE)


def _decode_inputs(seed, dev, B, S, H, Hk, hd, lens):
    q, kc, vc = _dev(seed, dev, (B, 1, H, hd), (B, S, Hk, hd),
                     (B, S, Hk, hd))
    slot = (torch.arange(H, device=dev) // (H // Hk)).int()
    clen = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kc, vc, slot, clen


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1100, 8500])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 7, 8, 16, 24])
def test_decode_kernel_groups_and_chunk_edges(cuda, G, hd, S):
    """Every GQA group size a block serves (24: two tiles of 16 heads),
    at lengths of 1, a chunk -1, +0 and +1, S and past S (S=8500 takes
    512-key chunks of two tiles, 17 to a row: two merge levels at G=16
    and 24)."""
    chunk, _ = tdec.decode_chunk(S)
    assert chunk == (256 if S == 1100 else 512)
    lens = [1, chunk - 1, chunk, chunk + 1, S, S + 200]
    q, kc, vc, slot, clen = _decode_inputs(20, cuda, len(lens), S, 2 * G, 2,
                                           hd, lens)
    n = LAUNCHES["decode_attention"]
    got = tdec.decode_attention(q, kc, vc, clen, kv_head=slot)
    assert LAUNCHES["decode_attention"] == n + 1
    _close(got, tdec.decode_attention_plain(q, kc, vc, clen, kv_head=slot),
           DECODE)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hk,hd,S", [(56, 8, 128, 4096), (28, 4, 128, 4096),
                                      (32, 8, 128, 4096), (6, 6, 64, 2048)])
def test_decode_kernel_at_the_configs_heads(cuda, H, Hk, hd, S):
    """deepseek-coder-33b's and qwen2-vl-7b's groups of 7, minitron-8b's 4
    at 8 K/V heads, whisper-tiny's 6 heads of 64, at their decode tiers'
    cache lengths."""
    lens = [S, S - 1, S // 2 + 1, 17] if S == 4096 else [1516, 1510, 1505,
                                                          1501]
    q, kc, vc, slot, clen = _decode_inputs(21, cuda, 4, S, H, Hk, hd, lens)
    got = tdec.decode_attention(q, kc, vc, clen, kv_head=slot)
    _close(got, tdec.decode_attention_plain(q, kc, vc, clen, kv_head=slot),
           DECODE)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
def test_decode_kernel_reads_strided_cache_views(cuda, hd):
    """Caches as the decode layer loop hands them over: one layer of a
    stacked (L, B, S, Hk, hd) cache, cut to a tier's first rows; and K, V
    as interleaved views of one (B, S, 2, Hk, hd) buffer."""
    L, Bmax, B, S, H, Hk = 3, 4, 2, 700, 8, 2
    stack_k, stack_v, q = _dev(21, cuda, (L, Bmax, S, Hk, hd),
                               (L, Bmax, S, Hk, hd), (B, 1, H, hd))
    slot = (torch.arange(H, device=cuda) // (H // Hk)).int()
    clen = torch.tensor([700, 300], dtype=torch.int32, device=cuda)
    kc, vc = stack_k[1, :B], stack_v[1, :B]
    want = tdec.decode_attention_plain(q, kc.contiguous(), vc.contiguous(),
                                       clen, kv_head=slot)
    _close(tdec.decode_attention(q, kc, vc, clen, kv_head=slot), want,
           DECODE)
    kv = torch.stack([kc, vc], dim=2)
    got = tdec.decode_attention(q, kv[:, :, 0], kv[:, :, 1], clen,
                                kv_head=slot)
    _close(got, want, DECODE)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hk", [(32, 2), (16, 16)])
def test_decode_kernel_rows_are_batch_invariant(cuda, H, Hk):
    """A row's output is bitwise the same in a B=1 call as in a B=4 call,
    whatever the other rows' lengths (a request moves between decode
    tiers 4/2/1 on compaction)."""
    S, hd = 4096, 128
    lens = [2999, 4096, 1500, 17]
    q, kc, vc, slot, clen = _decode_inputs(22, cuda, 4, S, H, Hk, hd, lens)
    whole = tdec.decode_attention(q, kc, vc, clen, kv_head=slot)
    for r in range(4):
        row = tdec.decode_attention(q[r:r + 1], kc[r:r + 1], vc[r:r + 1],
                                    clen[r:r + 1], kv_head=slot)
        assert torch.equal(row[0], whole[r])
    other = torch.tensor([lens[0], 5, 4000, 129], dtype=torch.int32,
                         device=cuda)
    again = tdec.decode_attention(q, kc, vc, other, kv_head=slot)
    assert torch.equal(again[0], whole[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4, 7, 4096])
@pytest.mark.parametrize("d", [40, 384, 576, 2048, 2560, 3584, 4096, 7168,
                               8192])
def test_rmsnorm_kernel_at_model_widths(cuda, n, d):
    x, g = _dev(23, cuda, (n, d), (d,))
    k = LAUNCHES["rmsnorm"]
    got = trn.rmsnorm(x, g)
    assert LAUNCHES["rmsnorm"] == k + 1
    _close(got, trn.rmsnorm_plain(x, g), NORM)


@pytest.mark.cuda
@pytest.mark.parametrize("xt", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("gt", [torch.bfloat16, torch.float16, torch.float32])
def test_rmsnorm_kernel_dtypes(cuda, xt, gt):
    """Each pair of x and g types, output in their promoted type."""
    x, g = _dev(24, cuda, (37, 2560), (2560,))
    x, g = x.to(xt), g.to(gt)
    got = trn.rmsnorm(x, g)
    want = trn.rmsnorm_plain(x, g)
    assert got.dtype == want.dtype == torch.promote_types(xt, gt)
    _close(got, want, NORM)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_kernel_reads_strided_rows(cuda, dtype):
    """Rows with a stride: columns of a wider buffer, every other row,
    and a row stride that is not a multiple of 16 bytes (copied)."""
    buf, g = _dev(25, cuda, (64, 2048 + 72), (2048,))
    buf = buf.to(dtype)
    for x in (buf[:, :2048], buf[::2, 8:2056], buf[:, 4:2052]):
        _close(trn.rmsnorm(x, g), trn.rmsnorm_plain(x, g), NORM)


@pytest.mark.cuda
def test_rmsnorm_kernel_refuses_what_it_does_not_take(cuda):
    g = torch.ones((8200,), dtype=torch.bfloat16, device=cuda)
    for d in (44, 8200):
        with pytest.raises(ValueError):
            trn.rmsnorm(torch.ones((4, d), dtype=torch.bfloat16,
                                   device=cuda), g[:d])
    with pytest.raises(TypeError):
        trn.rmsnorm(torch.ones((4, 64), dtype=torch.float64, device=cuda),
                    g[:64])
    with pytest.raises(ValueError):
        trn.rmsnorm(torch.ones((4, 64, 2), dtype=torch.bfloat16,
                               device=cuda)[..., 0], g[:64])


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(7, 576), (4096, 4096), (33, 40)])
def test_norm_kernels_match_plain(cuda, n, d):
    """Both norms against their plain versions; the fused kernel's outputs
    are the same bits at every block_rows (a row's arithmetic does not
    depend on the block that runs it)."""
    x, y, g = _dev(3, cuda, (n, d), (n, d), (d,))
    _close(trn.rmsnorm(x, g), trn.rmsnorm_plain(x, g), NORM)
    s2, h2 = trn.fused_add_rmsnorm_plain(x, y, g)
    first = None
    for br in (1, 32, 128, 256):
        k = LAUNCHES["fused_add_rmsnorm"]
        s, h = trn.fused_add_rmsnorm(x, y, g, block_rows=br)
        assert LAUNCHES["fused_add_rmsnorm"] == k + 1
        _close(s, s2, NORM)
        _close(h, h2, NORM)
        first = first or (s, h)
        assert torch.equal(s, first[0]) and torch.equal(h, first[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n,block_rows", [(4096, 256), (8192, 256),
                                          (8192, 32), (1000, 3)])
def test_fused_kernel_launches_one_block_per_block_rows(cuda, n, block_rows,
                                                        tmp_path):
    """The launch's grid, as the profiler records it: ceil(n / block_rows)
    blocks of the geometry's threads."""
    import json

    from torch.profiler import ProfilerActivity, profile
    x, y, g = _dev(4, cuda, (n, 4096), (n, 4096), (4096,))
    trn.fused_add_rmsnorm(x, y, g, block_rows=block_rows)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trn.fused_add_rmsnorm(x, y, g, block_rows=block_rows)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    grids = [(e["args"].get("grid"), e["args"].get("block")) for e in events
             if e.get("cat") == "kernel" and "fused_kernel" in e.get("name", "")]
    geo = trn.fused_geometry(n, 4096, block_rows)
    assert grids == [([-(-n // block_rows), 1, 1], [geo["threads"], 1, 1])]


@pytest.mark.cuda
@pytest.mark.parametrize("xt", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("gt", [torch.bfloat16, torch.float16, torch.float32])
def test_fused_geometry_follows_the_kernels_caps(cuda, xt, gt):
    """``fused_geometry`` against the library's own caps and layout
    (``repro_fused_add_rmsnorm_info``): the instantiation's cap of
    consumer warps in whole rows (no shape here is held below it by
    shared memory), and the shared memory of the ring as the kernel lays
    it out, within the most a block may take."""
    import ctypes

    from repro_torch.kernels import _build
    info = _build.library().repro_fused_add_rmsnorm_info
    codes = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
    x_bytes = torch.tensor([], dtype=xt).element_size()
    for n, d, br in ((4096, 4096, 256), (8192, 4096, 32), (19, 8, 4),
                     (37, 576, 8), (100, 2560, 7), (64, 8192, 64)):
        geo = trn.fused_geometry(n, d, br, x_bytes=x_bytes,
                                 paired=gt == xt != torch.float32)
        cap, smem, most = ctypes.c_int(), ctypes.c_longlong(), ctypes.c_longlong()
        _build.check(info(codes[xt], codes[gt], geo["packs"], d,
                          geo["stages"], geo["consumer_warps"],
                          ctypes.byref(cap), ctypes.byref(smem),
                          ctypes.byref(most)), "fused_add_rmsnorm info")
        wpr = geo["warps_per_row"]
        assert geo["consumer_warps"] == cap.value // wpr * wpr
        assert geo["smem_bytes"] == smem.value <= most.value
        assert most.value == trn.SMEM_PER_BLOCK


@pytest.mark.cuda
@pytest.mark.parametrize("xt", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("gt", [torch.bfloat16, torch.float16, torch.float32])
def test_fused_kernel_dtypes(cuda, xt, gt):
    """Each pair of x (and y) and g types: s in x's type, h in the
    promoted type (g in f32 makes h f32)."""
    x, y, g = _dev(5, cuda, (37, 2560), (37, 2560), (2560,))
    x, y, g = x.to(xt), y.to(xt), g.to(gt)
    s, h = trn.fused_add_rmsnorm(x, y, g, block_rows=8)
    s2, h2 = trn.fused_add_rmsnorm_plain(x, y, g)
    assert s.dtype == s2.dtype == xt
    assert h.dtype == h2.dtype == torch.promote_types(xt, gt)
    _close(s, s2, NORM)
    _close(h, h2, NORM)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 40, 384, 576, 2048, 3584, 7168, 8192])
def test_fused_kernel_at_widths_and_empty_input(cuda, d):
    """Every pack count at its width, and n == 0: empty outputs of the
    right types and no launch."""
    x, y, g = _dev(6, cuda, (19, d), (19, d), (d,))
    s, h = trn.fused_add_rmsnorm(x, y, g, block_rows=4)
    s2, h2 = trn.fused_add_rmsnorm_plain(x, y, g)
    _close(s, s2, NORM)
    _close(h, h2, NORM)
    k = LAUNCHES["fused_add_rmsnorm"]
    s, h = trn.fused_add_rmsnorm(x[:0], y[:0], g)
    assert s.shape == h.shape == (0, d) and s.dtype == h.dtype == x.dtype
    assert LAUNCHES["fused_add_rmsnorm"] == k


@pytest.mark.cuda
def test_fused_kernel_reads_strided_rows(cuda):
    """x and y as columns of wider buffers with different row strides,
    one of them not a multiple of 16 bytes (copied)."""
    bx, by, g = _dev(7, cuda, (64, 2048 + 72), (64, 2048 + 8), (2048,))
    for x, y in ((bx[:, :2048], by[:, 8:]), (bx[:, 4:2052], by[:, :2048])):
        s, h = trn.fused_add_rmsnorm(x, y, g, block_rows=16)
        s2, h2 = trn.fused_add_rmsnorm_plain(x, y, g)
        _close(s, s2, NORM)
        _close(h, h2, NORM)


@pytest.mark.cuda
def test_fused_kernel_refuses_what_it_does_not_take(cuda):
    g = torch.ones((8200,), dtype=torch.bfloat16, device=cuda)
    for d in (44, 8200):
        x = torch.ones((4, d), dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError):
            trn.fused_add_rmsnorm(x, x, g[:d])
    x = torch.ones((4, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        trn.fused_add_rmsnorm(x, x, g[:64], block_rows=0)
    with pytest.raises(TypeError):
        trn.fused_add_rmsnorm(x, x.float(), g[:64])
    with pytest.raises(TypeError):
        trn.fused_add_rmsnorm(x.double(), x.double(), g[:64])
    with pytest.raises(ValueError):
        trn.fused_add_rmsnorm(x, x[:2], g[:64])


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros((1, 8, 2, 48), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q)              # hd 48
    with pytest.raises(TypeError):
        tfa.flash_attention(q.float(), q.float(), q.float())


def _ffn_weights(seed, dev, E, D, Fd):
    w1, w3, w2 = _dev(seed, dev, (E, D, Fd), (E, D, Fd), (E, Fd, D))
    return ((w1.float() * D ** -0.5).to(torch.bfloat16),
            (w3.float() * D ** -0.5).to(torch.bfloat16),
            (w2.float() * Fd ** -0.5).to(torch.bfloat16))


def _ffn_close(got, x, w1, w3, w2):
    xf = x.float()
    h = F.silu(torch.bmm(xf, w1.float())) * torch.bmm(xf, w3.float())
    _close(got, tgm.grouped_ffn_plain(x, w1, w3, w2), GFFN,
           pv=torch.bmm(h.abs(), w2.float().abs()))


@pytest.mark.cuda
@pytest.mark.parametrize("E,N,D,Fd", [
    (64, 480, 2048, 1408), (64, 4, 2048, 1408), (3, 100, 256, 192),
    (2, 1, 128, 64)])
def test_grouped_ffn_kernel_matches_plain(cuda, E, N, D, Fd):
    x = _dev(5, cuda, (E, N, D))[0]
    w1, w3, w2 = _ffn_weights(6, cuda, E, D, Fd)
    n = LAUNCHES["grouped_ffn"]
    got = tgm.grouped_ffn(x, w1, w3, w2)
    assert LAUNCHES["grouped_ffn"] == n + 1
    _ffn_close(got, x, w1, w3, w2)


@pytest.mark.cuda
@pytest.mark.parametrize("Fd", [192, 1408])
@pytest.mark.parametrize("N", [1, 63, 64, 65, 127, 128, 129])
def test_grouped_ffn_kernel_at_tile_edges(cuda, N, Fd):
    """Rows either side of the kernel's 64-row (decode) and 128-row
    (prefill) tiles; F = 192 ends in half a 128-wide gate-up tile."""
    E, D = 3, 256
    x = _dev(14, cuda, (E, N, D))[0]
    w1, w3, w2 = _ffn_weights(15, cuda, E, D, Fd)
    _ffn_close(tgm.grouped_ffn(x, w1, w3, w2), x, w1, w3, w2)


@pytest.mark.cuda
def test_grouped_ffn_kernel_reads_a_comet_chunk_bitwise(cuda):
    """deepseek-moe-16b's Comet chunk: N=120 rows read in place from the
    480-row dispatch buffer come out bitwise equal to the same rows of
    the whole buffer's result."""
    E, C, D, Fd = 8, 480, 2048, 1408
    buf = _dev(16, cuda, (E, C, D))[0]
    w1, w3, w2 = _ffn_weights(17, cuda, E, D, Fd)
    whole = tgm.grouped_ffn(buf, w1, w3, w2)
    for c0 in range(0, C, 120):
        chunk = buf[:, c0:c0 + 120]
        got = tgm.grouped_ffn(chunk, w1, w3, w2)
        assert torch.equal(got, whole[:, c0:c0 + 120])
    _ffn_close(whole, buf, w1, w3, w2)


@pytest.mark.cuda
def test_grouped_ffn_kernel_reads_chunks_in_place_and_keeps_zero_rows(cuda):
    """A Comet chunk is a strided view of the dispatch buffer; unfilled
    capacity rows (zeros) come out as zeros."""
    E, C, D, Fd = 4, 200, 256, 128
    buf = _dev(7, cuda, (E, C, D))[0]
    buf[:, 150:] = 0
    w1, w3, w2 = _ffn_weights(8, cuda, E, D, Fd)
    chunk = buf[:, 100:200]
    got = tgm.grouped_ffn(chunk, w1, w3, w2)
    _ffn_close(got, chunk.contiguous(), w1, w3, w2)
    assert not got[:, 50:].any()
    whole = tgm.grouped_ffn(buf, w1, w3, w2)
    assert torch.equal(whole[:, 100:200], got)


@pytest.mark.cuda
def test_grouped_ffn_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((2, 8, 96), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((2, 96, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        tgm.grouped_ffn(x, w, w, w.transpose(1, 2))      # D 96
    with pytest.raises(TypeError):
        tgm.grouped_ffn(x.float(), w.float(), w.float(),
                        w.transpose(1, 2).float())


def _ssd_inputs(seed, dev, b, L, H, P, G, N):
    """x, B, C as column views of one post-conv buffer (the model's
    layout); dt = softplus(n - 3) (a Mamba2-like step size), A in
    [-16, -0.1], D ~ 1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ch = H * P + 2 * G * N
    xbc = (torch.randn((b, L, ch), generator=g, device=dev) * 0.5) \
        .to(torch.bfloat16)
    x = xbc[..., :H * P].unflatten(-1, (H, P))
    B = xbc[..., H * P:H * P + G * N].unflatten(-1, (G, N))
    C = xbc[..., H * P + G * N:].unflatten(-1, (G, N))
    dt = F.softplus(torch.randn((b, L, H), generator=g, device=dev) - 3.0)
    A = -torch.exp(torch.rand((H,), generator=g, device=dev) * 5.1 - 2.3)
    D = 1.0 + 0.1 * torch.randn((H,), generator=g, device=dev)
    return x, dt, A, B, C, D


@pytest.mark.cuda
@pytest.mark.parametrize("b,L,H,G,N,chunk", [
    (2, 256, 8, 1, 128, 128), (1, 200, 4, 2, 64, 128), (2, 48, 4, 1, 64, 16),
    (1, 37, 2, 1, 128, 128), (3, 128, 4, 4, 64, 64),
    # mamba2-2.7b's geometry at one row; chunks that are no multiple of 16
    (1, 2048, 80, 1, 128, 128), (2, 40, 4, 1, 64, 128),
    (1, 120, 8, 2, 128, 40),
    # more (batch, head) chains than SMs: blocks hand states on
    (2, 768, 80, 1, 128, 128), (3, 256, 64, 1, 64, 128)])
def test_ssd_scan_kernel_matches_plain(cuda, b, L, H, G, N, chunk):
    x, dt, A, B, C, D = _ssd_inputs(9, cuda, b, L, H, 64, G, N)
    n = LAUNCHES["ssd_scan"]
    got = tssd.ssd_scan(x, dt, A, B, C, D, chunk=chunk)
    assert LAUNCHES["ssd_scan"] == n + 1
    _close(got, tssd.ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk), SSD)


@pytest.mark.cuda
def test_ssd_scan_kernel_reads_views_and_is_batch_invariant(cuda):
    """Strided x/B/C views, a one-row micro-batch view (NanoFlow's split)
    and b = 1 give each row exactly what the whole batch gives it."""
    x, dt, A, B, C, D = _ssd_inputs(10, cuda, 2, 384, 8, 64, 1, 128)
    whole = tssd.ssd_scan(x, dt, A, B, C, D)
    _close(whole, tssd.ssd_scan_plain(x.contiguous(), dt, A, B.contiguous(),
                                      C.contiguous(), D), SSD)
    for r in range(2):
        row = tssd.ssd_scan(x[r:r + 1], dt[r:r + 1], A, B[r:r + 1],
                            C[r:r + 1], D)
        assert torch.equal(row[0], whole[r])


@pytest.mark.cuda
def test_ssd_scan_kernel_rows_are_bitwise_the_same_at_every_batch(cuda):
    """mamba2-2.7b's heads at b = 4 (320 (batch, head) chains, so blocks
    hand chains' states on to each other) against b = 2 and b = 1 calls
    on the same rows: bitwise equal, and again on a second call (the
    workspace's flags are left at zero)."""
    x, dt, A, B, C, D = _ssd_inputs(12, cuda, 4, 512, 80, 64, 1, 128)
    whole = tssd.ssd_scan(x, dt, A, B, C, D)
    _close(whole, tssd.ssd_scan_plain(x, dt, A, B, C, D), SSD)
    assert torch.equal(tssd.ssd_scan(x, dt, A, B, C, D), whole)
    for r0, r1 in ((0, 2), (2, 4), (3, 4)):
        part = tssd.ssd_scan(x[r0:r1], dt[r0:r1], A, B[r0:r1], C[r0:r1], D)
        assert torch.equal(part, whole[r0:r1])


@pytest.mark.cuda
def test_ssd_scan_kernel_refuses_what_it_does_not_take(cuda):
    x, dt, A, B, C, D = _ssd_inputs(11, cuda, 1, 32, 4, 64, 1, 64)
    with pytest.raises(ValueError):
        tssd.ssd_scan(x[..., :32], dt, A, B, C, D)          # P 32
    with pytest.raises(ValueError):
        tssd.ssd_scan(x, dt, A, B[..., :32], C[..., :32], D)   # N 32
    with pytest.raises(TypeError):
        tssd.ssd_scan(x.float(), dt, A, B.float(), C.float(), D)


def _at_8_bytes(t):
    """t's values in a contiguous tensor that starts 8 bytes into its
    storage (``.contiguous()`` hands such a tensor back unchanged)."""
    off = 8 // t.element_size()
    flat = torch.zeros(t.numel() + off, dtype=t.dtype, device=t.device)
    v = flat[off:].view(t.shape)
    v.copy_(t)
    assert v.is_contiguous() and v.data_ptr() % 16 == 8
    return v


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention",
                                    "rmsnorm", "fused_add_rmsnorm",
                                    "grouped_ffn", "ssd_scan"])
def test_kernels_realign_an_operand_at_an_8_byte_offset(cuda, kernel):
    """Each CUDA kernel given contiguous operands 8 bytes off a 16-byte
    boundary: the wrapper copies them to an aligned base, the kernel
    launches, and the result matches the plain version."""
    n = LAUNCHES[kernel]
    if kernel == "flash_attention":
        q, k, v = _dev(30, cuda, (1, 130, 4, 128), (1, 130, 2, 128),
                       (1, 130, 2, 128))
        slot = torch.tensor([0, 0, 1, 1], dtype=torch.int32, device=cuda)
        got = tfa.flash_attention(_at_8_bytes(q), _at_8_bytes(k),
                                  _at_8_bytes(v), kv_head=slot)
        _flash_close(got, q, k, v, kv_head=slot)
    elif kernel == "decode_attention":
        q, kc, vc, slot, clen = _decode_inputs(31, cuda, 2, 700, 4, 2, 128,
                                               (700, 33))
        got = tdec.decode_attention(_at_8_bytes(q), _at_8_bytes(kc),
                                    _at_8_bytes(vc), clen, kv_head=slot)
        _close(got, tdec.decode_attention_plain(q, kc, vc, clen,
                                                kv_head=slot), DECODE)
    elif kernel == "rmsnorm":
        x, g = _dev(32, cuda, (64, 2048), (2048,))
        got = trn.rmsnorm(_at_8_bytes(x), _at_8_bytes(g))
        _close(got, trn.rmsnorm_plain(x, g), NORM)
    elif kernel == "fused_add_rmsnorm":
        x, y, g = _dev(36, cuda, (64, 2048), (64, 2048), (2048,))
        s, h = trn.fused_add_rmsnorm(_at_8_bytes(x), _at_8_bytes(y),
                                     _at_8_bytes(g), block_rows=16)
        s2, h2 = trn.fused_add_rmsnorm_plain(x, y, g)
        _close(s, s2, NORM)
        _close(h, h2, NORM)
    elif kernel == "grouped_ffn":
        x = _dev(33, cuda, (2, 40, 256))[0]
        w1, w3, w2 = _ffn_weights(34, cuda, 2, 256, 128)
        got = tgm.grouped_ffn(_at_8_bytes(x), _at_8_bytes(w1), w3,
                              _at_8_bytes(w2))
        _ffn_close(got, x, w1, w3, w2)
    else:
        x, dt, A, B, C, D = (t.contiguous() for t in _ssd_inputs(
            35, cuda, 2, 256, 4, 64, 1, 128))
        got = tssd.ssd_scan(_at_8_bytes(x), dt, A, _at_8_bytes(B),
                            _at_8_bytes(C), D)
        _close(got, tssd.ssd_scan_plain(x, dt, A, B, C, D), SSD)
    assert LAUNCHES[kernel] == n + 1
