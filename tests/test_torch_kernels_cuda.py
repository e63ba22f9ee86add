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
  decode  atol 1e-3, rtol 1e-2, l2 1e-2: f32 throughout, only the output
          is rounded (1 ulp < 1e-2 relative)
  norms   atol 1e-3, rtol 1.6e-2, l2 4e-3: f32 sums; x*rsqrt rounded to
          bf16, then *g rounded (2 ulps)
"""
import pytest
import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import rmsnorm as trn

FLASH = dict(atol=0.0, pv=2 ** -8, rtol=2 ** -7, l2=1e-2)
DECODE = dict(atol=1e-3, rtol=1e-2, l2=1e-2)
NORM = dict(atol=1e-3, rtol=1.6e-2, l2=4e-3)


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
    (2, 96, 160, 4, 1, 64, False), (1, 130, 70, 2, 2, 128, True)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(7, 576), (4096, 4096), (33, 40)])
def test_norm_kernels_match_plain(cuda, n, d):
    x, y, g = _dev(3, cuda, (n, d), (n, d), (d,))
    _close(trn.rmsnorm(x, g), trn.rmsnorm_plain(x, g), NORM)
    for br in (1, 128, 256):
        s, h = trn.fused_add_rmsnorm(x, y, g, block_rows=br)
        s2, h2 = trn.fused_add_rmsnorm_plain(x, y, g)
        _close(s, s2, NORM)
        _close(h, h2, NORM)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros((1, 8, 2, 48), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q)              # hd 48
    with pytest.raises(TypeError):
        tfa.flash_attention(q.float(), q.float(), q.float())
