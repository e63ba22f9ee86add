"""The port's roofline model and its meta-device counter
(``repro_torch.roofline.model``, ``roofline.count``, ``kernels/cost.py``)
against known answers: the counterparts of ``tests/test_roofline.py``'s
known answers, ``wire_bytes`` and ``roofline_terms`` against the JAX
package's at H100 figures, and each hand-written kernel's meta route
(rows 1-12 of the kernel table), forward and through autograd, against
its plain version's shapes and dtypes and ``kernels/cost.py``'s count."""
import math

import pytest
import torch

from repro.roofline import model as jmodel
from repro_torch import hw
from repro_torch.dist import collectives as col
from repro_torch.kernels import LAUNCHES, cost
from repro_torch.kernels import adamw as kadamw
from repro_torch.kernels import decode_attention as kda
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import grouped_matmul as kgm
from repro_torch.kernels import rmsnorm as krn
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.roofline.count import Counter, analyze
from repro_torch.roofline.model import (RING_FACTOR, roofline_terms,
                                        wire_bytes)

BF16, F32 = torch.bfloat16, torch.float32


def meta(*shape, dtype=F32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


@pytest.fixture
def model_axis():
    """'model' bound to a four-rank recorder at index 0."""
    col.bind_axis("model", col.Recorder(4))
    try:
        yield
    finally:
        col.bind_axis("model", None)


# ---------------------------------------------------------------------------
# known answers (tests/test_roofline.py:14-126)
# ---------------------------------------------------------------------------


def test_dot_flops_exact():
    """A known matmul: 2*M*N*K FLOPs, its operands and result once."""
    M, K, N = 64, 32, 48
    r = analyze(lambda a, b: a @ b, meta(M, K), meta(K, N))
    assert r["flops"] == 2 * M * N * K
    assert r["hbm_bytes"] == 4 * (M * K + K * N + M * N)


@pytest.mark.parametrize("fn", ["linear", "einsum", "addmm", "bmm"])
def test_matmul_family_flops(fn):
    """``linear``, ``einsum`` and the rest reach the counter as its
    matmul ops: 2 x result x contraction each, a bias adds none."""
    B, M, K, N = 3, 16, 8, 24
    x, w, bias = meta(B, M, K), meta(N, K), meta(N)
    run = {"linear": lambda: torch.nn.functional.linear(x, w, bias),
           "einsum": lambda: torch.einsum("bmk,nk->bmn", x, w),
           "addmm": lambda: torch.addmm(bias, x[0], w.t()),
           "bmm": lambda: torch.bmm(x, w.t().expand(B, K, N))}[fn]
    want = 2 * M * N * K * (1 if fn == "addmm" else B)
    assert analyze(run)["flops"] == want


def test_python_loop_multiplies():
    """A Python loop of 7 matmuls counts 7x the body's FLOPs (the
    counterpart of a while loop's trip count)."""
    M = 32

    def f(x, w):
        for _ in range(7):
            x = torch.tanh(x @ w)
        return x
    assert analyze(f, meta(M, M), meta(M, M))["flops"] == 7 * 2 * M ** 3


def test_elementwise_counts_no_flops():
    r = analyze(lambda a, b: torch.exp(a) * b + 1.0, meta(8, 16), meta(8, 16))
    assert r["flops"] == 0
    # exp, mul, add: each reads its operands and writes its result
    assert r["hbm_bytes"] == 4 * 8 * 16 * (2 + 3 + 2)


def test_collective_bytes_psum(model_axis):
    """A psum charges its result's bytes as ``all-reduce``."""
    r = analyze(lambda x: col.psum(x, "model"), meta(16, 128))
    assert r["collectives"]["all-reduce"] == 16 * 128 * 4
    assert r["collectives"]["total"] == 16 * 128 * 4
    assert r["n_collectives"] == 1
    assert r["hbm_bytes"] == 0


def test_collectives_inside_loop_multiply(model_axis):
    """Five all-gathers in a loop: five times the gathered bytes."""
    def f(x):
        for _ in range(5):
            x = col.all_gather(x, "model")[:8]
        return x
    r = analyze(f, meta(8))
    assert r["collectives"]["all-gather"] == 5 * 4 * 8 * 4
    assert r["n_collectives"] == 5


@pytest.mark.parametrize("kind", ["psum", "pmax", "all_gather",
                                  "reduce_scatter", "all_to_all",
                                  "ppermute", "compressed_psum"])
def test_recorder_records_each_kind(model_axis, kind):
    """Each collective's result has the shape a four-rank group gives and
    its bytes go under the JAX package's name for it."""
    x = meta(8, 12, dtype=BF16)
    run = {"psum": (lambda: col.psum(x, "model"), (8, 12), "all-reduce"),
           "pmax": (lambda: col.pmax(x, "model"), (8, 12), "all-reduce"),
           "all_gather": (lambda: col.all_gather(x, "model", dim=1),
                          (8, 48), "all-gather"),
           "reduce_scatter": (lambda: col.reduce_scatter(x, "model"),
                              (2, 12), "reduce-scatter"),
           "all_to_all": (lambda: col.all_to_all(x, "model", 0, 1),
                          (2, 48), "all-to-all"),
           "ppermute": (lambda: col.ppermute(x, "model", [(0, 1), (1, 0)]),
                        (8, 12), "collective-permute"),
           "compressed_psum": (lambda: col.compressed_psum(x, "model")[0],
                               (8, 12), "all-reduce")}
    fn, shape, name = run[kind]
    box = {}
    r = analyze(lambda: box.setdefault("out", fn()))
    assert tuple(box["out"].shape) == shape
    if kind == "compressed_psum":
        # the pmax'd scale (f32 scalar) and the int32 codes
        assert r["collectives"] == {"all-reduce": 4 + 4 * 8 * 12,
                                    "total": 4 + 4 * 8 * 12}
        assert r["n_collectives"] == 2
    else:
        nbytes = 2 * math.prod(shape)
        assert r["collectives"] == {name: nbytes, "total": nbytes}
        assert r["n_collectives"] == 1


def test_recorder_backward_records_the_transpose(model_axis):
    """A collective's backward is recorded like a forward one: an
    all_gather's gradient is a reduce-scatter."""
    def f(x):
        col.all_gather(x, "model", dim=0).sum().backward()
    r = analyze(f, meta(8, 4, grad=True))
    assert r["collectives"] == {"all-gather": 4 * 32 * 4,
                                "reduce-scatter": 4 * 8 * 4,
                                "total": 4 * 40 * 4}


def test_one_rank_recorder_is_the_identity():
    """Over one rank a collective is recorded and hands back its operand,
    as an unbound axis does on the card: no storage of its own."""
    col.bind_axis("model", col.Recorder(1))
    try:
        box = {}
        x = meta(16, 8, dtype=BF16)
        r = analyze(lambda: box.setdefault("out", col.psum(x, "model")))
    finally:
        col.bind_axis("model", None)
    assert box["out"].untyped_storage() is x.untyped_storage()
    assert r["collectives"] == {"all-reduce": 2 * 16 * 8,
                                "total": 2 * 16 * 8}
    assert r["n_collectives"] == 1 and r["peak_bytes"] == 0


def test_counters_do_not_nest():
    """One counter counts at a time, and none is current after it."""
    with Counter() as outer:
        assert Counter.current is outer
        with pytest.raises(RuntimeError):
            with Counter():
                pass
    assert Counter.current is None


def test_recorder_gives_the_ranks_coordinate():
    col.bind_axis("data", col.Recorder(16, 3))
    try:
        assert col.axis_index("data") == 3 and col.axis_size("data") == 16
    finally:
        col.bind_axis("data", None)
    assert col.axis_index("data") == 0 and col.axis_size("data") == 1


def test_narrow_inplace_copy_charged_as_update():
    """Four rows written in place into a (1024, 64) cache cost twice the
    rows, not the buffer."""
    S, d = 1024, 64

    def f(cache, xs):
        for i in range(4):
            cache[i:i + 1].copy_(xs[i:i + 1])
        cache.index_copy_(0, torch.arange(2, device="meta"), xs[:2])
    r = analyze(f, meta(S, d), meta(4, d))
    assert r["hbm_bytes"] == 2 * 4 * d * 4 + (2 * 2 * d * 4 + 2 * 8)
    assert r["hbm_bytes"] < S * d * 4
    assert r["peak_bytes"] == 2 * 8          # only the index is new


def test_views_charge_nothing():
    r = analyze(lambda x: x.view(-1).reshape(8, -1).t().expand(2, -1, -1)
                .unsqueeze(0).detach()[..., 1:], meta(16, 4))
    assert r["hbm_bytes"] == 0 and r["flops"] == 0 and r["peak_bytes"] == 0


def test_peak_bytes_counts_live_storages():
    """Temporaries freed along the way do not add up; views add nothing."""
    def f(x):
        a = x * 2                       # 4 KB live
        b = a + 1                       # 8 KB
        del a                           # 4 KB
        c = b.view(-1)[:10]             # a view: 4 KB
        return (c * 3).sum()            # 4 KB + 40 B, then + 4 B
    r = analyze(f, meta(32, 32))
    assert r["peak_bytes"] == 2 * 32 * 32 * 4


# ---------------------------------------------------------------------------
# the roofline model, against the JAX package's at H100 figures
# ---------------------------------------------------------------------------


def test_roofline_terms_math():
    """``tests/test_roofline.py:128-146`` at the H100's figures."""
    rl = roofline_terms(
        arch="a", shape="s", mesh="m", chips=256,
        hlo_flops=9.89e12,                    # 10 ms of compute
        hlo_bytes=3.35e10,                    # 10 ms of HBM
        coll_payload={"all-reduce": 1e9, "total": 1e9},
        n_params=1e9, n_active=1e9, tokens=1e6, train=True, axis_size=16)
    assert abs(rl.t_compute - 0.01) < 1e-9
    assert abs(rl.t_memory - 0.01) < 1e-9
    want_wire = 1e9 * 2.0 * 15 / 16
    assert abs(rl.t_collective - want_wire / (18 * 25e9)) < 1e-12
    assert rl.bottleneck in ("compute", "memory", "collective")
    assert rl.t_bound == max(rl.t_compute, rl.t_memory, rl.t_collective)
    assert rl.to_json()["t_total_seq"] == rl.t_total_seq


def test_wire_bytes_ring_factors():
    w = wire_bytes({"all-reduce": 100, "all-gather": 100,
                    "all-to-all": 100}, axis_size=4)
    assert abs(w - (200 * 0.75 + 100 * 0.75 + 25 * 0.75)) < 1e-9
    assert RING_FACTOR == jmodel.RING_FACTOR


PAYLOADS = [{"all-reduce": 1e9, "total": 1e9},
            {"all-gather": 3e6, "reduce-scatter": 5e6, "all-to-all": 7e6,
             "collective-permute": 11e6, "total": 26e6},
            {"all-reduce": 640, "all-gather": 96, "mystery": 8,
             "total": 744}]


@pytest.mark.parametrize("axis_size", [1, 2, 4, 16])
@pytest.mark.parametrize("payload", PAYLOADS)
def test_wire_bytes_equal_the_references(payload, axis_size):
    assert wire_bytes(payload, axis_size) == \
        jmodel.wire_bytes(payload, axis_size)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("payload", PAYLOADS)
def test_roofline_terms_equal_the_references(payload, train):
    """The same counts give the same model FLOPs, useful ratio and
    bottleneck rule; each term times its peak is the same count."""
    from repro import hw as jhw
    kw = dict(arch="a", shape="s", mesh="pod16x16", chips=256,
              hlo_flops=3.7e10, hlo_bytes=1.2e10, coll_payload=payload,
              n_params=3.1e11, n_active=8.6e10, tokens=128.0, train=train,
              axis_size=16)
    got, want = roofline_terms(**kw), jmodel.roofline_terms(**kw)
    assert got.model_flops == want.model_flops
    assert got.useful_ratio == want.useful_ratio
    assert math.isclose(got.t_compute * hw.PEAK_FLOPS_BF16,
                        want.t_compute * jhw.PEAK_FLOPS_BF16)
    assert math.isclose(got.t_memory * hw.HBM_BW, want.t_memory * jhw.HBM_BW)
    assert math.isclose(
        got.t_collective * hw.NVLINK_LINKS * hw.NVLINK_BW_PER_LINK,
        want.t_collective * jhw.ICI_LINKS_PER_CHIP * jhw.ICI_BW_PER_LINK)
    assert set(got.to_json()) == set(want.to_json())


# ---------------------------------------------------------------------------
# each kernel's meta route
# ---------------------------------------------------------------------------


def _kv_head(H, Hk):
    return (torch.arange(H) // (H // Hk)).to(torch.int32).to("meta")


def _ssd_args(b, L, H, P, G, N):
    return (meta(b, L, H, P, dtype=BF16), meta(b, L, H), meta(H),
            meta(b, L, G, N, dtype=BF16), meta(b, L, G, N, dtype=BF16),
            meta(H))


def _cases():
    """name -> (kernel call, plain call, the cost it must charge)."""
    q, k, v = (meta(2, 64, 8, 64, dtype=BF16), meta(2, 64, 2, 64, dtype=BF16),
               meta(2, 64, 2, 64, dtype=BF16))
    kvh = _kv_head(8, 2)
    o, do, lse = meta(2, 64, 8, 64, dtype=BF16), \
        meta(2, 64, 8, 64, dtype=BF16), meta(2, 8, 64)
    qd, kc, vc = (meta(3, 1, 8, 64, dtype=BF16),
                  meta(3, 128, 2, 64, dtype=BF16),
                  meta(3, 128, 2, 64, dtype=BF16))
    clen = torch.empty(3, dtype=torch.int32, device="meta")
    x, y, g = meta(40, 96, dtype=BF16), meta(40, 96, dtype=BF16), \
        meta(96, dtype=BF16)
    gf = meta(96)
    ex, w1, w3, w2 = (meta(4, 16, 32, dtype=BF16), meta(4, 32, 48, dtype=BF16),
                      meta(4, 32, 48, dtype=BF16), meta(4, 48, 32, dtype=BF16))
    h = meta(4, 16, 48, dtype=BF16)
    sa = _ssd_args(2, 256, 4, 64, 2, 16)
    dy = meta(2, 256, 4, 64, dtype=BF16)
    ps = [meta(5, 7, dtype=BF16), meta(9)]
    gs = [meta(5, 7, dtype=BF16), meta(9)]
    ms, vs = [meta(5, 7), meta(9)], [meta(5, 7), meta(9)]
    sc = dict(lr=meta(), scale=meta(), c1=meta(), c2=meta(), b1=0.9,
              b2=0.95, eps=1e-8, weight_decay=0.1)
    return {
        "flash_attention": (
            lambda: kfa.flash_attention(q, k, v, kv_head=kvh),
            lambda: kfa.flash_attention_plain(q, k, v, kv_head=kvh),
            cost.flash_attention(2, 64, 64, 8, 2, 64)),
        "flash_attention non-causal": (
            lambda: kfa.flash_attention(q, k, v, causal=False, kv_head=kvh),
            lambda: kfa.flash_attention_plain(q, k, v, causal=False,
                                              kv_head=kvh),
            cost.flash_attention(2, 64, 64, 8, 2, 64, causal=False)),
        "decode_attention": (
            lambda: kda.decode_attention(qd, kc, vc, clen, kv_head=kvh),
            lambda: kda.decode_attention_plain(qd, kc, vc, clen,
                                               kv_head=kvh),
            cost.decode_attention([128] * 3, 8, 2, 64)),
        "rmsnorm": (lambda: krn.rmsnorm(x, g), lambda: krn.rmsnorm_plain(x, g),
                    cost.rmsnorm(40, 96)),
        "rmsnorm f32 g": (lambda: krn.rmsnorm(x, gf),
                          lambda: krn.rmsnorm_plain(x, gf),
                          cost.rmsnorm(40, 96, g_esize=4, out_esize=4)),
        "fused_add_rmsnorm": (
            lambda: krn.fused_add_rmsnorm(x, y, g),
            lambda: krn.fused_add_rmsnorm_plain(x, y, g),
            cost.fused_add_rmsnorm(40, 96)),
        "grouped_ffn": (lambda: kgm.grouped_ffn(ex, w1, w3, w2),
                        lambda: kgm.grouped_ffn_plain(ex, w1, w3, w2),
                        cost.grouped_ffn(4, 16, 32, 48)),
        "ssd_scan": (lambda: kssd.ssd_scan(*sa, chunk=128),
                     lambda: kssd.ssd_scan_plain(*sa, chunk=128),
                     cost.ssd_scan(2, 256, 4, 64, 2, 16, 128)),
        "flash_attention_bwd": (
            lambda: kfa.flash_attention_bwd(q, k, v, o, do, lse,
                                            kv_head=kvh),
            lambda: kfa.flash_attention_bwd_plain(q, k, v, o, do, lse,
                                                  kv_head=kvh),
            cost.flash_attention_bwd(2, 64, 64, 8, 2, 64)),
        "rmsnorm_bwd": (lambda: krn.rmsnorm_bwd(x, g, y),
                        lambda: krn.rmsnorm_bwd_plain(x, g, y),
                        cost.rmsnorm_bwd(40, 96)),
        "fused_add_rmsnorm_bwd": (
            lambda: krn.fused_add_rmsnorm_bwd(x, g, y, x),
            lambda: krn.fused_add_rmsnorm_bwd_plain(x, g, y, x),
            cost.fused_add_rmsnorm_bwd(40, 96)),
        "adamw": (lambda: kadamw.adamw(ps, gs, ms, vs, **sc),
                  lambda: kadamw.adamw_plain(ps, gs, ms, vs, **sc),
                  cost.adamw([(35, 2, 2), (9, 4, 4)])),
        "grouped_ffn_gate_bwd": (
            lambda: kgm.grouped_ffn_gate_bwd(h, h, h),
            lambda: kgm.grouped_ffn_gate_bwd_plain(h, h, h),
            cost.grouped_ffn_gate_bwd(4 * 16 * 48)),
        "ssd_scan_bwd": (lambda: kssd.ssd_scan_bwd(*sa, dy, chunk=128),
                         lambda: kssd.ssd_scan_bwd_plain(*sa, dy, chunk=128),
                         cost.ssd_scan_bwd(2, 256, 4, 64, 2, 16, 128)),
    }


def _specs(out):
    if out is None:
        return None
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.dtype, out.device.type)
    return [_specs(o) for o in out]


@pytest.mark.parametrize("name", list(_cases()))
def test_meta_route_shapes_and_charge(name):
    """The meta route gives the plain version's shapes and dtypes on
    ``meta``, launches nothing, and charges exactly the kernel's count:
    the plain version (whose matmuls and temporaries would be counted)
    never runs."""
    kernel, plain, want = _cases()[name]
    launches = dict(LAUNCHES)
    counter = Counter()
    with counter:
        got = kernel()
    assert dict(LAUNCHES) == launches
    assert _specs(got) == _specs(plain())
    r = counter.result()
    assert r["flops"] == want.dot_flops
    assert r["hbm_bytes"] == want.nbytes
    # the products the kernel skips (causal attention's masked half)
    assert counter.masked_flops == max(0.0, want.dot_flops - want.flops)
    assert list(counter.kernels) == [name.split()[0]]
    # outside a counter the route charges nothing and still answers
    assert _specs(kernel()) == _specs(got)


def _grad_case(name):
    """(forward on requires-grad meta leaves, the leaves, the kernels its
    forward and backward must reach)."""
    if name == "flash_attention":
        q, k, v = (meta(2, 64, 8, 64, dtype=BF16, grad=True),
                   meta(2, 64, 2, 64, dtype=BF16, grad=True),
                   meta(2, 64, 2, 64, dtype=BF16, grad=True))
        return (lambda: kfa.flash_attention(q, k, v, kv_head=_kv_head(8, 2)),
                (q, k, v), ["flash_attention", "flash_attention_bwd"])
    if name == "rmsnorm":
        x, g = meta(40, 96, dtype=BF16, grad=True), meta(96, dtype=BF16,
                                                         grad=True)
        return lambda: krn.rmsnorm(x, g), (x, g), ["rmsnorm", "rmsnorm_bwd"]
    if name == "fused_add_rmsnorm":
        x, y, g = (meta(40, 96, dtype=BF16, grad=True),
                   meta(40, 96, dtype=BF16, grad=True),
                   meta(96, dtype=BF16, grad=True))
        return (lambda: krn.fused_add_rmsnorm(x, y, g)[1], (x, y, g),
                ["fused_add_rmsnorm", "fused_add_rmsnorm_bwd"])
    if name == "grouped_ffn":
        ins = (meta(4, 16, 32, dtype=BF16, grad=True),
               meta(4, 32, 48, dtype=BF16, grad=True),
               meta(4, 32, 48, dtype=BF16, grad=True),
               meta(4, 48, 32, dtype=BF16, grad=True))
        return (lambda: kgm.grouped_ffn(*ins), ins,
                ["grouped_ffn", "grouped_ffn_gate_bwd"])
    args = list(_ssd_args(2, 256, 4, 64, 2, 16))
    for i in range(6):
        args[i] = args[i].requires_grad_()
    return (lambda: kssd.ssd_scan(*args, chunk=128), tuple(args),
            ["ssd_scan", "ssd_scan_bwd"])


@pytest.mark.parametrize("name", ["flash_attention", "rmsnorm",
                                  "fused_add_rmsnorm", "grouped_ffn",
                                  "ssd_scan"])
def test_autograd_on_meta_reaches_backward_kernels(name):
    """Autograd through the kernels' autograd Functions on ``meta``
    reaches the backward kernels' meta routes, once each, and every
    gradient has its leaf's shape and dtype."""
    fwd, leaves, kernels = _grad_case(name)
    counter = Counter()
    with counter:
        out = fwd()
        out.backward(torch.empty_like(out))
    assert sorted(counter.kernels) == sorted(kernels)
    assert all(counter.kernels[k][0] == 1 for k in kernels)
    for t in leaves:
        assert t.grad is not None
        assert (t.grad.shape, t.grad.dtype) == (t.shape, t.dtype)
