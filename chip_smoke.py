#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Runs chatglm3-6b at its full published width and depth (28 layers,
d_model 4096, 32 q / 2 kv heads, d_ff 13696, vocab 65024; ~6.2 B random
bf16 parameters drawn from a seeded ``torch.Generator`` on the card) in
four phases, each printing one JSON line:

  kernels   build the CUDA kernels from ``src/repro_torch/kernels/csrc``
            and hold each Hopper kernel against its plain PyTorch version
            at the main path's shapes; time kernel, plain version and the
            one-call PyTorch yardstick where there is one
  reference a 2-layer cut of the model at full width on the GPU (kernels)
            against the same program on the CPU (plain versions)
  transparency
            ``Program.prefill(2, 2048)`` under ``dynamic`` against
            ``sequential`` on the same params and inputs: dynamic
            resolves to TokenWeave, whose fused add+RMSNorm replaces each
            layer's [reduce-scatter -> add -> RMSNorm] chain
  serve     ``compile("chatglm3-6b").serve`` answers 4 requests (prompts
            of ~17, 300, 1000 and 2000 tokens, 16 greedy tokens each):
            the main path

Launch counts are zeroed just before the serve run and read just after;
the ``kernels`` line reports them (null when the serve phase did not run).

Usage:  python3 chip_smoke.py [--phases kernels,reference,transparency,serve]
        (add ``profile`` for a torch.profiler breakdown of a warm prefill
        and a window of decode steps)
Exits non-zero, printing no result, without a CUDA device or without the
repository's ``src/repro_torch`` beside this file.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12      # H100 SXM data sheet, dense bf16
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
# Each kernel against its plain version on the same bf16 inputs: every
# element within atol + rtol*|plain| (+ pv*P|V| for flash), and the
# relative L2 error within l2.
TOL = {
    # the kernel rounds each probability to bf16 for the PV product
    # (2^-9 relative), which moves an output by at most 2^-9 * sum p|v|
    # = 2^-9 * P|V| (the plain attention of |v|): pv is that with a
    # factor 2, rtol one output ulp; a 64-key tile dropped from a
    # 1000-key row moves its outputs by ~25% of their RMS
    "flash_attention": dict(atol=0.0, pv=2 ** -8, rtol=2 ** -7, l2=1e-2),
    # f32 throughout, only the output rounded: 1 ulp < 1e-2 relative;
    # outputs have RMS 0.026 (4096 keys) to 0.24 (17 keys), and one
    # 512-key split dropped moves them by ~1e-2
    "decode_attention": dict(atol=1e-3, rtol=1e-2, l2=1e-2),
    # f32 sums; x*rsqrt rounded to bf16, then *g rounded: 2 ulps
    "rmsnorm": dict(atol=1e-3, rtol=1.6e-2, l2=4e-3),
    "fused_add_rmsnorm": dict(atol=1e-3, rtol=1.6e-2, l2=4e-3),
}
SEED = 0


def log(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def compare(name, pairs, pv=None):
    """Max abs error, relative L2 error and the verdict of ``TOL[name]``
    over (kernel, plain) output pairs; ``pv`` is P|V| for flash."""
    tol = TOL[name]
    err = max(max_err(a, b) for a, b in pairs)
    l2 = max(rel_err(a, b) for a, b in pairs)
    ok = l2 <= tol["l2"]
    for a, b in pairs:
        a, b = a.float(), b.float()
        allowed = tol["atol"] + tol["rtol"] * b.abs()
        if pv is not None:
            allowed = allowed + tol["pv"] * pv.float()
        ok = ok and bool(((a - b).abs() <= allowed).all())
    return dict(max_abs_err=err, rel_l2=l2, tolerance=tol, ok=ok)


# ---------------------------------------------------------------------------
# phase 1: kernels
# ---------------------------------------------------------------------------


def phase_kernels(dev, build_log=None):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build, reset_launch_counts
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    if build_log:
        os.makedirs(os.path.dirname(os.path.abspath(build_log)), exist_ok=True)
        with open(build_log, "w") as f:
            f.write(_build.BUILD_LOG)
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    rows = []
    # flash attention: the prefill shape, GQA read in place
    B, S, H, Hk, hd = 2, 2048, 32, 2, 128
    q, k, v = randn(B, S, H, hd), randn(B, S, Hk, hd), randn(B, S, Hk, hd)
    kvh = (torch.arange(H, device=dev) // (H // Hk)).to(torch.int32)
    out = fa.flash_attention(q, k, v, causal=True, kv_head=kvh)
    ref = fa.flash_attention_plain(q, k, v, causal=True, kv_head=kvh)
    pv = fa.flash_attention_plain(q, k, v.abs(), causal=True, kv_head=kvh)
    torch.cuda.synchronize()
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    flops = 4.0 * B * S * S * H * hd * 0.5        # causal: half the tiles
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())   # q, o, k, v once
    bms, by = bound(flops, nbytes)
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:67",
        shape=f"B={B} S={S} H={H} Hkv={Hk} hd={hd} causal bf16",
        **compare("flash_attention", [(out, ref)], pv=pv),
        ms=cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True,
                                              kv_head=kvh)),
        plain_ms=cuda_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=True, kv_head=kvh), iters=5),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))))
    del q, k, v, qt, kt, vt, out, ref, pv

    # decode attention: 4 rows against a 4096-slot cache, ragged lengths
    B, S = 4, 4096
    q = randn(B, 1, H, hd)
    kc, vc = randn(B, S, Hk, hd), randn(B, S, Hk, hd)
    lens = [4096, 2999, 1500, 17]
    clen = torch.tensor(lens, dtype=torch.int32, device=dev)
    out = dec.decode_attention(q, kc, vc, clen, kv_head=kvh)
    ref = dec.decode_attention_plain(q, kc, vc, clen, kv_head=kvh)
    torch.cuda.synchronize()
    mask = (torch.arange(S, device=dev)[None, :] < clen[:, None])[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    flops = 4.0 * sum(lens) * H * hd
    nbytes = 2 * sum(lens) * Hk * hd * 2 + 2 * q.numel() * 2 + 4 * B
    bms, by = bound(flops, nbytes)
    rows.append(dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:56",
        shape=f"B={B} S={S} H={H} Hkv={Hk} hd={hd} cache_len={lens} bf16",
        **compare("decode_attention", [(out, ref)]),
        ms=cuda_ms(lambda: dec.decode_attention(q, kc, vc, clen,
                                                kv_head=kvh), iters=50),
        plain_ms=cuda_ms(lambda: dec.decode_attention_plain(
            q, kc, vc, clen, kv_head=kvh), iters=10),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), iters=50)))
    del q, kc, vc, qt, kt, vt, out, ref, mask

    # norms: 4096 rows of d_model 4096 (the prefill of 2 x 2048 tokens);
    # fused at block_rows=256, the TokenWeave choice for >= 4096 tokens
    n, d = 4096, 4096
    x, y, gw = randn(n, d), randn(n, d), randn(d)
    out = rn.rmsnorm(x, gw)
    ref = rn.rmsnorm_plain(x, gw)
    torch.cuda.synchronize()
    bms, by = bound(4.0 * n * d, (2 * n * d + d) * 2)
    rows.append(dict(
        name="rmsnorm", route="triton",
        source="src/repro_torch/kernels/rmsnorm.py",
        replaces="src/repro/kernels/rmsnorm.py:76",
        shape=f"n={n} d={d} bf16",
        **compare("rmsnorm", [(out, ref)]),
        ms=cuda_ms(lambda: rn.rmsnorm(x, gw), iters=50),
        plain_ms=cuda_ms(lambda: rn.rmsnorm_plain(x, gw), iters=20),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: F.rms_norm(x, (d,), gw, 1e-5), iters=50)))
    s1, h1 = rn.fused_add_rmsnorm(x, y, gw, block_rows=256)
    s2, h2 = rn.fused_add_rmsnorm_plain(x, y, gw)
    torch.cuda.synchronize()
    bms, by = bound(6.0 * n * d, (4 * n * d + d) * 2)
    rows.append(dict(
        name="fused_add_rmsnorm", route="triton",
        source="src/repro_torch/kernels/rmsnorm.py",
        replaces="src/repro/kernels/rmsnorm.py:34",
        shape=f"n={n} d={d} block_rows=256 bf16",
        **compare("fused_add_rmsnorm", [(s1, s2), (h1, h2)]),
        ms=cuda_ms(lambda: rn.fused_add_rmsnorm(x, y, gw, block_rows=256),
                   iters=50),
        plain_ms=cuda_ms(lambda: rn.fused_add_rmsnorm_plain(x, y, gw),
                         iters=20),
        bound_ms=bms, bound_by=by, library_ms=None))
    del x, y, gw, out, ref, s1, s2, h1, h2
    reset_launch_counts()
    log({"phase": "kernels", "build_s": build_s,
         "tolerance": "per kernel: |kernel - plain| <= atol + rtol*|plain| "
                      "(+ pv*P|V| for flash) elementwise and relative L2 "
                      "<= l2 (reasons in chip_smoke.py TOL)",
         "results": rows})
    return rows


# ---------------------------------------------------------------------------
# model helpers
# ---------------------------------------------------------------------------


def prefill_batch(B, S, vocab, dev, seed):
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    ids = torch.randint(0, vocab, (B, S), generator=g, dtype=torch.int32)
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    return {"ids": ids.to(dev), "positions": pos.contiguous().to(dev)}


def rel_err(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# ---------------------------------------------------------------------------
# phase 2: reference on a small input
# ---------------------------------------------------------------------------


def phase_reference(dev):
    """Two layers at full width: GPU (kernels) against CPU (plain)."""
    import torch

    from repro_torch.api import compile
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    cfg = dataclasses.replace(get_config("chatglm3-6b"), n_layers=2)
    prog = compile(cfg, policy="sequential")
    params = prog.init_params(SEED, device="cpu")
    step = prog.prefill(2, 128)
    batch = prefill_batch(2, 128, cfg.vocab, "cpu", SEED)
    want = step(params, batch)
    gpu_params = {k: _to(v, dev) for k, v in params.items()}
    got = step(gpu_params, {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    checks = {}
    for key in ("logits", "layers.k", "layers.v"):
        a, b = got[key].cpu(), want[key]
        checks[key] = {"rel_err": rel_err(a, b),
                       "max_abs_err": max_err(a, b),
                       "finite": bool(torch.isfinite(a.float()).all())}
    ok = all(c["finite"] and c["rel_err"] < 2e-2 for c in checks.values())
    ok = ok and bool((got["logits"].argmax(-1).cpu()
                      == want["logits"].argmax(-1)).float().mean() >= 0.5)
    log({"phase": "reference", "config": "chatglm3-6b at full width, 2 "
         "layers, B=2 S=128", "checks": checks,
         "tolerance": "relative L2 error < 2e-2: bf16 round-off of the "
                      "kernels against the plain versions on the CPU",
         "kernel_launches": dict(LAUNCHES), "ok": ok})
    return ok


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------------------
# phase 3: strategy transparency
# ---------------------------------------------------------------------------


def phase_transparency(dev, params):
    import torch

    from repro_torch.api import compile
    from repro_torch.kernels import launch_counts, reset_launch_counts
    prog = compile("chatglm3-6b", policy="sequential")
    seq = prog.prefill(2, 2048)
    dyn = compile("chatglm3-6b", policy="dynamic").prefill(2, 2048)
    batch = prefill_batch(2, 2048, prog.model.cfg.vocab, dev, SEED + 1)
    want = seq(params, batch)["logits"]
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = dyn(params, batch)["logits"]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    err = rel_err(got, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    finite = bool(torch.isfinite(got.float()).all())
    ok = (finite and err < 5e-2 and agree >= 0.5
          and dyn.strategies.get("layers") == "tokenweave"
          and counts.get("fused_add_rmsnorm", 0) > 0)
    log({"phase": "transparency", "shape": "B=2 S=2048",
         "strategies": dyn.strategies, "rel_err_vs_sequential": err,
         "max_abs_err_vs_sequential": max_err(got, want),
         "argmax_agree": agree, "finite": finite, "launches": counts,
         "dynamic_prefill_s": dt,
         "tolerance": "relative L2 error of the logits < 5e-2 and the "
                      "same argmax: TokenWeave normalizes the unrounded f32 "
                      "sum, sequential its bf16 rounding, and the 1-ulp "
                      "differences grow through 28 random layers",
         "ok": ok})
    return ok


# ---------------------------------------------------------------------------
# phase 4: serve (the main path)
# ---------------------------------------------------------------------------


def phase_serve(dev, params, gpu):
    import numpy as np
    import torch

    from repro_torch.api import compile
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import Request, ServeConfig
    prog = compile("chatglm3-6b")          # policy: dynamic
    cfg = prog.model.cfg
    scfg = ServeConfig(max_batch=4, s_max=4096, prefill_batch=4,
                       prefill_buckets=(32, 64, 128, 256, 512, 1024, 2048))
    rng = np.random.default_rng(SEED)
    lens = (17, 300, 1000, 2000)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]

    def run(new_tokens):
        engine = prog.serve(params, scfg)
        for i, p in enumerate(prompts):
            engine.submit(Request(i, p, max_new_tokens=new_tokens))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = engine.run()
        torch.cuda.synchronize()
        return engine, done, time.perf_counter() - t0

    run(2)                        # warm-up: trace, schedule, JIT
    reset_launch_counts()
    engine, done, wall = run(16)
    counts = launch_counts()
    reqs = sorted(done, key=lambda r: r.rid)
    tokens = sum(len(r.output) for r in reqs)
    ok = (len(reqs) == 4 and all(r.ok and len(r.output) == 16 for r in reqs)
          and all(0 <= t < cfg.vocab for r in reqs for t in r.output))
    for name in ("flash_attention", "decode_attention", "rmsnorm",
                 "fused_add_rmsnorm"):
        ok = ok and counts.get(name, 0) > 0
    log({"phase": "serve", "gpu": gpu, "prompt_lens": list(lens),
         "new_tokens": 16, "wall_s": wall, "tokens_per_s": tokens / wall,
         "ttft_s": [r.first_token_s - r.submitted_s for r in reqs],
         "outputs_head": [r.output[:4] for r in reqs],
         "stats": engine.stats, "launches": counts,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "ok": ok})
    return ok, counts


# ---------------------------------------------------------------------------
# phase 5 (optional): where the time goes
# ---------------------------------------------------------------------------


def _profile(fn, steps):
    """Wall time per step, device busy share and the top ops of ``steps``
    calls of ``fn`` under ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    # device time: the kernels themselves (the CPU ops that launched them
    # report the same time again)
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))

    device_ms = sum(dev_us(e) for e in kernels) / 1e3
    by_dev = sorted(kernels, key=dev_us, reverse=True)[:8]
    cpu = [e for e in ka if e.device_type == DeviceType.CPU]
    by_cpu = sorted(cpu, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:8]
    return {"steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
            "device_ms_per_step": device_ms / steps,
            "device_busy_share": device_ms / (wall * 1e3),
            "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
            "cpu_ops_per_step": sum(e.count for e in cpu
                                    if e.key.startswith("aten::")) / steps,
            "top_device_ms_per_step": {e.key[:60]: dev_us(e) / 1e3 / steps
                                       for e in by_dev},
            "top_cpu_self_ms_per_step": {
                e.key[:60]: e.self_cpu_time_total / 1e3 / steps
                for e in by_cpu}}


def phase_profile(dev, params):
    """One warm prefill (B=4, bucket 2048, TokenWeave) and a window of
    tier-4 decode steps of the serve path, under the profiler."""
    import numpy as np
    import torch

    from repro_torch.api import compile
    from repro_torch.serve import Request, ServeConfig
    prog = compile("chatglm3-6b")
    cfg = prog.model.cfg
    step = prog.prefill(4, 2048)
    batch = prefill_batch(4, 2048, cfg.vocab, dev, SEED + 2)
    step(params, batch)
    prefill = _profile(lambda: step(params, batch), 2)
    scfg = ServeConfig(max_batch=4, s_max=4096, prefill_batch=4,
                       prefill_buckets=(32, 64, 128, 256, 512, 1024, 2048))
    engine = prog.serve(params, scfg)
    rng = np.random.default_rng(SEED)
    for i, n in enumerate((17, 300, 1000, 2000)):
        engine.submit(Request(i, rng.integers(0, cfg.vocab, n).astype(
            np.int32), max_new_tokens=64))
    for _ in range(4):              # prefill + warm decode steps
        engine.step()
    decode = _profile(engine.step, 16)
    engine.run()
    log({"phase": "profile", "prefill_B4_S2048": prefill,
         "decode_tier4": decode})


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="kernels,reference,transparency,serve")
    ap.add_argument("--build-log", default=None,
                    help="write nvcc/ptxas output of the kernel build here")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    ok = True
    kernel_rows = (phase_kernels(dev, args.build_log) if "kernels" in phases
                   else [])
    ok = ok and all(r["ok"] for r in kernel_rows)
    if "reference" in phases:
        ok = phase_reference(dev) and ok
    counts = {}
    if phases & {"transparency", "serve", "profile"}:
        from repro_torch.api import compile
        from repro_torch.configs import get_config
        t0 = time.perf_counter()
        params = compile(get_config("chatglm3-6b")).init_params(SEED)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
        log({"phase": "init", "params": n_params,
             "gb": sum(t.numel() * t.element_size()
                       for t in _leaves(params)) / 1e9,
             "init_s": time.perf_counter() - t0})
        if "transparency" in phases:
            ok = phase_transparency(dev, params) and ok
        if "profile" in phases:
            phase_profile(dev, params)
        if "serve" in phases:
            serve_ok, counts = phase_serve(dev, params, gpu)
            ok = serve_ok and ok
            for r in kernel_rows:
                r["launches"] = counts.get(r["name"], 0)
                ok = ok and r["launches"] > 0
    if kernel_rows:
        # launches: the serve run's count; null when it did not run
        keys = ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        log({"kernels": [{k: r.get(k) for k in keys}
                         for r in kernel_rows]})
    print(gpu, flush=True)
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


if __name__ == "__main__":
    sys.exit(main())
