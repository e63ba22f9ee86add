#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Runs four models the repository supports at their full published width
(and trains a fifth, smollm-135m: 30 layers, d_model 576, 9 q / 3 kv
heads of 64, d_ff 1536, vocab 49152, tied embeddings; 135 M parameters),
with random weights drawn from a seeded ``torch.Generator`` on the card:
chatglm3-6b (28 layers, d_model 4096, 32 q / 2 kv heads, d_ff 13696,
vocab 65024; ~6.2 B bf16 parameters, 12.5 GB), deepseek-moe-16b (28
layers, the first dense, d_model 2048, 16 heads, 64 routed experts of
width 1408 top-6 plus 2 shared, vocab 102400; 16.4 B parameters, ~33
GB), mamba2-2.7b (64 Mamba2 layers, d_model 2560, 80 SSM heads of 64,
state 128, vocab 50280; 2.7 B, ~5.4 GB) and zamba2-1.2b (38 Mamba2
layers, d_model 2048, 64 SSM heads, state 64, and one shared attention
block at width 4096, 32 heads, after every 6th layer; 1.2 B, ~2.4 GB).
Phases, each printing one JSON line:

  kernels   build the CUDA kernels from ``src/repro_torch/kernels/csrc``
            and hold each Hopper kernel against its plain PyTorch version
            at each shape the main paths give it (the three backward
            kernels at the train phase's shapes, with SDPA's backward and
            ``F.rms_norm``'s autograd as yardsticks); time kernel, plain
            version and the one-call PyTorch yardstick where there is one
            over back-to-back calls (``ms``: CUDA events, which measure
            the host where a call costs it more than the card), and
            kernel and yardstick on the device alone (``device_ms``,
            ``library_device_ms``: torch.profiler's kernel durations, in
            turns, or CUDA events where no profiler window is whole:
            ``device_ms_by``; decode attention cold, rotating over caches
            that pass the 50 MB L2) with the host's enqueue cost a call
            (``host_us``)
  reference a 2-layer cut of chatglm3-6b at full width on the GPU
            (kernels) against the same program on the CPU (plain versions)
  transparency
            chatglm3-6b ``Program.prefill(2, 2048)`` under ``dynamic``
            against ``sequential`` on the same params and inputs: as
            published (sequence parallel) dynamic resolves to NanoFlow;
            with ``seq_parallel=False`` to TokenWeave, whose fused
            add+RMSNorm replaces each layer's [all-reduce -> add ->
            RMSNorm] chain
  serve     ``compile("chatglm3-6b").serve`` answers 4 requests (prompts
            of 17, 300, 1000 and 2000 tokens, 16 greedy tokens each: one
            (4, 2048) prefill group, then decode): the default engine,
            which replays each decode tier's step and each prefill group
            as one CUDA Graph (the (4, 2048) group captured ahead of
            traffic), and then the interpreter (``lowered=False``) on
            the same mix, whose tokens and launch counts must be the
            same; the build seconds of the program's steps, cold; one
            warm (4, 2048) prefill group through the engine, graph and
            interpreter in turns, and its graph replayed alone; the
            steady tier-4 decode step's wall time (CUDA events over a
            window of engine steps), graphs and interpreter in turns,
            and one graph replay alone; the PlanStore's snapshot; then a
            warm start: the store saved, a fresh ``compile(arch,
            plan_store_path=...)`` builds its steps (timed) and serves
            the same mix with no ``lower`` call and the same tokens
  lifecycle chatglm3-6b serves prompts of 2500, 3000 and 4000 tokens
            (longer than the largest bucket: chunked prefill through the
            decode graph, the three first chunks packed into one (4,
            2048) chunk group, each chunk step one CUDA Graph replay)
            with the same 4 requests behind them, 16 greedy tokens each,
            with graphs and with the interpreter (tokens, launch counts
            and dispatch order must be the same); TTFT per request (the
            17-token prompt's behind the long ones) and peak memory;
            one warm (4, 2048) chunk step through the engine, graph and
            interpreter in turns, and its graph replayed alone; then the
            request lifecycle on one engine: a BoundedQueue shed and an
            expired deadline at the door, an injected prefill dispatch
            fault, a priority preemption resumed, ``drain()`` — every
            request terminated once, counters that agree, every row
            free, ``failed`` equal to the injected faults
  paged     chatglm3-6b on ``PagedCache(page_size=16)``: the mix with
            graphs, with the interpreter and on the dense cache (tokens
            and launch counts equal), the steady tier-4 step paged and
            dense in turns, the gather and frontier scatter alone (CUDA
            events) and a profiled window of decode steps (device time,
            index kernels); 16 requests (the mix's prompts four times,
            64 greedy tokens) at ``max_batch=16`` in a 1024-page pool —
            the dense ``max_batch=4`` pool's bytes — with graphs and with
            the interpreter (16 resident at once, no page held after
            ``drain()``) against dense ``max_batch=4`` on the same
            requests; then the same traffic in 512 pages (page denials,
            every request terminated once, no page or row leaked)
  sampling  chatglm3-6b's mix with temperature 0.8, top-k 50, top-p 0.95:
            graphs against the interpreter, a fresh engine repeating the
            tokens, ``SamplingConfig()`` against the default greedy
            engine, Philox's bits on the card against the CPU's, tokens
            of fixed logits on both devices, and the steady tier-4 step
            sampled and greedy in turns
  spec      chatglm3-6b's mix with speculative decode at tier 4: ``ngram``
            k=4, ``self`` k=4 and ``k="auto"`` (a fresh ``policy="auto"``
            program a run), dense and paged, each with graphs and with
            the interpreter (tokens, spec counters and launch counts equal
            where the draft lengths picked are; every spec step one
            verify replay, and one draft replay for ``self``; nothing
            lowered after warm-up); spec tokens against plain greedy's
            up to the first position whose plain top-2 logit margin is
            below ``NEAR_TIE``; an oracle proposer drafting plain greedy's
            own tokens (acceptance, tokens/s against plain, k=4 and 8, in
            turns); the tier-4 verify graph at k=2, 4, 8 against the plain
            tier-4 graph, replayed alone in turns; a profiled verify step
            (plain W > 1 attention, GEMMs, the rest); ``k="auto"``'s picks
            under the oracle; then a ``moe_spec`` line: deepseek-moe-16b
            with ``ngram`` k=4 (``self`` refuses its two stacks)
  autotune  chatglm3-6b, then deepseek-moe-16b: ``compile(arch,
            policy=AutoPolicy(measure_top_k=3, measurer=
            realizer_measurer(...)))`` builds the (4, 2048) prefill group
            and tier-4 decode, each context's top 3 timed on the card;
            ``Program.explain()``, the model's seconds against the card's
            for each refined candidate and where their orders disagree;
            the mix served under the autotuner against a fixed policy of
            its winners (same tokens), and from a saved and loaded bundle
            (same tokens, no re-tune)
  moe_reference
            deepseek-moe-16b cut to 2 layers (the dense first layer and
            one MoE layer) at full width, B=2 S=128, GPU against CPU
  moe_transparency
            deepseek-moe-16b at full depth, B=2 S=2048: ``dynamic``
            resolves the MoE layers to DBO, held against two sequential
            B=1 runs; ``comet`` against sequential on the same batch
  moe_serve ``compile("deepseek-moe-16b").serve`` answers the same 4
            requests: DBO prefill, grouped-FFN decode; then one
            3000-token request through its two chunk graphs, held to the
            interpreter (a ``moe_chunked`` line); then the mix on the paged
            cache against the dense one and the paged interpreter, its
            steady tier-4 step and its gather and scatter (``moe_paged``)
  ssm_reference
            mamba2-2.7b cut to 2 layers (B=2 S=256) and zamba2-1.2b to
            one group (6 Mamba2 layers and the shared block under
            ``dynamic``, B=2 S=1024) at full width, GPU (the kernels)
            against CPU (their plain versions)
  ssm_transparency
            mamba2-2.7b and zamba2-1.2b at full depth, B=4 S=2048:
            ``dynamic`` against ``sequential``; it splits the Mamba2
            stacks under NanoFlow and fuses zamba2's shared block under
            TokenWeave (the fused add+RMSNorm kernel)
  ssm_serve each SSM model answers the same 4 requests (its decode starts
            from the cache rows as they are: neither package hands the
            recurrent state from prefill to decode)
  train     smollm-135m cut to 2 layers at full width: ``Program.
            train_step(2, 512)`` on the card against the CPU (loss, every
            gradient leaf, one step's metrics); smollm-135m as published
            (B=8 S=2048): ``dynamic`` (TokenWeave) against ``sequential``
            on the first step's loss and gradients, 30 steps of
            ``train_loop`` on one repeated ``SyntheticBackend`` batch
            (the loss must fall by ``LOOP_MARGIN``), a crash at step 9
            restored from the step-5 checkpoint repeating the uncrashed
            losses, and the step's wall and device time, tokens/s, MFU,
            peak memory and launches; then chatglm3-6b at full width cut
            to 4 layers (B=2 S=2048, NanoFlow) the same way, without the
            loop

Each model phase zeroes the launch counts just before the run it checks
and reads them just after; the ``kernels`` line reports their sum over
the phases that ran (null when none did), and every kernel must have
launched on some path.

Usage:  python3 chip_smoke.py [--phases kernels,reference,transparency,
            serve,lifecycle,paged,sampling,spec,autotune,moe_reference,
            moe_transparency,moe_serve,ssm_reference,ssm_transparency,
            ssm_serve,train]
        (add ``profile`` / ``moe_profile`` / ``ssm_profile`` for a
        torch.profiler breakdown of a warm prefill, eager and replayed
        as the engine's graph, of a window of decode steps, with graphs
        and with the interpreter, and — chatglm3-6b — of the (4, 2048)
        chunk group's graph)
Exits non-zero, printing no result, without a CUDA device or without the
repository's ``src/repro_torch`` beside this file.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
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
    # f32 sums; the probabilities enter the PV product as a bf16 high and
    # low part (~2^-16 relative); only the output rounded: 1 ulp < 1e-2
    # relative; outputs have RMS 0.026 (4096 keys) to 0.24 (17 keys), and
    # one 256-key chunk dropped moves them by ~1e-2
    "decode_attention": dict(atol=1e-3, rtol=1e-2, l2=1e-2),
    # f32 sums; x*rsqrt rounded to bf16, then *g rounded: 2 ulps
    "rmsnorm": dict(atol=1e-3, rtol=1.6e-2, l2=4e-3),
    "fused_add_rmsnorm": dict(atol=1e-3, rtol=1.6e-2, l2=4e-3),
    # the kernel keeps h = silu(x W1) * (x W3) in bf16 between its two
    # launches (2^-9 relative per element), which moves an output by at
    # most 2^-9 * sum_f |h||W2| = 2^-9 * (|h| @ |W2|): pv is that with a
    # factor 2 (P|V| of flash's rule is |h| @ |W2| here), rtol one output
    # ulp; all of F is summed in f32 and rounded once
    "grouped_ffn": dict(atol=0.0, pv=2 ** -8, rtol=2 ** -7, l2=1e-2),
    # the kernel's products run on the tensor cores in f32: C B^T and C
    # in exactly (bf16 products), while M, the state and w*x each enter
    # as a bf16 high and low part (~2^-17 relative); sums in other orders
    # (f32 round-off ~1e-4 of the terms' sum); only the output is rounded
    # to bf16, and two f32 values that straddle a rounding boundary land
    # one ulp (<= 2^-7 relative) apart
    "ssd_scan": dict(atol=1e-3, rtol=2 ** -7, l2=1e-2),
    # dq, dk, dv: P and dS enter the tensor cores as bf16 (2^-9 relative
    # each) where the plain version keeps f32 to the output, and each
    # output sums up to S x (q heads a K/V head) such terms in another
    # order before its one bf16 rounding: every element within
    # atol_of_max * max|plain| + rtol * |plain|, relative L2 2e-2
    "flash_attention_bwd": dict(atol_of_max=2e-2, rtol=2e-2, l2=2e-2),
    # f32 row math in both (rsqrtf against torch.rsqrt, sums in another
    # order), dx and dg rounded to bf16 once each: 2 ulps, and atol for
    # the elements of dx where r (dh g) and k x cancel
    "rmsnorm_bwd": dict(atol_of_max=2e-3, rtol=1.6e-2, l2=4e-3),
    "fused_add_rmsnorm_bwd": dict(atol_of_max=2e-3, rtol=1.6e-2, l2=4e-3),
}
SEED = 0
# phase-name prefix of each model family
PREFIX = {"dense": "", "moe": "moe_", "ssm": "ssm_", "hybrid": "ssm_"}
# the kernels each family's serve path must launch
SERVE_KERNELS = {
    "dense": ("flash_attention", "decode_attention", "rmsnorm"),
    "moe": ("flash_attention", "decode_attention", "rmsnorm", "grouped_ffn"),
    "ssm": ("ssd_scan", "rmsnorm"),
    "hybrid": ("ssd_scan", "rmsnorm", "flash_attention", "decode_attention",
               "fused_add_rmsnorm"),
}


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


def _dev_us(e):
    """Device time of a profiler event, in microseconds."""
    return float(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)))


def device_ms(fns, iters=30, warmup=3, windows=5):
    """Device time per call on the card alone: the durations of the
    kernels (and device copies) that ``iters`` calls launch, summed by
    ``torch.profiler``, without the host's gaps between launches.  The
    calls cycle through ``fns`` (each on its own inputs), so a caller can
    rotate past the 50 MB L2 where the real caller finds its data cold.

    Returns the time and how it was taken.  The profiler now and then
    hands back a window without all of its device events (seen on an
    H100: none, or fewer kernels than calls, and once in every window of
    a call): such a window is measured again, up to ``windows`` times,
    and when none is whole the time comes from CUDA events around the
    same calls (``"cuda_events"``), which include the host's gaps where
    a call costs the host more than the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fns[i % len(fns)]()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        total = sum(_dev_us(e) for e in events)
        if total > 0 and sum(e.count for e in events) >= iters:
            return total / 1e3 / iters, "profiler"
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, "cuda_events"


def host_us(fn, iters=50):
    """The host's cost of a call: enqueue time over ``iters`` calls, then
    one synchronise (outside the clock)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def device_times(kernel, library=None, name="library"):
    """``device_ms`` and ``host_us`` of a kernel's wrapper and
    ``<name>_device_ms`` of its one-call yardstick, each a list of calls
    to rotate through (see ``device_ms``), timed in turns (kernel,
    yardstick, yardstick, kernel) and averaged over the two turns;
    ``device_ms_by`` says how each was taken (the kernel's two turns, then
    the yardstick's)."""
    k = [device_ms(kernel)]
    lib = None if library is None else [device_ms(library),
                                        device_ms(library)]
    k.append(device_ms(kernel))
    return {"device_ms": sum(t for t, _ in k) / 2,
            "device_ms_turns": [t for t, _ in k],
            f"{name}_device_ms": None if lib is None
            else sum(t for t, _ in lib) / 2,
            f"{name}_device_ms_turns": None if lib is None
            else [t for t, _ in lib],
            "device_ms_by": [how for _, how in k + (lib or [])],
            "host_us": host_us(kernel[0])}


def pass_ms(fn, parts, iters=20, windows=5):
    """Device ms a call of ``fn`` spends in each of its kernels whose name
    holds one of ``parts`` (the passes of a multi-launch kernel), from
    ``torch.profiler``'s kernel durations over ``iters`` calls; a window
    missing one of the passes' events is measured again, up to
    ``windows`` times (None where none was whole)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        out = {}
        for part in parts:
            mine = [e for e in events if part in e.key]
            out[part] = (sum(_dev_us(e) for e in mine) / 1e3 / iters
                         if mine and sum(e.count for e in mine) >= iters
                         else None)
        if all(v is not None for v in out.values()):
            return out
    return out


def bound(flops, nbytes):
    """``bound_ms`` and ``bound_by`` of ``flops`` operations on ``nbytes``."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return (dict(bound_ms=t_ops, bound_by="operations") if t_ops >= t_mem
            else dict(bound_ms=t_mem, bound_by="bytes"))


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


def compare_bwd(name, pairs):
    """``compare`` for the backward kernels: every element within
    ``atol_of_max`` times the plain output's largest magnitude plus
    ``rtol`` of its own, and the relative L2 error within ``l2``."""
    tol = TOL[name]
    ok = True
    for a, b in pairs:
        a, b = a.float(), b.float()
        allowed = tol["atol_of_max"] * b.abs().max() + tol["rtol"] * b.abs()
        ok = ok and bool(((a - b).abs() <= allowed).all()) \
            and rel_err(a, b) <= tol["l2"]
    return dict(max_abs_err=max(max_err(a, b) for a, b in pairs),
                rel_l2=max(rel_err(a, b) for a, b in pairs), tolerance=tol,
                ok=ok)


def kernel_row(name, route, source, replaces, cases):
    """One row of the kernels line from its cases, each a shape that a main
    path gives the kernel: every case is held to ``TOL[name]``, the first
    case's times are the row's and the others' ride along under ``also``."""
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, **cases[0],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "rel_l2": max(c["rel_l2"] for c in cases),
            "ok": all(c["ok"] for c in cases), "also": cases[1:]}


# ---------------------------------------------------------------------------
# phase 1: kernels
# ---------------------------------------------------------------------------


def phase_kernels(dev, build_log=None):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build, reset_launch_counts
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ssd

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

    def flash(what, B, S, H, Hk, hd=128):
        q, k, v = randn(B, S, H, hd), randn(B, S, Hk, hd), randn(B, S, Hk, hd)
        kvh = (torch.arange(H, device=dev) // (H // Hk)).to(torch.int32)
        out = fa.flash_attention(q, k, v, causal=True, kv_head=kvh)
        ref = fa.flash_attention_plain(q, k, v, causal=True, kv_head=kvh)
        pv = fa.flash_attention_plain(q, k, v.abs(), causal=True, kv_head=kvh)
        torch.cuda.synchronize()
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        return dict(
            shape=f"{what}: B={B} S={S} H={H} Hkv={Hk} hd={hd} causal bf16",
            **compare("flash_attention", [(out, ref)], pv=pv),
            ms=cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True,
                                                  kv_head=kvh)),
            plain_ms=cuda_ms(lambda: fa.flash_attention_plain(
                q, k, v, causal=True, kv_head=kvh), iters=5),
            # causal: half the tiles; q, o, k and v once
            **bound(4.0 * B * S * S * H * hd * 0.5,
                    2 * (2 * q.numel() + k.numel() + v.numel())),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
            **device_times(
                [lambda: fa.flash_attention(q, k, v, causal=True,
                                            kv_head=kvh)],
                [lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)]))

    def flash_bwd(what, B, S, H, Hk, hd):
        q, k, v = randn(B, S, H, hd), randn(B, S, Hk, hd), randn(B, S, Hk, hd)
        do = randn(B, S, H, hd)
        kvh = (torch.arange(H, device=dev) // (H // Hk)).to(torch.int32)
        o, lse = fa._flash_fwd(q, k, v, True, kvh, lse=True)
        lse_ref = fa.flash_attention_lse_plain(q, k, True, kvh)
        got = fa.flash_attention_bwd(q, k, v, o, do, lse, causal=True,
                                     kv_head=kvh)
        ref = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=True,
                                           kv_head=kvh)
        torch.cuda.synchronize()
        # the yardstick: SDPA's backward alone (its forward graph kept)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
        dot = do.transpose(1, 2)

        def sdpa_bwd():
            return torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)

        def kernel():
            return fa.flash_attention_bwd(q, k, v, o, do, lse, causal=True,
                                          kv_head=kvh)
        nbytes = 2 * 4 * (q.numel() + k.numel()) + 4 * lse.numel()
        # a product of 2 S^2 hd FLOP a (batch, head), causal: half the
        # tiles; the function needs 5, the kernel's two passes do 7 (S and
        # dP in both), the dK/dV pass 4 of them and the dQ pass 3
        product = 2.0 * B * S * S * H * hd * 0.5
        times = device_times([kernel], [sdpa_bwd])
        geo = fa.flash_bwd_geometry(B, H, Hk, S, S, hd,
                                    torch.cuda.get_device_properties(
                                        dev).multi_processor_count)
        parts = pass_ms(kernel, ("flash_bwd_delta", "flash_bwd_dkdv",
                                 "flash_bwd_dq") + (
            ("flash_bwd_reduce",) if geo["splits"] > 1 else ()))

        def tflops(flop, ms):
            return None if not ms else flop / ms / 1e9
        return dict(
            shape=f"{what}: B={B} S={S} H={H} Hkv={Hk} hd={hd} causal bf16",
            geometry=geo,
            lse_max_abs_err=max_err(lse, lse_ref),
            **compare_bwd("flash_attention_bwd", list(zip(got, ref))),
            ms=cuda_ms(kernel, iters=10),
            plain_ms=cuda_ms(lambda: fa.flash_attention_bwd_plain(
                q, k, v, o, do, lse, causal=True, kv_head=kvh), iters=3),
            # 2.5 times the forward's products, causal: half the tiles
            **bound(5 * product, nbytes),
            library_ms=cuda_ms(sdpa_bwd, iters=10),
            **times,
            pass_device_ms=parts,
            tflops_bound_work=tflops(5 * product, times["device_ms"]),
            tflops_two_pass_work=tflops(7 * product, times["device_ms"]),
            tflops_dkdv_pass=tflops(4 * product, parts["flash_bwd_dkdv"]),
            tflops_dq_pass=tflops(3 * product, parts["flash_bwd_dq"]))

    def norm_bwd(what, n, d):
        x, gw, dh = randn(n, d), randn(d), randn(n, d)
        got, ref = rn.rmsnorm_bwd(x, gw, dh), rn.rmsnorm_bwd_plain(x, gw, dh)
        torch.cuda.synchronize()
        xr, gr = (t.clone().requires_grad_() for t in (x, gw))
        out = F.rms_norm(xr, (d,), gr, 1e-5)

        def library():
            return torch.autograd.grad(out, (xr, gr), dh, retain_graph=True)
        return dict(
            shape=f"{what}: n={n} d={d} bf16",
            **compare_bwd("rmsnorm_bwd", list(zip(got, ref))),
            ms=cuda_ms(lambda: rn.rmsnorm_bwd(x, gw, dh), iters=50),
            plain_ms=cuda_ms(lambda: rn.rmsnorm_bwd_plain(x, gw, dh),
                             iters=20),
            # x and dh read, dx written; g read and dg written
            **bound(8.0 * n * d, (3 * n * d + 2 * d) * 2),
            library_ms=cuda_ms(library, iters=50),
            **device_times([lambda: rn.rmsnorm_bwd(x, gw, dh)], [library]))

    def fused_bwd(what, n, d):
        x, y, gw, dh, dso = (randn(n, d), randn(n, d), randn(d), randn(n, d),
                             randn(n, d))
        s, _ = rn.fused_add_rmsnorm_plain(x, y, gw)
        got = rn.fused_add_rmsnorm_bwd(s, gw, dh, dso)
        ref = rn.fused_add_rmsnorm_bwd_plain(s, gw, dh, dso)
        torch.cuda.synchronize()
        xr, yr, gr = (t.clone().requires_grad_() for t in (x, y, gw))
        s2 = torch.add(xr, yr)
        h2 = F.rms_norm(s2, (d,), gr, rn.EPS)

        def composition():
            return torch.autograd.grad((s2, h2), (xr, yr, gr), (dso, dh),
                                       retain_graph=True)
        return dict(
            shape=f"{what}: n={n} d={d} bf16",
            **compare_bwd("fused_add_rmsnorm_bwd",
                          [(got[0], ref[0]), (got[2], ref[2])]),
            ms=cuda_ms(lambda: rn.fused_add_rmsnorm_bwd(s, gw, dh, dso),
                       iters=50),
            plain_ms=cuda_ms(lambda: rn.fused_add_rmsnorm_bwd_plain(
                s, gw, dh, dso), iters=20),
            # s, dh and ds_out read, ds written; g read and dg written
            **bound(10.0 * n * d, (4 * n * d + 2 * d) * 2),
            # no single PyTorch call computes it: the backward of
            # torch.add then F.rms_norm is timed beside it as a yardstick
            library_ms=None,
            composition_ms=cuda_ms(composition, iters=50),
            **device_times([lambda: rn.fused_add_rmsnorm_bwd(
                s, gw, dh, dso)], [composition], name="composition"),
            library_device_ms=None)

    def decode(what, H, Hk, B=4, S=4096, hd=128, lens=(4096, 2999, 1500, 17)):
        q = randn(B, 1, H, hd)
        kc, vc = randn(B, S, Hk, hd), randn(B, S, Hk, hd)
        kvh = (torch.arange(H, device=dev) // (H // Hk)).to(torch.int32)
        clen = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = dec.decode_attention(q, kc, vc, clen, kv_head=kvh)
        ref = dec.decode_attention_plain(q, kc, vc, clen, kv_head=kvh)
        torch.cuda.synchronize()
        mask = (torch.arange(S, device=dev)[None, :]
                < clen[:, None])[:, None, None, :]
        qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
        # device times cold, as a layer loop finds each layer's cache:
        # the calls rotate over caches that together pass the 50 MB L2
        valid = 4 * sum(min(n, S) for n in lens) * Hk * hd   # K, V bytes
        sets = [(q, kc, vc)] + [
            (randn(B, 1, H, hd), randn(B, S, Hk, hd), randn(B, S, Hk, hd))
            for _ in range(max(1, -(-100_000_000 // valid) - 1))]
        return dict(
            shape=f"{what}: B={B} S={S} H={H} Hkv={Hk} hd={hd} "
                  f"cache_len={list(lens)} bf16",
            **compare("decode_attention", [(out, ref)]),
            ms=cuda_ms(lambda: dec.decode_attention(q, kc, vc, clen,
                                                    kv_head=kvh), iters=50),
            plain_ms=cuda_ms(lambda: dec.decode_attention_plain(
                q, kc, vc, clen, kv_head=kvh), iters=10),
            **bound(4.0 * sum(lens) * H * hd,
                    2 * sum(lens) * Hk * hd * 2 + 2 * q.numel() * 2 + 4 * B),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), iters=50),
            caches_rotated=len(sets),
            **device_times(
                [lambda a=a: dec.decode_attention(*a, clen, kv_head=kvh)
                 for a in sets],
                [lambda a=a: F.scaled_dot_product_attention(
                    *(t.transpose(1, 2) for t in a), attn_mask=mask,
                    enable_gqa=True) for a in sets]))

    def norm(what, n, d):
        x, gw = randn(n, d), randn(d)
        out, ref = rn.rmsnorm(x, gw), rn.rmsnorm_plain(x, gw)
        torch.cuda.synchronize()
        return dict(
            shape=f"{what}: n={n} d={d} bf16",
            **compare("rmsnorm", [(out, ref)]),
            ms=cuda_ms(lambda: rn.rmsnorm(x, gw), iters=50),
            plain_ms=cuda_ms(lambda: rn.rmsnorm_plain(x, gw), iters=20),
            **bound(4.0 * n * d, (2 * n * d + d) * 2),
            library_ms=cuda_ms(lambda: F.rms_norm(x, (d,), gw, 1e-5),
                               iters=50),
            **device_times([lambda: rn.rmsnorm(x, gw)],
                           [lambda: F.rms_norm(x, (d,), gw, 1e-5)]))

    def fused(what, n, d, block_rows=256):
        x, y, gw = randn(n, d), randn(n, d), randn(d)
        s1, h1 = rn.fused_add_rmsnorm(x, y, gw, block_rows=block_rows)
        s2, h2 = rn.fused_add_rmsnorm_plain(x, y, gw)
        torch.cuda.synchronize()
        geo = rn.fused_geometry(n, d, block_rows)

        def composition():
            return F.rms_norm(torch.add(x, y), (d,), gw, rn.EPS)
        return dict(
            shape=f"{what}: n={n} d={d} block_rows={block_rows} bf16",
            geometry=geo,
            **compare("fused_add_rmsnorm", [(s1, s2), (h1, h2)]),
            ms=cuda_ms(lambda: rn.fused_add_rmsnorm(
                x, y, gw, block_rows=block_rows), iters=50),
            plain_ms=cuda_ms(lambda: rn.fused_add_rmsnorm_plain(x, y, gw),
                             iters=20),
            **bound(6.0 * n * d, (4 * n * d + d) * 2),
            # no single PyTorch call computes it: torch.add then
            # F.rms_norm is timed beside it as a yardstick
            library_ms=None,
            composition_ms=cuda_ms(composition, iters=50),
            **device_times([lambda: rn.fused_add_rmsnorm(
                x, y, gw, block_rows=block_rows)], [composition],
                name="composition"),
            library_device_ms=None)

    def ffn(what, N, E=64, D=2048, Fd=1408, rows_of=None):
        # rows_of: x is rows [N, 2N) of a (E, rows_of, D) buffer, read in
        # place (a Comet chunk of the dispatch buffer)
        x = randn(E, N, D) if rows_of is None else randn(E, rows_of, D)[
            :, N:2 * N]
        w1 = (randn(E, D, Fd).float() * D ** -0.5).to(torch.bfloat16)
        w3 = (randn(E, D, Fd).float() * D ** -0.5).to(torch.bfloat16)
        w2 = (randn(E, Fd, D).float() * Fd ** -0.5).to(torch.bfloat16)
        out = gm.grouped_ffn(x, w1, w3, w2)
        ref = gm.grouped_ffn_plain(x, w1, w3, w2)
        xf = x.float()
        h = F.silu(torch.bmm(xf, w1.float())) * torch.bmm(xf, w3.float())
        hw = torch.bmm(h.abs(), w2.float().abs())
        torch.cuda.synchronize()
        view = "" if rows_of is None else f" (rows of a {rows_of}-row buffer)"
        return dict(
            shape=f"{what}: E={E} N={N}{view} D={D} F={Fd} bf16",
            **compare("grouped_ffn", [(out, ref)], pv=hw),
            ms=cuda_ms(lambda: gm.grouped_ffn(x, w1, w3, w2)),
            plain_ms=cuda_ms(lambda: gm.grouped_ffn_plain(x, w1, w3, w2),
                             iters=5),
            **bound(6.0 * E * N * D * Fd,
                    2 * (2 * E * N * D + 3 * E * D * Fd)),
            # no single PyTorch call computes the gated FFN: the cuBLAS
            # composition bmm x3 + silu*mul is timed beside it as a yardstick
            library_ms=None,
            composition_ms=cuda_ms(lambda: torch.bmm(
                F.silu(torch.bmm(x, w1)) * torch.bmm(x, w3), w2)),
            **device_times([lambda: gm.grouped_ffn(x, w1, w3, w2)],
                           [lambda: torch.bmm(F.silu(torch.bmm(x, w1))
                                              * torch.bmm(x, w3), w2)],
                           name="composition"),
            library_device_ms=None)

    def scan(what, b, H, N, L=2048, P=64, G=1):
        args = ssd_inputs(g, b, L, H, P, N)
        out, ref = ssd.ssd_scan(*args), ssd.ssd_scan_plain(*args)
        torch.cuda.synchronize()
        Q = ssd.chunk_len(L, 128)
        # what the function needs: C_i . B_j once per group and only for
        # j <= i (Q(Q+1)/2 dot products of N per chunk), M x over the same
        # triangle per head, and C S and the state update (N P each) per
        # row and head; x and y, B and C, dt once
        flops = b * L * ((G * N + H * P) * (Q + 1) + 4 * H * N * P)
        nbytes = 2 * 2 * b * L * H * P + 2 * 2 * b * L * G * N + 4 * b * L * H
        return dict(
            shape=f"{what}: b={b} L={L} H={H} P={P} G={G} N={N} Q={Q} bf16",
            **compare("ssd_scan", [(out, ref)]),
            ms=cuda_ms(lambda: ssd.ssd_scan(*args), iters=10),
            plain_ms=cuda_ms(lambda: ssd.ssd_scan_plain(*args), iters=3),
            **bound(flops, nbytes),
            # no single PyTorch call computes an SSD scan
            library_ms=None,
            **device_times([lambda: ssd.ssd_scan(*args)]))

    glm, m2, z2 = "chatglm3-6b", "mamba2-2.7b", "zamba2-1.2b"
    sm = "smollm-135m"
    rows = [
        kernel_row("flash_attention", "cuda",
                   "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:67",
                   [flash(f"{glm} prefill, GQA read in place",
                          2, 2048, 32, 2),
                    flash(f"{z2} shared block prefill", 4, 2048, 32, 32),
                    # DBO runs the MoE layers' attention merged at B=4
                    flash("deepseek-moe-16b prefill", 4, 2048, 16, 16),
                    # the train step's forward (it also writes the LSE)
                    flash(f"{sm} train B=8", 8, 2048, 9, 3, hd=64)]),
        kernel_row("decode_attention", "cuda",
                   "src/repro_torch/kernels/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:56",
                   [decode(f"{glm} decode", 32, 2),
                    decode(f"{z2} shared block decode", 32, 32),
                    decode("deepseek-moe-16b decode", 16, 16)]),
        # rows: the prefill of B x 2048 tokens, the tier-4 decode step, the
        # verify steps and the chunk steps
        kernel_row("rmsnorm", "cuda",
                   "src/repro_torch/kernels/csrc/rmsnorm.cu",
                   "src/repro/kernels/rmsnorm.py:76",
                   [norm(f"{glm} B=2", 4096, 4096),
                    norm(f"{m2} B=4", 8192, 2560),
                    norm(f"{z2} Mamba layers B=4", 8192, 2048),
                    norm(f"{z2} shared block B=4", 8192, 4096),
                    norm(f"{glm} decode tier 4", 4, 4096),
                    # the speculative verify step at tier 4, W = k + 1
                    *[norm(f"{glm} verify tier 4, k={k}", 4 * (k + 1), 4096)
                      for k in (2, 4, 8)],
                    # the prefill group and the first chunk group (4,
                    # 2048); the 2500-token prompt's final chunk (1, 512)
                    norm(f"{glm} (4, 2048) group", 8192, 4096),
                    norm(f"{glm} final chunk (1, 512)", 512, 4096),
                    # the train step at smollm-135m's B=8 S=2048
                    norm(f"{sm} train B=8", 16384, 576)]),
        # block_rows=256: the TokenWeave choice for >= 4096 tokens (16 and
        # 32 blocks); block_rows=32 fills the card (256 blocks): what the
        # knob costs on one stream
        kernel_row("fused_add_rmsnorm", "cuda",
                   "src/repro_torch/kernels/csrc/fused_add_rmsnorm.cu",
                   "src/repro/kernels/rmsnorm.py:34",
                   [fused(f"{glm} seq_parallel=False B=2", 4096, 4096),
                    fused(f"{z2} shared block B=4, TokenWeave", 8192, 4096),
                    fused(f"{z2} shared block B=4, full grid", 8192, 4096,
                          block_rows=32),
                    # TokenWeave in the train step at smollm-135m's B=8
                    fused(f"{sm} train B=8, TokenWeave", 16384, 576)]),
        # deepseek-moe-16b's 64 experts: the DBO prefill micro-batch
        # (capacity 480 of 4096 tokens), the decode tier (capacity 4),
        # Comet's chunk (a quarter of the 480-row buffer, in place) and
        # the chunked prefill's steps
        kernel_row("grouped_ffn", "cuda",
                   "src/repro_torch/kernels/csrc/grouped_ffn.cu",
                   "src/repro/kernels/grouped_matmul.py:40",
                   [ffn("deepseek-moe-16b DBO prefill", 480),
                    ffn("deepseek-moe-16b decode", 4),
                    ffn("deepseek-moe-16b Comet chunk", 120, rows_of=480),
                    # a 3000-token prompt's chunk steps: 2048 and 1024
                    # tokens through the decode graph (capacity 240, 120)
                    ffn("deepseek-moe-16b chunk (1, 2048)", 240),
                    ffn("deepseek-moe-16b chunk (1, 1024)", 120)]),
        # x, B and C are column views of one post-conv buffer, as the
        # model hands them over
        kernel_row("ssd_scan", "cuda",
                   "src/repro_torch/kernels/csrc/ssd_scan.cu",
                   "src/repro/kernels/ssd_scan.py:63",
                   [scan(f"{m2} prefill", 4, 80, 128),
                    scan(f"{m2} NanoFlow half", 2, 80, 128),
                    scan(f"{z2} NanoFlow half", 2, 64, 64)]),
        # the backward kernels, at the train phase's shapes
        kernel_row("flash_attention_bwd", "cuda",
                   "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                   "src/repro/models/layers.py:563",
                   [flash_bwd(f"{sm} train", 8, 2048, 9, 3, 64),
                    flash_bwd(f"{glm} train", 2, 2048, 32, 2, 128)]),
        kernel_row("rmsnorm_bwd", "cuda",
                   "src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
                   "src/repro/models/layers.py:170",
                   [norm_bwd(f"{sm} train B=8", 16384, 576),
                    norm_bwd(f"{glm} train B=2", 4096, 4096)]),
        kernel_row("fused_add_rmsnorm_bwd", "cuda",
                   "src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
                   "src/repro/kernels/ops.py:63",
                   [fused_bwd(f"{sm} train B=8", 16384, 576),
                    fused_bwd(f"{glm} train B=2", 4096, 4096)]),
    ]
    lib = _build.library()
    builds = ptxas_report(_build.BUILD_LOG, ("flash_fwd_kernel",
                                             "flash_bwd_dkdv_kernel",
                                             "flash_bwd_dq_kernel",
                                             "rmsnorm_bwd_kernel",
                                             "ffn_gemm_kernel",
                                             "ssd_scan_kernel",
                                             # bf16 x and g, each pack count
                                             "fused_kernelI13__nv_bfloat16S"))
    builds["runtime"] = {
        "flash_attention hd=128": _build.kernel_info(
            lib.repro_flash_attention_info, 128),
        "flash_attention hd=64": _build.kernel_info(
            lib.repro_flash_attention_info, 64),
        **{f"flash_attention_bwd {part} hd={hd}": _build.kernel_info(
            lambda v, *a, w=w: lib.repro_flash_attention_bwd_info(v, w, *a),
            hd) for hd in (64, 128) for w, part in ((0, "dk/dv"), (1, "dq"))},
        **{f"grouped_ffn {v}": _build.kernel_info(
            lib.repro_grouped_ffn_info, i) for i, v in enumerate(
            ("gate-up N>64", "down N>64", "gate-up N<=64", "down N<=64"))},
        **{f"ssd_scan N={n}": _build.kernel_info(lib.repro_ssd_scan_info, n)
           for n in (128, 64)}}
    reset_launch_counts()
    log({"phase": "kernels", "build_s": build_s, "builds": builds,
         "tolerance": "per kernel: |kernel - plain| <= atol + rtol*|plain| "
                      "(+ pv*P|V| for flash) elementwise and relative L2 "
                      "<= l2 (reasons in chip_smoke.py TOL)",
         "results": rows})
    return rows


def ptxas_report(build_log, names):
    """What ptxas said (``-Xptxas -v``) of each compiled entry whose
    mangled name holds one of ``names``: registers a thread, spill stores
    and loads in bytes, static shared memory a block (the kernels' tiles
    are dynamic shared memory: ``runtime`` beside it has those), and any
    "Potential Performance Loss" note (serialized wgmma)."""
    import re
    out, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Potential Performance Loss: (.*) in the function "
                      r"'(\w+)'", line)
        if m and any(n in m[2] for n in names):
            out.setdefault(m[2], {})["ptxas_note"] = m[1]
            continue
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            cur = m.group(1) if any(n in m.group(1) for n in names) else None
            continue
        if cur is None:
            continue
        rec = out.setdefault(cur, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rec.update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rec["registers"] = int(m[1])
            m = re.search(r"(\d+) bytes smem", line)
            rec["static_smem_bytes"] = int(m[1]) if m else 0
    return out


# ---------------------------------------------------------------------------
# model helpers
# ---------------------------------------------------------------------------


def prefill_batch(B, S, vocab, dev, seed):
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    ids = torch.randint(0, vocab, (B, S), generator=g, dtype=torch.int32)
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    return {"ids": ids.to(dev), "positions": pos.contiguous().to(dev)}


def ssd_inputs(g, b, L, H, P, N):
    """SSD scan inputs on ``g``'s device: x, B and C as column views of
    one post-conv buffer; dt = softplus(n - 3) and A in [-16, -0.1], so
    the state carries across chunks; D ~ 1."""
    import torch
    import torch.nn.functional as F
    dev = g.device
    xbc = (torch.randn((b, L, H * P + 2 * N), generator=g, device=dev)
           * 0.5).to(torch.bfloat16)
    x = xbc[..., :H * P].unflatten(-1, (H, P))
    B = xbc[..., H * P:H * P + N].unflatten(-1, (1, N))
    C = xbc[..., H * P + N:].unflatten(-1, (1, N))
    dt = F.softplus(torch.randn((b, L, H), generator=g, device=dev) - 3.0)
    A = -torch.exp(torch.rand((H,), generator=g, device=dev) * 5.1 - 2.3)
    D = 1.0 + 0.1 * torch.randn((H,), generator=g, device=dev)
    return x, dt, A, B, C, D


def rel_err(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# ---------------------------------------------------------------------------
# launch counts and routes
# ---------------------------------------------------------------------------


def counted(totals, fn):
    """Run ``fn`` with the launch counts zeroed just before and read just
    after; add them to ``totals`` and return (result, counts)."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = launch_counts()
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    return out, counts


@contextlib.contextmanager
def recorded_routes():
    """(input, expert ids) of every MoE router call while the block runs."""
    from repro_torch.models import moe
    calls = []
    orig = moe.RouterOp.kernel

    def kernel(op, p, x):
        w, ve = orig(op, p, x)
        if x.device.type != "meta":      # not a trace's shape inference
            calls.append((x, ve))
        return w, ve

    moe.RouterOp.kernel = kernel
    try:
        yield calls
    finally:
        moe.RouterOp.kernel = orig


def route_check(a, b, wrs, k):
    """Routes of two runs (``recorded_routes`` lists, one entry per MoE
    layer; ``wrs`` the layers' router weights): the share of tokens whose
    set of chosen experts is the same, and the number of differing routes
    that no near tie explains.  The router ranks the logits x @ wr; run
    a's input differs from b's by dx, which moves expert e's logit by
    (dx @ wr)_e, so a's top-k set can differ from b's only where b's
    k-th and (k+1)-th logits lie within 2 max_e |(dx @ wr)_e| (+1e-4 for
    the f32 products): a differing route off such a near tie is a
    routing fault, and the size of dx is held by the callers' checks of
    the layers' outputs."""
    import torch
    assert len(a) == len(b) == len(wrs) > 0, (len(a), len(b), len(wrs))
    same_all, unexplained = [], 0
    for (xa, va), (xb, vb), wr in zip(a, b, wrs):
        xa, xb, wr = xa.float().cpu(), xb.float().cpu(), wr.float().cpu()
        same = (va.cpu().sort(-1).values == vb.cpu().sort(-1).values).all(-1)
        top = (xb @ wr).topk(k + 1, dim=-1).values
        margin = top[..., k - 1] - top[..., k]
        bound = 2 * ((xa - xb) @ wr).abs().amax(-1) + 1e-4
        unexplained += int((~same & (margin > bound)).sum())
        same_all.append(same.flatten())
    return float(torch.cat(same_all).float().mean()), unexplained


# ---------------------------------------------------------------------------
# phase 2: reference on a small input
# ---------------------------------------------------------------------------


def phase_reference(dev, totals, arch="chatglm3-6b", B=2, S=128,
                    n_layers=2, policy="sequential"):
    """A cut of ``n_layers`` layers at full width: GPU (kernels) against
    CPU (plain versions), the same program on both.  Every kernel of the
    family's prefill must have launched on the GPU.  For the MoE model
    also the share of tokens routed alike."""
    import torch

    from repro_torch.api import compile
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    prog = compile(cfg, policy=policy)
    params = prog.init_params(SEED, device="cpu")
    step = prog.prefill(B, S)
    batch = prefill_batch(B, S, cfg.vocab, "cpu", SEED)
    with recorded_routes() as cpu_routes:
        want = step(params, batch)
    gpu_params = {k: _to(v, dev) for k, v in params.items()}
    gpu_batch = {k: v.to(dev) for k, v in batch.items()}
    with recorded_routes() as gpu_routes:
        got, counts = counted(totals, lambda: step(gpu_params, gpu_batch))
    checks = {}
    for key in [k for k in want if k == "logits" or k.split(".")[-1]
                in ("k", "v")]:
        a, b = got[key].cpu(), want[key]
        checks[key] = {"rel_err": rel_err(a, b),
                       "max_abs_err": max_err(a, b),
                       "finite": bool(torch.isfinite(a.float()).all())}
    ok = all(c["finite"] and c["rel_err"] < 2e-2 for c in checks.values())
    ok = ok and bool((got["logits"].argmax(-1).cpu()
                      == want["logits"].argmax(-1)).float().mean() >= 0.5)
    ok = ok and all(counts.get(k, 0) > 0 for k in SERVE_KERNELS[cfg.family]
                    if k != "decode_attention")
    out = {"phase": PREFIX[cfg.family] + "reference",
           "config": f"{arch} at full width, {n_layers} layers, B={B} "
                     f"S={S}, policy {policy}",
           "strategies": step.strategies, "checks": checks,
           "tolerance": "relative L2 error < 2e-2: bf16 round-off of the "
                        "kernels against the plain versions on the CPU",
           "kernel_launches": counts}
    if cfg.moe is not None:
        share, unexplained = route_check(
            gpu_routes, cpu_routes, [params["layers"]["moe"]["router"]["wr"]],
            cfg.moe.top_k)
        out["routes_agree_share"] = share
        out["routes_differing_off_a_near_tie"] = unexplained
        out["tolerance"] += ("; every route that differs sits on a near "
                             "tie of the CPU run's router logits (k-th and "
                             "(k+1)-th within twice the largest logit "
                             "change dx @ wr): with random weights the 64 "
                             "experts' logits are ~N(0, 1), ~0.1 apart at "
                             "the top-6 boundary")
        ok = ok and unexplained == 0
    log(dict(out, ok=ok))
    return ok


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------------------
# phase 3: strategy transparency
# ---------------------------------------------------------------------------


def _dyn_vs_seq(cfg, params, B, dev, totals):
    """``dynamic`` against ``sequential`` on ``Program.prefill(B, 2048)``
    with the same params and inputs.  Returns the dynamic step, the run's
    record (strategies, the logits' error, argmax agreement, finiteness,
    launch counts, wall time) and whether the logits agree: relative L2
    error < 5e-2, the same argmax on at least half the tokens, finite."""
    import torch

    from repro_torch.api import compile
    seq = compile(cfg, policy="sequential").prefill(B, 2048)
    dyn = compile(cfg, policy="dynamic").prefill(B, 2048)
    batch = prefill_batch(B, 2048, cfg.vocab, dev, SEED + 1)
    want = seq(params, batch)["logits"]
    t0 = time.perf_counter()
    got, counts = counted(totals, lambda: dyn(params, batch)["logits"])
    dt = time.perf_counter() - t0
    err = rel_err(got, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    finite = bool(torch.isfinite(got.float()).all())
    run = {"strategies": dyn.strategies, "rel_err_vs_sequential": err,
           "max_abs_err_vs_sequential": max_err(got, want),
           "argmax_agree": agree, "finite": finite, "launches": counts,
           "dynamic_prefill_s": dt}
    return dyn, run, finite and err < 5e-2 and agree >= 0.5


def phase_transparency(dev, params, totals):
    """chatglm3-6b at full depth, B=2 S=2048: ``dynamic`` against
    ``sequential``, as published and with ``seq_parallel=False``."""
    from repro_torch.configs import get_config
    ok, runs = True, {}
    for sp, want_strategy, fused in ((True, "nanoflow", False),
                                     (False, "tokenweave", True)):
        cfg = dataclasses.replace(get_config("chatglm3-6b"), seq_parallel=sp)
        dyn, run, this_ok = _dyn_vs_seq(cfg, params, 2, dev, totals)
        this_ok = (this_ok and dyn.strategies.get("layers") == want_strategy
                   and (run["launches"].get("fused_add_rmsnorm", 0) > 0)
                   == fused)
        ok = ok and this_ok
        runs["published" if sp else "seq_parallel_off"] = dict(run,
                                                               ok=this_ok)
    log({"phase": "transparency", "shape": "B=2 S=2048", "runs": runs,
         "tolerance": "relative L2 error of the logits < 5e-2 and the "
                      "same argmax: TokenWeave normalizes the unrounded f32 "
                      "sum, sequential its bf16 rounding, and the 1-ulp "
                      "differences grow through 28 random layers",
         "ok": ok})
    return ok


class _Recorder:
    """Wraps a layer stack's Realizer: keeps each layer call's inputs and
    outputs (the Forward calls its realizer once per layer)."""

    def __init__(self, rz):
        self.rz, self.calls = rz, []

    def __call__(self, params, inputs):
        out = self.rz(params, inputs)
        self.calls.append((inputs, out))
        return out


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def phase_moe_transparency(dev, params, totals):
    """deepseek-moe-16b at full depth, B=2 S=2048: ``dynamic`` (DBO)
    against two sequential B=1 runs, and ``comet`` against sequential.

    Routes are discrete and random weights put the 64 experts' logits
    ~0.1 apart at the top-6 boundary, so one ulp of difference anywhere
    (cuBLAS may round a row differently at another batch size) flips a
    few near-tie routes, and a flipped token reaches every later token
    through attention: end to end, two such runs drift apart over 27
    layers.  DBO is therefore held layer by layer: each MoE layer of the
    DBO plan runs on the sequential runs' input to that layer (teacher
    forcing), and its outputs must match theirs on every token whose
    route agrees, with every differing route on a near tie.  The end to
    end numbers are reported beside it."""
    import torch

    from repro_torch.api import compile
    seq_prog = compile("deepseek-moe-16b", policy="sequential")
    cfg = seq_prog.model.cfg
    k = cfg.moe.top_k
    wrs = params["layers"]["moe"]["router"]["wr"]
    batch = prefill_batch(2, 2048, cfg.vocab, dev, SEED + 1)
    rows = [{key: v[b:b + 1] for key, v in batch.items()} for b in range(2)]
    seq1 = seq_prog.prefill(1, 2048)
    recs, want_rows, routes_rows = [], [], []
    for row in rows:
        rec = seq1.fn.realizers["layers"] = _Recorder(
            seq1.fn.realizers["layers"])
        with recorded_routes() as r:
            want_rows.append(seq1(params, row)["logits"])
        recs.append(rec)
        routes_rows.append(r)
        seq1.fn.realizers["layers"] = rec.rz
    want_split = torch.cat(want_rows)
    split_routes = [(torch.cat([xa, xb]), torch.cat([va, vb]))
                    for (xa, va), (xb, vb) in zip(*routes_rows)]
    seq2 = seq_prog.prefill(2, 2048)
    with recorded_routes() as seq_routes:
        want_full = seq2(params, batch)["logits"]
    ok, runs = True, {}
    for policy, strategy, want, want_routes in (
            ("dynamic", "dbo", want_split, split_routes),
            ("comet", "comet", want_full, seq_routes)):
        step = compile("deepseek-moe-16b", policy=policy).prefill(2, 2048)
        t0 = time.perf_counter()
        with recorded_routes() as routes:
            got, counts = counted(totals,
                                  lambda: step(params, batch)["logits"])
        dt = time.perf_counter() - t0
        err = rel_err(got, want)
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        share, unexplained = route_check(routes, want_routes,
                                         list(wrs), k)
        finite = bool(torch.isfinite(got.float()).all())
        this_ok = (finite and unexplained == 0
                   and step.strategies.get("layers") == strategy
                   and counts.get("grouped_ffn", 0) > 0)
        run = {"strategies": step.strategies,
               "against": ("two sequential B=1 runs" if policy == "dynamic"
                           else "sequential B=2"),
               "rel_err": err, "max_abs_err": max_err(got, want),
               "argmax_agree": agree, "routes_agree_share": share,
               "routes_differing_off_a_near_tie": unexplained,
               "finite": finite, "launches": counts, "prefill_s": dt}
        if policy == "comet":
            this_ok = this_ok and err < 5e-2 and agree >= 0.5
        else:
            per_layer = _dbo_layer_by_layer(step, recs, split_routes, params,
                                            wrs, k)
            run["layer_by_layer"] = per_layer
            this_ok = this_ok and per_layer["ok"]
        runs[policy] = dict(run, ok=this_ok)
        ok = ok and this_ok
    log({"phase": "moe_transparency", "shape": "B=2 S=2048", "runs": runs,
         "gemm_rows_bitwise_at_4096_and_2048_rows":
             _gemm_rows_batch_invariant(dev),
         "tolerance": "comet: relative L2 error of the logits < 5e-2 and "
                      "the same argmax (it re-chunks the same dispatch "
                      "buffer); dbo, layer by layer on the sequential "
                      "runs' inputs: relative L2 error < 1e-2 of x on the "
                      "tokens routed alike and of k, v (GEMM round-off at "
                      "another batch size); both: every differing route "
                      "on a near tie of the reference's router logits",
         "ok": ok})
    return ok


def _gemm_rows_batch_invariant(dev):
    """Whether a row of x @ w comes out bitwise the same in a product of
    4096 rows as in one of 2048 (DBO's merged attention against a B=1
    run), for the merged products of a MoE layer."""
    import torch
    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for name, K, N, dt in (("qkv_proj", 2048, 6144, torch.bfloat16),
                           ("o_proj", 2048, 2048, torch.bfloat16),
                           ("router", 2048, 64, torch.float32)):
        x = torch.randn((4096, K), generator=g, device=dev).to(dt)
        w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(dt)
        out[name] = bool(torch.equal(
            x @ w, torch.cat([x[:2048] @ w, x[2048:] @ w])))
    return out


def _dbo_layer_by_layer(step, recs, seq_routes, params, wrs, k):
    """Each MoE layer of the DBO plan on the sequential B=1 runs' input to
    that layer, against their outputs."""
    import torch
    rz = step.fn.realizers["layers"]
    worst = {"x": 0.0, "k": 0.0, "v": 0.0}
    shares, unexplained = [], 0
    for i, ((in0, out0), (in1, out1)) in enumerate(zip(*[r.calls
                                                         for r in recs])):
        inputs = {key: torch.cat([in0[key], in1[key]]) for key in in0}
        with recorded_routes() as routes:
            got = rz(_layer(params["layers"], i), inputs)
        share, bad = route_check(routes, [seq_routes[i]], [wrs[i]], k)
        shares.append(share)
        unexplained += bad
        same = (routes[0][1].sort(-1).values
                == seq_routes[i][1].sort(-1).values).all(-1)
        for key in worst:
            want = torch.cat([out0[key], out1[key]])
            a, b = (got[key][same], want[same]) if key == "x" else \
                (got[key], want)
            worst[key] = max(worst[key], rel_err(a, b))
    return {"layers": len(shares), "max_rel_err": worst,
            "min_routes_agree_share": min(shares),
            "routes_differing_off_a_near_tie": unexplained,
            "ok": unexplained == 0 and max(worst.values()) < 1e-2}


def phase_ssm_transparency(dev, params, totals, arch):
    """An SSM model at full depth, B=4 S=2048: ``dynamic`` against
    ``sequential`` on the same params and inputs.  ``dynamic`` splits the
    Mamba2 stacks under NanoFlow ([2, 2]) and fuses each invocation of
    zamba2's shared block under TokenWeave."""
    from repro_torch.configs import get_config
    dyn, run, ok = _dyn_vs_seq(get_config(arch), params, 4, dev, totals)
    strat, counts = dyn.strategies, run["launches"]
    mamba = [k for k in strat if k == "layers" or k.startswith("mamba")]
    shared = [k for k in strat if k.startswith("shared_attn@")]
    ok = (ok and bool(mamba)
          and all(strat[k] == "nanoflow" for k in mamba)
          and all(strat[k] == "tokenweave" for k in shared)
          and counts.get("ssd_scan", 0) == 2 * sum(
              s.count for s in dyn.segments if s.key in mamba)
          and counts.get("fused_add_rmsnorm", 0) == len(shared))
    log(dict({"phase": "ssm_transparency", "arch": arch,
              "shape": "B=4 S=2048"}, **run,
             tolerance="relative L2 error of the logits < 5e-2 and the same "
                       "argmax: NanoFlow's halves are the same rows (the SSD "
                       "kernel is batch invariant; cuBLAS may round a row "
                       "differently at another batch size), TokenWeave "
                       "normalizes the unrounded f32 sum",
             ok=ok))
    return ok


# ---------------------------------------------------------------------------
# phase 4: serve (the main path)
# ---------------------------------------------------------------------------


SERVE_LENS = (17, 300, 1000, 2000)
PREFILL_GROUP = (4, 2048)     # the mix's prefill group: (group tier, bucket)


def serve_config(**kw):
    from repro_torch.serve import ServeConfig
    return ServeConfig(**{**dict(
        max_batch=4, s_max=4096, prefill_batch=4,
        prefill_buckets=(32, 64, 128, 256, 512, 1024, 2048)), **kw})


def serve_engine(prog, params, new_tokens, lowered=True, seed=SEED,
                 submit=True, lens=SERVE_LENS, **cfg):
    """An engine with its decode tiers and the mix's prefill group built
    (captured, with graphs) ahead of the requests, and the serve mix
    (prompts of ``lens`` tokens) submitted; ``cfg``: more ServeConfig
    fields (the cache backend, sampling, ``max_batch``)."""
    engine = prog.serve(params, serve_config(lowered=lowered, **cfg))
    engine.warmup(prefill=[PREFILL_GROUP])
    if submit:
        for i, p in enumerate(serve_prompts(prog, seed, lens)):
            engine.submit(serve_request(i, p, new_tokens))
    return engine


def serve_prompts(prog, seed=SEED, lens=SERVE_LENS):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, prog.model.cfg.vocab, n).astype(np.int32)
            for n in lens]


def serve_request(rid, prompt, new_tokens):
    from repro_torch.serve import Request
    return Request(rid, prompt, max_new_tokens=new_tokens)


def prefill_group_ms(engine, prompts):
    """Wall time of one prefill group dispatched through an idle engine
    (staging, the graph's replay or the interpreter, the host's
    bookkeeping), from CUDA events around the dispatch; the group's rows
    are released after."""
    import torch
    reqs = [serve_request(1000 + i, p, 1) for i, p in enumerate(prompts)]
    for r in reqs:
        r.row = engine.cache.allocate(r.rid)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    engine._dispatch_prefill(reqs)
    end.record()
    end.synchronize()
    engine._pending_prefill.clear()
    for r in reqs:
        engine.active.pop(r.row)
        engine.cache.release(r.row)
    return start.elapsed_time(end)


def replay_ms(graph, reps):
    """One graph replayed ``reps`` times back to back, from CUDA events."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def build_s(prog):
    """Seconds to build the program's (4, 2048) prefill step and its
    decode tiers (trace, schedule, lower or restore)."""
    t0 = time.perf_counter()
    prog.prefill(*PREFILL_GROUP, s_max=4096)
    prog.decode_tiers(4, 4096)
    return time.perf_counter() - t0


def steps_ms(engine, steps):
    """Wall time of one engine step over ``steps`` of them, from CUDA
    events: the stream's time from the first dispatch to the last step's
    end, host gaps included."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        engine.step()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps


def phase_serve(dev, params, gpu, totals, arch="chatglm3-6b"):
    import tempfile

    import torch

    from repro_torch.api import compile
    prog = compile(arch)          # policy: dynamic
    cfg = prog.model.cfg
    cold_build_s = build_s(prog)

    def run(new_tokens, lowered=True, into=None, p=prog):
        """Serve the mix on a warmed engine; the launch counts (added to
        ``into``) cover the run, not the warm-up's captures."""
        engine = serve_engine(p, params, new_tokens, lowered)
        t0 = time.perf_counter()
        done, counts = counted({} if into is None else into, engine.run)
        return engine, done, time.perf_counter() - t0, counts

    def summary(engine, done, wall, counts):
        reqs = sorted(done, key=lambda r: r.rid)
        st = engine.stats
        return {"wall_s": wall,
                "tokens_per_s": sum(len(r.output) for r in reqs) / wall,
                "ttft_s": [r.first_token_s - r.submitted_s for r in reqs],
                "outputs_head": [r.output[:4] for r in reqs],
                "stats": {k: v for k, v in st.items() if k != "plan_store"},
                "launches": counts}

    first = run(2)[0]             # warm-up: trace, schedule, JIT
    tier_builds = first.stats["tier_builds"]
    del first
    run(2, lowered=False)
    torch.cuda.reset_peak_memory_stats()
    engine, done, wall, counts = run(16, into=totals)
    peak = torch.cuda.max_memory_allocated() / 1e9
    reqs = sorted(done, key=lambda r: r.rid)
    graphs = summary(engine, done, wall, counts)
    ok = (len(reqs) == 4 and all(r.ok and len(r.output) == 16 for r in reqs)
          and all(0 <= t < cfg.vocab for r in reqs for t in r.output))
    for name in SERVE_KERNELS[cfg.family]:
        ok = ok and counts.get(name, 0) > 0
    st = engine.stats
    ok = ok and st["graph_replays"] == st["decode_steps"] > 0
    ok = ok and st["prefill_graph_replays"] == st["prefill_steps"] > 0
    # the interpreter on the same mix: its launches are not the main
    # path's, so they stay out of the totals
    i_engine, i_done, i_wall, i_counts = run(16, lowered=False)
    interp = summary(i_engine, i_done, i_wall, i_counts)
    tokens = [r.output for r in reqs]
    tokens_equal = tokens == [
        r.output for r in sorted(i_done, key=lambda r: r.rid)]
    ok = ok and tokens_equal and i_counts == counts
    del engine, i_engine
    # one warm (4, 2048) prefill group through idle engines, graph and
    # interpreter in turns, then the group's graph replayed alone (it
    # rewrites the engine's state, which is thrown away after)
    prompts = serve_prompts(prog)
    engines = {"graphs": serve_engine(prog, params, 1, submit=False),
               "interpreter": serve_engine(prog, params, 1, lowered=False,
                                           submit=False)}
    prefill_ms = {k: [] for k in engines}
    for order in (("graphs", "interpreter"), ("interpreter", "graphs")):
        for k in order:
            prefill_ms[k].append(prefill_group_ms(engines[k], prompts))
    prefill_replay_ms = replay_ms(
        engines["graphs"]._group_graph("prefill", *PREFILL_GROUP), 3)
    del engines
    # the steady tier-4 decode step, graphs and interpreter in turns,
    # past the prefill and three decode steps
    engines = {"graphs": serve_engine(prog, params, 64),
               "interpreter": serve_engine(prog, params, 64, lowered=False)}
    steady = steady_pair(engines)
    # the tier-4 graph replayed back to back, alone
    decode_replay_ms = replay_ms(engines["graphs"]._graph(4), 10)
    del engines
    gc.collect()
    store = prog.stats
    # warm start: a fresh program opened on the saved store builds its
    # steps and serves the mix without a single lower() call
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "plans.dfps")
        saved = prog.store.save(path)
        warm = compile(arch, plan_store_path=path)
        warm_build_s = build_s(warm)
        w_engine, w_done, w_wall, _ = run(16, p=warm)
        w_tokens = [r.output for r in sorted(w_done, key=lambda r: r.rid)]
        warm_store = warm.stats
        del w_engine, warm
    warm_ok = (warm_store["misses"] == 0 and warm_store["restore_hits"] > 0
               and warm_store["restore_rejected"] == 0
               and w_tokens == tokens)
    ok = ok and warm_ok
    gc.collect()
    log({"phase": PREFIX[cfg.family] + "serve",
         "arch": arch, "gpu": gpu, "prompt_lens": list(SERVE_LENS),
         "new_tokens": 16, **graphs,
         "interpreter": interp, "tokens_equal": tokens_equal,
         "launches_equal": i_counts == counts,
         "prefill_step_ms": prefill_ms,
         "prefill_graph_replay_ms": prefill_replay_ms,
         "prefill_capture_s": st["prefill_capture_s"],
         "steady_decode_step_ms": steady, "graph_replay_ms": decode_replay_ms,
         "tier_builds": tier_builds, "plan_store": store,
         "warm_start": {"saved_entries": saved, "cold_build_s": cold_build_s,
                        "warm_build_s": warm_build_s, "wall_s": w_wall,
                        "tokens_equal": w_tokens == tokens,
                        "plan_store": warm_store, "ok": warm_ok},
         "strategies": {f"{ph}:{b}x{s}" + ("" if lo else ":interpreted"):
                        fwd.strategies
                        for (ph, b, s, lo, _g), fwd
                        in prog._serve_steps.items()},
         "peak_mem_gb": peak, "ok": ok})
    return ok


# ---------------------------------------------------------------------------
# phase 4b: lifecycle — chunked prefill and the request lifecycle
# ---------------------------------------------------------------------------


LONG_LENS = (2500, 3000, 4000)  # > the largest bucket (2048): chunked
LIFE_LENS = (300, 1000, 17, 500, 40, 40, 200, 100)  # lifecycle_run's, by rid
CHUNK_GROUP = (4, 2048)       # the three first chunks, packed (one padded)
# the groups the chunk mix dispatches: the 17-token prompt's, then one
# request as each row frees; the first chunks, then each final chunk
MIX_PREFILL_GROUPS = ((1, 32), (1, 512), (1, 1024), (1, 2048))
MIX_CHUNK_GROUPS = (CHUNK_GROUP, (1, 512), (1, 1024), (1, 2048))


def long_prompts(prog, lens=LONG_LENS, seed=SEED + 7):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, prog.model.cfg.vocab, n).astype(np.int32)
            for n in lens]


def chunk_step_ms(engine, prompts):
    """Wall time of one chunk step dispatched through an idle engine
    (staging, the graph's replay or the interpreter, the host's
    bookkeeping) from CUDA events around the dispatch: the first chunks
    of ``prompts``, packed into one group.  The rows are released after
    (their caches are left as the step wrote them)."""
    import torch
    reqs = [serve_request(2000 + i, p, 1) for i, p in enumerate(prompts)]
    for r in reqs:
        engine._start_chunked(r, engine.cache.allocate(r.rid))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    engine._step_chunked()
    end.record()
    end.synchronize()
    engine._chunking.clear()
    for r in reqs:
        engine.active.pop(r.row, None)
        engine.cache.release(r.row)
    return start.elapsed_time(end)


def chunk_mix(prog, params, lowered, into):
    """The long prompts, then the serve mix behind them, 16 greedy tokens
    each, on an engine with every decode tier, prefill group and chunk
    group the run uses built ahead (captured, with graphs); the launch
    counts (added to ``into``) cover the run.  The long prompts take
    three rows and chunk; the 17-token prompt takes the fourth and is
    prefilled ahead of their first chunk group, the others wait for
    rows."""
    engine = prog.serve(params, serve_config(lowered=lowered))
    engine.warmup(prefill=MIX_PREFILL_GROUPS, chunks=MIX_CHUNK_GROUPS)
    for i, p in enumerate(long_prompts(prog) + serve_prompts(prog)):
        engine.submit(serve_request(i, p, 16))
    t0 = time.perf_counter()
    done, counts = counted(into, engine.run)
    return engine, sorted(done, key=lambda r: r.rid), \
        time.perf_counter() - t0, counts


def lifecycle_run(prog, params, lowered=True):
    """The request lifecycle on one engine, step by step: a BoundedQueue
    shed and an expired deadline at the door, an injected prefill
    dispatch fault, a priority preemption resumed, then ``drain()``.
    Returns the log entry, whether every check held, and each request's
    (result, tokens)."""
    import numpy as np

    from repro_torch.serve import (BoundedQueue, DeadlineExceeded, Failed,
                                   FaultInjector, Finished, Overloaded,
                                   Request, Shed)
    vocab = prog.model.cfg.vocab
    rng = np.random.default_rng(SEED + 11)

    def prompt(n):
        return rng.integers(0, vocab, n).astype(np.int32)

    # a deterministic schedule: the second prefill dispatch (#1, one
    # request) fails; #0 holds three requests
    fault_at = 1
    faults = FaultInjector(dispatch_fail=(("prefill", fault_at),),
                           seed=SEED)
    engine = prog.serve(params, serve_config(admission=BoundedQueue(3),
                                             faults=faults, lowered=lowered))
    n = LIFE_LENS
    b = engine._bucket
    engine.warmup(prefill=[(4, b(max(n[:3]))), (1, b(n[6])), (1, b(n[7]))])
    reqs = {}

    def submit(rid, new, **kw):
        reqs[rid] = Request(rid, prompt(n[rid]), max_new_tokens=new, **kw)
        return engine.submit(reqs[rid])

    t0 = time.perf_counter()
    for rid in (0, 1, 2):
        submit(rid, 48)
    shed = submit(3, 16)                      # the queue holds 3: shed
    late = submit(4, 16, deadline_s=0.0)      # expired at the door
    engine.step()                             # prefill #0: rids 0, 1, 2
    submit(5, 16)
    engine.step()                             # prefill #1: the fault
    submit(6, 32)
    engine.step()                             # prefill #2: the pool full
    engine.step()
    engine.step()
    submit(7, 8, priority=5)
    engine.step()                             # preempts rid 6, admits 7
    n_before = len(reqs[6].output)             # tokens before the resume
    it = 0
    while not (reqs[6].row >= 0 and reqs[6].output
               and reqs[6].output[-1] != -100) and it < 200:
        engine.step()                         # until rid 6 resumes
        it += 1
    report = engine.drain()
    wall = time.perf_counter() - t0
    st = engine.stats
    kinds = {"finished": 0, "shed": 0, "failed": 0}
    for r in engine.finished:
        kinds[{Finished: "finished", Shed: "shed",
               Failed: "failed"}[type(r.result)]] += 1
    # rid 6 uninterrupted, on a fresh engine (reported, not required: the
    # resume re-prefills its generated tokens through the prefill path,
    # whose bf16 GEMMs and flash attention round differently from the
    # decode steps that first produced them)
    solo = prog.serve(params, serve_config(lowered=lowered))
    solo.submit(Request(6, reqs[6].prompt.copy(), max_new_tokens=32))
    solo_out = solo.run()[0].output
    checks = {
        "each_terminated_once": (
            len(engine.finished) == len(reqs) == st["submitted"]
            and len({id(r) for r in engine.finished}) == len(reqs)
            and all(r.done_s > 0 and r.row == -1 for r in engine.finished)),
        "counters_agree": (
            kinds == {k: st[k] for k in kinds}
            and sum(kinds.values()) == st["submitted"]),
        "rows_free": (len(engine.cache.free_rows) == engine.cfg.max_batch
                      and engine.cache.row_owner == {}
                      and report["free_rows"] == engine.cfg.max_batch
                      and report["stranded"] == []),
        "failed_equals_injected": (
            st["failed"] == faults.counts.get("dispatch_fail", 0) == 1
            and isinstance(reqs[5].result, Failed)),
        "bounded_queue_shed": (isinstance(shed, Shed)
                               and isinstance(shed.reason, Overloaded)
                               and isinstance(reqs[3].result, Shed)),
        "deadline_shed": (isinstance(late, Shed)
                          and isinstance(late.reason, DeadlineExceeded)
                          and st["deadline_missed"] == 1),
        "preempted_and_resumed": (
            st["preempted"] == 1 and st["resumed"] >= 1
            and reqs[6].preemptions == 1 and reqs[6].ok
            and len(reqs[6].output) == 32),
        "priority_first": (reqs[7].ok
                           and reqs[7].first_token_s < reqs[6].done_s),
        "graphs_only": not lowered or (
            st["graph_replays"] == st["decode_steps"]
            and st["prefill_graph_replays"] == st["prefill_steps"]
            and st["chunk_graph_replays"] == st["chunk_steps"])}
    first_diff = next((i for i, (a, b) in enumerate(
        zip(reqs[6].output, solo_out)) if a != b), None)
    entry = {"wall_s": wall, "fault_at_prefill_dispatch": fault_at,
             "resumed_tokens_equal_uninterrupted": reqs[6].output == solo_out,
             "resumed_first_differing_token": first_diff,
             "resumed_at_token": n_before,
             "results": {r.rid: (type(r.result).__name__,
                                 str(getattr(r.result, "reason", "")))
                         for r in sorted(engine.finished,
                                         key=lambda r: r.rid)},
             "drain": report, "faults": faults.counts,
             "stats": {k: st[k] for k in (
                 "submitted", "admitted", "finished", "shed", "failed",
                 "preempted", "resumed", "deadline_missed", "stranded",
                 "drains", "prefill_steps", "chunk_steps", "decode_steps",
                 "peak_active")},
             "checks": checks}
    out = {r.rid: (type(r.result).__name__, list(r.output))
           for r in engine.finished}
    del engine, solo
    return entry, all(checks.values()), out


def phase_lifecycle(dev, params, gpu, totals, arch="chatglm3-6b"):
    """Chunked prefill on prompts longer than the largest bucket with the
    serve mix behind them, with graphs and with the interpreter; a chunk
    step timed through the engine and its graph replayed alone; then the
    request lifecycle."""
    import torch

    from repro_torch.api import compile
    prog = compile(arch)
    cfg = prog.model.cfg
    chunk_mix(prog, params, True, {})         # warm-up: build, capture
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    engine, reqs, wall, counts = chunk_mix(prog, params, True, totals)
    peak = torch.cuda.max_memory_allocated() / 1e9
    st = engine.stats
    i_engine, i_reqs, i_wall, i_counts = chunk_mix(prog, params, False, {})
    tokens = [r.output for r in reqs]
    tokens_equal = tokens == [r.output for r in i_reqs]
    long_rids = range(len(LONG_LENS))
    chunks_of = {rid: sum(1 for kind, rids in engine.dispatch_log
                          if kind == "chunk" and rid in rids)
                 for rid in long_rids}
    ok = (len(reqs) == len(SERVE_LENS) + len(LONG_LENS)
          and all(r.ok and len(r.output) == 16 for r in reqs)
          and all(0 <= t < cfg.vocab for r in reqs for t in r.output)
          and tokens_equal and i_counts == counts
          and engine.dispatch_log == i_engine.dispatch_log
          and all(n >= 2 for n in chunks_of.values())
          and st["chunk_graph_replays"] == st["chunk_steps"] > 0
          and st["graph_replays"] == st["decode_steps"]
          and st["prefill_graph_replays"] == st["prefill_steps"])
    for name in SERVE_KERNELS[cfg.family]:
        ok = ok and counts.get(name, 0) > 0
    stats = {k: v for k, v in st.items() if k != "plan_store"}
    dispatch_log = [[kind, list(rids)] for kind, rids in engine.dispatch_log]
    del engine, i_engine
    gc.collect()
    # one warm chunk step of the (4, 2048) group through idle engines,
    # graph and interpreter in turns, then its graph replayed alone
    prompts = long_prompts(prog)
    engines = {"graphs": serve_engine(prog, params, 1, submit=False),
               "interpreter": serve_engine(prog, params, 1, lowered=False,
                                           submit=False)}
    for e in engines.values():
        e.warmup(chunks=[CHUNK_GROUP])
    step_ms = {k: [] for k in engines}
    for order in (("graphs", "interpreter"), ("interpreter", "graphs")):
        for k in order:
            step_ms[k].append(chunk_step_ms(engines[k], prompts))
    chunk_replay_ms = replay_ms(
        engines["graphs"]._group_graph("chunk", *CHUNK_GROUP), 3)
    del engines
    gc.collect()
    (lifecycle, life_ok, life_out), _ = counted(
        totals, lambda: lifecycle_run(prog, params))
    i_life, i_life_ok, i_life_out = lifecycle_run(prog, params,
                                                  lowered=False)
    lifecycle["interpreter"] = i_life
    lifecycle["tokens_equal_interpreter"] = life_out == i_life_out
    ok = ok and life_ok and i_life_ok and life_out == i_life_out
    gc.collect()
    log({"phase": "lifecycle", "arch": arch, "gpu": gpu,
         "prompt_lens": list(LONG_LENS) + list(SERVE_LENS),
         "new_tokens": 16, "wall_s": wall,
         "tokens_per_s": sum(len(t) for t in tokens) / wall,
         "ttft_s": [r.first_token_s - r.submitted_s for r in reqs],
         "outputs_head": [r.output[:4] for r in reqs],
         "chunks_per_long_prompt": chunks_of,
         "dispatch_log": dispatch_log,
         "stats": stats, "launches": counts,
         "interpreter": {"wall_s": i_wall,
                         "ttft_s": [r.first_token_s - r.submitted_s
                                    for r in i_reqs],
                         "launches": i_counts},
         "tokens_equal": tokens_equal, "launches_equal": i_counts == counts,
         "chunk_step_ms": step_ms, "chunk_graph_replay_ms": chunk_replay_ms,
         "peak_mem_gb": peak, "lifecycle": lifecycle, "ok": ok})
    return ok


def phase_moe_chunked(dev, params, totals, arch="deepseek-moe-16b"):
    """One 3000-token request (chunks of 2048 and 1024) through the chunk
    graphs, captured ahead, held to the interpreter: tokens and launch
    counts."""
    from repro_torch.api import compile
    prog = compile(arch)
    prompt = long_prompts(prog, lens=(3000,))[0]
    runs = {}
    for lowered, into in ((True, {}), (True, totals), (False, {})):
        engine = prog.serve(params, serve_config(lowered=lowered))
        engine.warmup(chunks=[(1, c) for _, c in
                              engine._chunk_plan(len(prompt))])
        engine.submit(serve_request(0, prompt, 16))
        t0 = time.perf_counter()
        done, counts = counted(into, engine.run)
        runs[lowered] = (engine, done[0], time.perf_counter() - t0, counts)
    (g, r, wall, counts), (_, ri, i_wall, i_counts) = runs[True], runs[False]
    st = g.stats
    ok = (r.ok and len(r.output) == 16 and r.output == ri.output
          and counts == i_counts and st["chunk_steps"] == 2
          and st["chunk_graph_replays"] == st["chunk_steps"]
          and counts.get("grouped_ffn", 0) > 0)
    log({"phase": "moe_chunked", "arch": arch, "prompt_len": len(prompt),
         "wall_s": wall, "interpreter_wall_s": i_wall,
         "ttft_s": r.first_token_s - r.submitted_s,
         "outputs_head": r.output[:4], "tokens_equal": r.output == ri.output,
         "launches": counts, "launches_equal": counts == i_counts,
         "chunk_steps": st["chunk_steps"],
         "chunk_graph_replays": st["chunk_graph_replays"],
         "strategies": {f"{ph}:{b}x{s}": fwd.strategies
                        for (ph, b, s, lo, _g), fwd
                        in prog._serve_steps.items() if ph == "chunk"},
         "ok": ok})
    return ok


# ---------------------------------------------------------------------------
# phase 4c: paged — the paged KV cache
# ---------------------------------------------------------------------------


PAGE = 16
# part 2's traffic: the mix's prompts four times, 64 greedy tokens each
MANY_LENS = SERVE_LENS * 4
MANY_TOKENS = 64
POOL_PAGES = 1024             # 16384 tokens: the dense max_batch=4 pool's
SMALL_POOL_PAGES = 512        # part 3: half of it, under pressure


def paged_cache(num_pages=None):
    from repro_torch.serve import PagedCache
    return PagedCache(page_size=PAGE, num_pages=num_pages)


def served(engine, into=None):
    """Run an engine to the end with its launches counted (added to
    ``into``): (requests by rid, wall seconds, counts)."""
    t0 = time.perf_counter()
    done, counts = counted({} if into is None else into, engine.run)
    wall = time.perf_counter() - t0
    return sorted(done, key=lambda r: r.rid), wall, counts


def tokens_of(reqs):
    return [list(r.output) for r in reqs]


def paging_ms(engine, tier):
    """The paged decode step's gather (the tier's pages into its (tier,
    s_max) views) and frontier scatter, called alone on the engine's pool
    and page table as staged: ``{"gather": ..., "scatter": ...}``, each
    ``{"ms": CUDA events over back-to-back calls (the host's launches
    where they cost more), "device_ms": the kernels' durations alone,
    "device_ms_by": how}``.  The scatter rewrites each row's frontier
    page with what the gather read, so the pool is unchanged."""
    cache = engine.cache
    pages, clen = engine._step_pages, engine._step_in[3]
    view = cache.gather_rows(cache.caches, pages, tier)
    out = {}
    for name, fn in (
            ("gather", lambda: cache.gather_rows(cache.caches, pages, tier)),
            ("scatter", lambda: cache.scatter_frontier(
                cache.caches, view, pages, clen, tier))):
        dev_ms, by = device_ms([fn], iters=10)
        out[name] = {"ms": cuda_ms(fn, iters=10), "device_ms": dev_ms,
                     "device_ms_by": by}
    return out


def steady_pair(engines, steps=8):
    """The steady tier-4 step of each engine (CUDA events over ``steps``
    engine steps) in turns, twice, past the prefill and three decode
    steps."""
    for e in engines.values():
        for _ in range(4):
            e.step()
    out = {k: [] for k in engines}
    for _ in range(2):
        for k, e in engines.items():
            out[k].append(steps_ms(e, steps))
    return out


def step_profile(engine, steps=16):
    """A window of decode steps under the profiler: the step's device
    time and its top kernels (paged: the gather's ``index_select`` and
    the scatter's ``index_copy_`` among them)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            # names cut to 80 characters; kernels that share the cut add
            by_name[e.key[:80]] = by_name.get(e.key[:80], 0.0) + _dev_us(e)
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)
    return {"device_ms_per_step": sum(by_name.values()) / 1e3 / steps,
            "top_kernels_ms_per_step": {k: us / 1e3 / steps
                                        for k, us in top[:12]}}


def phase_paged(dev, params, gpu, totals, arch="chatglm3-6b"):
    """chatglm3-6b on the paged cache: the mix against the dense cache
    (tokens, steady step, the gather and scatter), 16 requests resident
    in the dense 4-row pool's bytes, and the same traffic in half that
    pool (page denials, preemption, no leak)."""
    import torch

    from repro_torch.api import compile
    prog = compile(arch)
    cfg = prog.model.cfg
    paged = paged_cache()
    served(serve_engine(prog, params, 2, cache=paged))     # builds
    # part 1: the 4-request mix, paged (graphs, interpreter) and dense
    torch.cuda.reset_peak_memory_stats()
    g, g_wall, g_counts = served(
        serve_engine(prog, params, 16, cache=paged), into=totals)
    mix_peak = torch.cuda.max_memory_allocated() / 1e9
    i, _, i_counts = served(serve_engine(prog, params, 16, lowered=False,
                                         cache=paged))
    d, d_wall, d_counts = served(serve_engine(prog, params, 16))
    mix_equal = tokens_of(g) == tokens_of(i) == tokens_of(d)
    ok = (mix_equal and g_counts == i_counts
          and all(r.ok and len(r.output) == 16 for r in g)
          and all(0 <= t < cfg.vocab for r in g for t in r.output))
    for name in SERVE_KERNELS[cfg.family]:
        ok = ok and g_counts.get(name, 0) > 0
    engines = {"paged": serve_engine(prog, params, 64, cache=paged),
               "dense": serve_engine(prog, params, 64)}
    steady = steady_pair(engines)
    st = engines["paged"].stats
    ok = ok and st["graph_replays"] == st["decode_steps"] > 0
    ok = ok and st["prefill_graph_replays"] == st["prefill_steps"] > 0
    paging = paging_ms(engines["paged"], 4)
    profiles = {k: step_profile(e) for k, e in engines.items()}
    for e in engines.values():
        e.run()
    ok = ok and engines["paged"].cache.pages_used() == 0
    del engines
    gc.collect()
    # part 2: 16 requests at max_batch=16 in the dense 4-row pool's bytes
    many = dict(lens=MANY_LENS, max_batch=16)
    runs = {}
    for name, kw in (("paged", dict(cache=paged_cache(POOL_PAGES), **many)),
                     ("paged_interpreter",
                      dict(cache=paged_cache(POOL_PAGES), lowered=False,
                           **many)),
                     ("dense_max_batch_4", dict(lens=MANY_LENS))):
        torch.cuda.reset_peak_memory_stats()
        engine = serve_engine(prog, params, MANY_TOKENS, **kw)
        reqs, wall, counts = served(
            engine, into=totals if name == "paged" else None)
        drained = engine.drain()
        runs[name] = dict(
            engine=engine, reqs=reqs, counts=counts,
            summary={"wall_s": wall,
                     "tokens_per_s": sum(len(r.output) for r in reqs) / wall,
                     "max_ttft_s": max(r.first_token_s - r.submitted_s
                                       for r in reqs),
                     "peak_active": engine.stats["peak_active"],
                     "tier_steps": engine.stats["tier_steps"],
                     "kv": engine.stats["kv"],
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "drain": {k: drained[k] for k in
                               ("finished", "free_rows", "stranded")}})
        del engine
        gc.collect()
    pg, pi = runs["paged"], runs["paged_interpreter"]
    st = pg["engine"].stats
    many_ok = (len(pg["reqs"]) == 16 and all(r.ok and len(r.output)
                                              == MANY_TOKENS
                                              for r in pg["reqs"])
               and st["peak_active"] == 16
               and tokens_of(pg["reqs"]) == tokens_of(pi["reqs"])
               and pg["counts"] == pi["counts"]
               and st["graph_replays"] == st["decode_steps"]
               and st["prefill_graph_replays"] == st["prefill_steps"]
               and all(r["engine"].cache.pages_used() == 0
                       for k, r in runs.items() if k != "dense_max_batch_4"))
    ok = ok and many_ok
    # part 3: the same traffic in half the pool
    engine = serve_engine(prog, params, MANY_TOKENS,
                          cache=paged_cache(SMALL_POOL_PAGES), **many)
    reqs, small_wall, _ = served(engine)
    engine.drain()
    rids = sorted(r.rid for r in engine.finished)
    st = engine.stats
    small_ok = (st["page_denied"] > 0 and rids == list(range(16))
                and all(r.result is not None for r in reqs)
                and engine.cache.pages_used() == 0
                and engine.cache.row_owner == {}
                and len(engine.cache.free_rows) == 16
                and st["finished"] + st["shed"] + st["failed"] == 16)
    ok = ok and small_ok
    small = {"wall_s": small_wall,
             "tokens_per_s": sum(len(r.output) for r in reqs) / small_wall,
             "results": sorted({type(r.result).__name__ for r in reqs}),
             **{k: st[k] for k in ("page_denied", "preempted", "resumed",
                                   "finished", "failed", "peak_active")},
             "kv": st["kv"], "ok": small_ok}
    del engine
    gc.collect()
    log({"phase": "paged", "arch": arch, "gpu": gpu, "page_size": PAGE,
         "mix": {"prompt_lens": list(SERVE_LENS), "new_tokens": 16,
                 "tokens_equal": mix_equal,
                 "launches_equal": g_counts == i_counts,
                 "tokens_per_s": {"paged": 64 / g_wall, "dense": 64 / d_wall},
                 "outputs_head": [r.output[:4] for r in g],
                 "launches": g_counts, "peak_mem_gb": mix_peak,
                 "steady_decode_step_ms": steady, "paging": paging,
                 "decode_profile": profiles},
         "many": {"prompt_lens": list(MANY_LENS), "new_tokens": MANY_TOKENS,
                  "pool_pages": POOL_PAGES,
                  "tokens_equal": tokens_of(pg["reqs"])
                  == tokens_of(pi["reqs"]),
                  "launches_equal": pg["counts"] == pi["counts"],
                  "tokens_equal_dense_max_batch_4": tokens_of(pg["reqs"])
                  == tokens_of(runs["dense_max_batch_4"]["reqs"]),
                  **{k: r["summary"] for k, r in runs.items()},
                  "ok": many_ok},
         "small_pool": {"pool_pages": SMALL_POOL_PAGES, **small},
         "ok": ok})
    return ok


def phase_moe_paged(dev, params, totals, arch="deepseek-moe-16b"):
    """deepseek-moe-16b's mix on the paged cache against the dense one
    and the paged interpreter; the steady tier-4 step both ways in turns
    and the gather and scatter alone."""
    from repro_torch.api import compile
    prog = compile(arch)
    paged = paged_cache()
    g, g_wall, g_counts = served(
        serve_engine(prog, params, 16, cache=paged), into=totals)
    i, _, i_counts = served(serve_engine(prog, params, 16, lowered=False,
                                         cache=paged))
    d, d_wall, _ = served(serve_engine(prog, params, 16))
    equal = tokens_of(g) == tokens_of(i) == tokens_of(d)
    ok = (equal and g_counts == i_counts and all(r.ok for r in g)
          and g_counts.get("grouped_ffn", 0) > 0)
    engines = {"paged": serve_engine(prog, params, 64, cache=paged),
               "dense": serve_engine(prog, params, 64)}
    steady = steady_pair(engines)
    st = engines["paged"].stats
    ok = ok and st["graph_replays"] == st["decode_steps"] > 0
    paging = paging_ms(engines["paged"], 4)
    profiles = {k: step_profile(e) for k, e in engines.items()}
    for e in engines.values():
        e.run()
    ok = ok and engines["paged"].cache.pages_used() == 0
    del engines
    gc.collect()
    log({"phase": "moe_paged", "arch": arch, "tokens_equal": equal,
         "decode_profile": profiles,
         "launches_equal": g_counts == i_counts,
         "tokens_per_s": {"paged": 64 / g_wall, "dense": 64 / d_wall},
         "steady_decode_step_ms": steady, "paging": paging,
         "outputs_head": [r.output[:4] for r in g],
         "ok": ok})
    return ok


# ---------------------------------------------------------------------------
# phase 4d: sampling — temperature, top-k and top-p on the device
# ---------------------------------------------------------------------------


SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)


def phase_sampling(dev, params, gpu, totals, arch="chatglm3-6b"):
    """chatglm3-6b's mix sampled: graphs against the interpreter, a fresh
    engine with the same seed, ``SamplingConfig()`` against the default
    greedy engine, the generator's bits on the card against the CPU's,
    and tokens of fixed logits on the card against the CPU's."""
    import numpy as np
    import torch

    from repro_torch.api import compile
    from repro_torch.serve import SamplingConfig
    from repro_torch.serve import sampling as tsamp
    prog = compile(arch)
    vocab = prog.model.cfg.vocab
    sampled = SamplingConfig(**SAMPLED)
    served(serve_engine(prog, params, 2, sampling=sampled))   # builds
    s, s_wall, s_counts = served(
        serve_engine(prog, params, 16, sampling=sampled),
        into=totals)
    i, _, i_counts = served(serve_engine(prog, params, 16, lowered=False,
                                         sampling=sampled))
    again, _, _ = served(serve_engine(prog, params, 16, sampling=sampled))
    greedy_cfg, gc_wall, _ = served(
        serve_engine(prog, params, 16, sampling=SamplingConfig()))
    greedy, g_wall, _ = served(serve_engine(prog, params, 16))
    checks = {
        "graphs_equal_interpreter": tokens_of(s) == tokens_of(i),
        "launches_equal": s_counts == i_counts,
        "same_seed_repeats": tokens_of(s) == tokens_of(again),
        "in_vocab": all(0 <= t < vocab for r in s for t in r.output),
        "all_finished": all(r.ok and len(r.output) == 16 for r in s),
        "greedy_config_equals_default":
            tokens_of(greedy_cfg) == tokens_of(greedy),
        "differs_from_greedy": tokens_of(s) != tokens_of(greedy)}
    # the generator's bits: a (seed, rid, position) grid on both devices
    rng = np.random.default_rng(SEED)
    seeds = torch.from_numpy(rng.integers(0, 1 << 32, 256, dtype=np.uint64)
                             .astype(np.uint32).view(np.int32))
    rids = torch.from_numpy(rng.integers(0, 1 << 31, 256))
    pos = torch.from_numpy(rng.integers(0, 1 << 20, 256))
    cpu_bits = tsamp.random_bits(seeds, rids, pos, vocab)
    gpu_bits = tsamp.random_bits(seeds.to(dev), rids.to(dev), pos.to(dev),
                                 vocab)
    checks["bits_equal_cpu"] = torch.equal(gpu_bits.cpu(), cpu_bits)
    del cpu_bits, gpu_bits
    # tokens of fixed logits (64 rows at the vocab) on both devices
    logits = torch.from_numpy(rng.standard_normal((64, vocab))
                              .astype(np.float32) * 3)
    kw = dict(seeds=seeds[:64], rids=rids[:64], positions=pos[:64])
    cpu_tok = tsamp.sample_tokens(logits, sampled, **kw)
    gpu_tok = tsamp.sample_tokens(logits.to(dev), sampled,
                                  **{k: v.to(dev) for k, v in kw.items()})
    agree = float((gpu_tok.cpu() == cpu_tok).float().mean())
    ok = all(checks.values())
    engines = {"sampled": serve_engine(prog, params, 64, sampling=sampled),
               "greedy": serve_engine(prog, params, 64)}
    steady = steady_pair(engines)
    for e in engines.values():
        e.run()
    del engines
    gc.collect()
    log({"phase": "sampling", "arch": arch, "gpu": gpu, "sampling": SAMPLED,
         "checks": checks, "cpu_gpu_token_agreement": agree,
         "tokens_per_s": {"sampled": 64 / s_wall, "greedy": 64 / g_wall,
                          "greedy_config": 64 / gc_wall},
         "steady_decode_step_ms": steady,
         "outputs_head": [r.output[:4] for r in s], "launches": s_counts,
         "ok": ok})
    return ok


# ---------------------------------------------------------------------------
# phase 4e: spec — speculative decode inside the served graphs
# ---------------------------------------------------------------------------

SPEC_COUNTERS = ("spec_steps", "spec_drafted", "spec_accepted",
                 "spec_rollbacks", "spec_fallbacks", "page_denied",
                 "decode_steps", "tier_steps")
SPEC_KS = (2, 4, 8)
# Plain decode's top-1 minus top-2 logit below which the card may choose
# the other token in a verify step: the verify step runs other GEMM row
# counts (tier x W rows, not tier) and the W > 1 attention's plain path
# in place of the decode kernel, so its logits round differently.  Spec
# tokens are held to plain greedy's up to the first position whose
# margin is below this, and not past it.
NEAR_TIE = 0.05


def spec_config(proposer, k):
    from repro_torch.serve import SpecConfig
    return SpecConfig(proposer=proposer, k=k)


def logged_picks(engine):
    """Record the draft length the engine picks at each speculative
    dispatch (a fallback to plain decode included)."""
    picks = []
    pick = engine._pick_k

    def logged():
        picks.append(pick())
        return picks[-1]
    engine._pick_k = logged
    return picks


def spec_run(prog, params, spec, lowered=True, into=None, new_tokens=16,
             **cfg):
    """The mix served with ``spec`` on a warmed engine (decode tiers,
    every verify and draft graph and the prefill group captured first):
    tokens, wall, launch counts (added to ``into``), spec counters, the
    draft length of each step and the lowerings after the warm-up."""
    engine = serve_engine(prog, params, new_tokens, lowered, spec=spec,
                          **cfg)
    misses = engine.store.stats["misses"]
    picks = logged_picks(engine)
    reqs, wall, counts = served(engine, into)
    st = engine.stats
    return {"engine": engine, "tokens": tokens_of(reqs), "wall_s": wall,
            "tokens_per_s": sum(len(r.output) for r in reqs) / wall,
            "launches": counts, "picks": picks,
            "counters": {k: st[k] for k in SPEC_COUNTERS},
            "new_lowers": engine.store.stats["misses"] - misses,
            "ok": all(r.ok for r in reqs)}


@contextlib.contextmanager
def plain_margins():
    """Top-1 minus top-2 of every logits row the engine samples while the
    block runs, by (rid, position) (a later sample of a key wins)."""
    import torch

    from repro_torch.serve import engine as eng_mod
    orig = eng_mod.sample_tokens
    margins: dict = {}

    def sample(logits, cfg, *, seeds, rids, positions):
        tok = orig(logits, cfg, seeds=seeds, rids=rids, positions=positions)
        top = logits.float().topk(2, dim=-1).values
        lead = top.shape[:-1]
        m = (top[..., 0] - top[..., 1]).reshape(-1).tolist()
        r = torch.as_tensor(rids, device=top.device).expand(lead)
        p = torch.as_tensor(positions, device=top.device).expand(lead)
        for key, v in zip(zip(r.reshape(-1).tolist(),
                              p.reshape(-1).tolist()), m):
            margins[key] = v
        return tok
    eng_mod.sample_tokens = sample
    try:
        yield margins
    finally:
        eng_mod.sample_tokens = orig


def near_tie_check(prompts, plain, spec, margins):
    """Spec tokens against plain greedy's: equal up to the first position
    whose plain margin is below ``NEAR_TIE``, not compared past it."""
    rows = []
    for rid, (p, a, b) in enumerate(zip(prompts, spec, plain)):
        n = len(p)
        cut = next((j for j in range(len(b))
                    if margins.get((rid, n + j), float("inf")) < NEAR_TIE),
                   len(b))
        first = next((j for j in range(min(len(a), len(b)))
                      if a[j] != b[j]), None)
        rows.append({"rid": rid, "full_match": a == b,
                     "near_tie_at": cut if cut < len(b) else None,
                     "diverges_at": first,
                     "margin_at_divergence": None if first is None
                     else margins.get((rid, n + first)),
                     "ok": a == b or (first is not None and first >= cut)})
    return {"full_matches": sum(r["full_match"] for r in rows),
            "divergence_positions": [r["diverges_at"] for r in rows],
            "near_tie_positions": [r["near_tie_at"] for r in rows],
            "min_margin": min(margins.values()) if margins else None,
            "rows": rows, "ok": all(r["ok"] for r in rows)}


def oracle_proposer(seqs):
    """A host proposer, through the public ``Proposer`` protocol, that
    drafts the plain greedy run's own continuation of each stream (the
    verify step's best case): ``seqs`` are prompt + plain tokens."""
    import numpy as np

    from repro_torch.serve import Proposer

    class Oracle(Proposer):
        name = "oracle"

        def draft(self, streams, k):
            out = np.zeros((len(streams), k), np.int32)
            for i, s in enumerate(streams):
                s = np.asarray(s, np.int32)
                seq = next((q for q in seqs if len(q) > len(s)
                            and np.array_equal(q[:len(s)], s)), None)
                cont = (seq[len(s):len(s) + k] if seq is not None
                        else s[-1:])
                out[i, :len(cont)] = cont
                out[i, len(cont):] = cont[-1]
            return out

    return Oracle()


def spec_step_ms(engine, ks, tier=4):
    """The tier's verify graph at each k and its plain decode graph,
    each replayed alone, in turns, twice (CUDA events over 5 replays;
    the replays rewrite the engine's state, thrown away after)."""
    graphs = {}
    for k in ks:
        engine._spec_forwards(tier, k)
        graphs[f"verify_k{k}"] = engine._spec_graph("verify", tier, k)
    graphs["plain"] = engine._graph(tier)
    out = {name: [] for name in graphs}
    for _ in range(2):
        for name, g in graphs.items():
            out[name].append(replay_ms(g, 5))
    return out


def verify_profile(engine, k, tier=4, reps=3):
    """One verify step at (tier, k) run eagerly on copies of the engine's
    buffers under the profiler, its device time split into the plain
    W > 1 attention (every kernel under ``DecodeAttentionOp.kernel`` at
    Sq > 1), the GEMMs outside it (aten mm / addmm / bmm / matmul /
    linear) and the rest."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import layers
    orig = layers.DecodeAttentionOp.kernel

    def kernel(op, p, q, *args):
        if q.shape[1] > 1:
            with record_function("plain_attention_w_gt_1"):
                return orig(op, p, q, *args)
        return orig(op, p, q, *args)

    bds = engine.cache.batch_dims

    def run():
        caches = {n: (v.clone() if engine.cache.paged
                      else v.narrow(bds[n], 0, tier).clone())
                  for n, v in engine.cache.caches.items()}
        engine._verify_run(tier, k, engine._last_ids.clone(),
                           engine._step_in.clone(), engine._drafts.clone(),
                           caches, engine._step_pages.clone())
    layers.DecodeAttentionOp.kernel = kernel
    try:
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
    finally:
        layers.DecodeAttentionOp.kernel = orig
    gemm_ops = ("aten::mm", "aten::addmm", "aten::bmm", "aten::matmul",
                "aten::linear")
    # each kernel goes to the bucket of its launching op's outermost
    # attention annotation or GEMM op, else to the rest
    buckets = {"attention": {}, "gemm": {}, "rest": {}}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        where, up = "rest", e
        while up is not None:
            if up.name == "plain_attention_w_gt_1":
                where = "attention"
            elif up.name in gemm_ops and where == "rest":
                where = "gemm"
            up = up.cpu_parent
        for kern in e.kernels:
            b = buckets[where]
            b[kern.name[:60]] = b.get(kern.name[:60], 0.0) + kern.duration
    ms = lambda us: us / 1e3 / reps  # noqa: E731
    sums = {b: sum(v.values()) for b, v in buckets.items()}
    # the kernels alone: the annotation's own device-side range would
    # count its kernels twice
    total = sum(sums.values())
    return {"k": k, "tier": tier, "device_ms": ms(total),
            "plain_w_gt_1_attention_ms": ms(sums["attention"]),
            "gemm_ms": ms(sums["gemm"]), "rest_ms": ms(sums["rest"]),
            "attention_share": sums["attention"] / total if total else None,
            "top_kernels_ms": {b: {n: ms(us) for n, us in sorted(
                v.items(), key=lambda kv: -kv[1])[:6]}
                for b, v in buckets.items()},
            "measured_by": "profiler" if total else "not measured"}


def phase_spec(dev, params, gpu, totals, arch="chatglm3-6b"):
    """chatglm3-6b: speculative decode of the mix at tier 4, with graphs
    against the interpreter, against plain greedy by the near-tie rule,
    an oracle proposer's best case, the verify step's cost against the
    plain step, its profile, and ``k="auto"``'s pick."""
    import numpy as np

    from repro_torch.api import compile
    prog = compile(arch)                       # policy: dynamic
    prompts = serve_prompts(prog)
    # plain greedy: graphs, then the interpreter with its logits' margins
    plain = spec_run(prog, params, None)
    with plain_margins() as margins:
        plain_i = spec_run(prog, params, None, lowered=False)
    ok = plain["ok"] and plain_i["tokens"] == plain["tokens"]
    arms, checks = {}, {}
    for name, spec in {"ngram_k4": spec_config("ngram", 4),
                       "self_k4": spec_config("self", 4),
                       "auto_k": spec_config("ngram", "auto")}.items():
        for cache in ("dense", "paged"):
            cfg = {} if cache == "dense" else {"cache": paged_cache()}
            # the graphed ngram arm on the dense cache is the main path's
            main = name == "ngram_k4" and cache == "dense"
            # k="auto" asks the policy's spec_draft_k: each of its runs
            # starts from a fresh autotuner (no observation yet)
            progs = [prog, prog] if name != "auto_k" else [
                compile(arch, policy="auto") for _ in range(2)]
            g = spec_run(progs[0], params, spec,
                         into=totals if main else None, **cfg)
            i = spec_run(progs[1], params, spec, lowered=False, **cfg)
            st = g["engine"].stats
            same_picks = g["picks"] == i["picks"]
            c = {"tokens_equal": g["tokens"] == i["tokens"],
                 "picks_equal": same_picks,
                 # k="auto" picks from measured step times, which differ
                 # between graphs and interpreter: counters and launches
                 # are compared where the picks agree
                 "counters_equal": g["counters"] == i["counters"],
                 "launches_equal": g["launches"] == i["launches"],
                 "verify_replays": st["verify_graph_replays"],
                 "draft_replays": st["draft_graph_replays"],
                 "new_lowers_after_warmup": g["new_lowers"],
                 "spec_builds_misses": sum(
                     b["misses"] for b in st["spec_builds"].values()),
                 "near_tie": near_tie_check(prompts, plain["tokens"],
                                            g["tokens"], margins)}
            # other draft lengths round differently on the card (other
            # GEMM row counts): where the picks differ, each arm is held
            # to plain greedy by the near-tie rule instead
            c["interpreter_near_tie"] = near_tie_check(
                prompts, plain["tokens"], i["tokens"], margins)
            c["ok"] = (g["ok"] and i["ok"]
                       and (c["interpreter_near_tie"]["ok"] if not same_picks
                            else (c["tokens_equal"] and c["counters_equal"]
                                  and c["launches_equal"]))
                       and st["spec_steps"] > 0
                       and st["verify_graph_replays"] == st["spec_steps"]
                       and st["draft_graph_replays"] == (
                           st["spec_steps"] if name == "self_k4" else 0)
                       and st["graph_replays"]
                       == st["decode_steps"] - st["spec_steps"]
                       and g["new_lowers"] == 0
                       # under auto a verify width's verdict may differ
                       # from the decode step's, and its plan lowers anew
                       and (name == "auto_k"
                            or c["spec_builds_misses"] == 0)
                       and c["near_tie"]["ok"])
            ok = ok and c["ok"]
            key = f"{name}_{cache}"
            checks[key] = c
            arms[key] = {"graphs": {k: g[k] for k in (
                "wall_s", "tokens_per_s", "counters", "picks", "launches")},
                "interpreter": {k: i[k] for k in (
                    "wall_s", "tokens_per_s", "counters", "picks")}}
            del g, i
            gc.collect()
    # the oracle: the plain greedy run's own tokens as drafts (64 of
    # them, for the runs past the mix's 16)
    plain64 = spec_run(prog, params, None, new_tokens=64)
    ok = ok and all(t[:16] == s for t, s in zip(plain64["tokens"],
                                                 plain["tokens"]))
    seqs = [np.concatenate([np.asarray(p, np.int32),
                            np.asarray(t, np.int32)])
            for p, t in zip(prompts, plain64["tokens"])]
    del plain64
    oracle = {}
    for order in (("plain", 4, 8), (8, 4, "plain")):
        for k in order:
            spec = None if k == "plain" else spec_config(
                oracle_proposer(seqs), k)
            r = spec_run(prog, params, spec)
            st = r["counters"]
            row = oracle.setdefault(str(k), {"tokens_per_s": [],
                                             "wall_s": []})
            row["tokens_per_s"].append(r["tokens_per_s"])
            row["wall_s"].append(r["wall_s"])
            row["counters"] = st
            if k != "plain":
                row["acceptance"] = st["spec_accepted"] / max(
                    1, st["spec_drafted"])
                row["tokens_equal_plain"] = r["tokens"] == plain["tokens"]
            del r
    # the verify step's cost at k = 2, 4, 8 against the plain tier-4 step,
    # and its profile, on an oracle engine in its steady decode
    engine = serve_engine(prog, params, 64,
                          spec=spec_config(oracle_proposer(seqs), 8))
    for _ in range(3):
        engine.step()
    step_ms = spec_step_ms(engine, SPEC_KS)
    profile_k4 = verify_profile(engine, 4)
    del engine
    gc.collect()
    # k="auto" under the oracle: explore 2, 4, 8, then exploit
    auto_prog = compile(arch, policy="auto")
    pick_engine = serve_engine(auto_prog, params, 64,
                               spec=spec_config(oracle_proposer(seqs),
                                                "auto"))
    picks = logged_picks(pick_engine)
    served(pick_engine)
    policy = auto_prog.policy
    auto_pick = {"picks": picks,
                 "final_pick": policy.spec_draft_k(
                     arch=prog.model.cfg.name,
                     candidates=pick_engine._k_candidates),
                 "observations": {str(k): rec for (a, k), rec
                                  in policy._spec_obs.items()}}
    del pick_engine
    gc.collect()
    log({"phase": "spec", "arch": arch, "gpu": gpu,
         "prompt_lens": list(SERVE_LENS), "new_tokens": 16,
         "near_tie_tolerance": NEAR_TIE,
         "plain": {"tokens_per_s": plain["tokens_per_s"],
                   "wall_s": plain["wall_s"],
                   "decode_steps": plain["counters"]["decode_steps"],
                   "interpreter_tokens_equal":
                       plain_i["tokens"] == plain["tokens"]},
         "arms": arms, "checks": checks, "oracle": oracle,
         "step_ms": step_ms, "verify_profile_k4": profile_k4,
         "auto_pick_under_oracle": auto_pick, "ok": ok})
    return ok


@contextlib.contextmanager
def verify_drops(widths=(2, 3, 4, 5, 6, 7, 8, 9)):
    """Expert assignments dropped past capacity by the MoE dispatch of
    steps whose query width is a verify width (eager runs only)."""
    from repro_torch.models import moe
    orig = moe.DispatchBuildOp.kernel
    out = {"calls": 0, "calls_with_drops": 0, "dropped": 0,
           "assignments": 0}

    def kernel(op, p, x, ve):
        buf, slot = orig(op, p, x, ve)
        if x.device.type != "meta" and x.shape[1] in widths:
            n = int((slot < 0).sum())
            out["calls"] += 1
            out["calls_with_drops"] += n > 0
            out["dropped"] += n
            out["assignments"] += slot.numel()
        return buf, slot
    moe.DispatchBuildOp.kernel = kernel
    try:
        yield out
    finally:
        moe.DispatchBuildOp.kernel = orig


def phase_moe_spec(dev, params, gpu, totals, arch="deepseek-moe-16b"):
    """deepseek-moe-16b with ``ngram`` k=4 (``self`` refuses its two
    stacks): graphs against the interpreter, against plain greedy by the
    near-tie rule, and the verify step's cost against the plain step."""
    from repro_torch.api import compile
    prog = compile(arch)
    prompts = serve_prompts(prog)
    plain = spec_run(prog, params, None)
    with plain_margins() as margins:
        plain_i = spec_run(prog, params, None, lowered=False)
    spec = spec_config("ngram", 4)
    g = spec_run(prog, params, spec, into=totals)
    with verify_drops() as drops:
        i = spec_run(prog, params, spec, lowered=False)
    st = g["engine"].stats
    tie = near_tie_check(prompts, plain["tokens"], g["tokens"], margins)
    try:
        serve_engine(prog, params, 1, submit=False,
                     spec=spec_config("self", 4))
        refused = False
    except ValueError:
        refused = True
    engine = g["engine"]
    for p in prompts:
        engine.submit(serve_request(len(engine.finished) + 100, p, 64))
    for _ in range(3):
        engine.step()
    step_ms = spec_step_ms(engine, (4,))
    ok = (g["ok"] and i["ok"] and plain_i["tokens"] == plain["tokens"]
          and g["tokens"] == i["tokens"] and g["counters"] == i["counters"]
          and g["launches"] == i["launches"] and g["new_lowers"] == 0
          and st["spec_steps"] > 0
          and st["verify_graph_replays"] == st["spec_steps"]
          # a verify step routes tier x W tokens into the capacity of
          # that many, where assignments past an expert's capacity are
          # dropped (plain decode's 4 tokens never fill one): a
          # divergence there is no rounding, and is reported as such
          and (tie["ok"] or drops["calls_with_drops"] > 0) and refused)
    log({"phase": "moe_spec", "arch": arch, "gpu": gpu,
         "plain_tokens_per_s": plain["tokens_per_s"],
         "spec_tokens_per_s": g["tokens_per_s"],
         "interpreter_tokens_per_s": i["tokens_per_s"],
         "counters": g["counters"], "tokens_equal": g["tokens"] == i["tokens"],
         "launches_equal": g["launches"] == i["launches"],
         "near_tie": tie, "verify_capacity_drops": drops,
         "self_refused": refused, "step_ms": step_ms,
         "ok": ok})
    del engine, g, i
    gc.collect()
    return ok


# ---------------------------------------------------------------------------
# phase 4f: autotune — the cost-model autotuner, measured on the card
# ---------------------------------------------------------------------------


def segment_feeds(model, params, dev):
    """``(params_of, inputs_of)`` for ``realizer_measurer``: the params of
    the segment a (tuning) graph belongs to — the embed, layer 0 of a
    stack, the head — and random inputs of its input specs (ids in the
    vocabulary, positions from 0, or from half of ``s_max`` in decode),
    made once per graph."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    counts = {st[0]: st[2] for st in model.layer_stacks("prefill")}
    made: dict = {}

    def names(graph):
        out = set()
        for n in graph.nodes.values():
            out.add(n.name)
            out.update(m.name for m in n.members)
        return out

    def params_of(info, graph):
        if "ids" in graph.inputs:
            return params["embed"]
        if "positions" not in graph.inputs:
            return {**params, **params["head"]}
        stack = ("dense0" if "dense0" in params and not any(
            "router" in n for n in names(graph)) else "layers")
        if counts[stack] > 1:           # stacked: layer 0's slice
            return _layer(params[stack], 0)
        return {**params, **params[stack]}

    def inputs_of(info, graph):
        key = id(graph)
        if key in made:
            return made[key][1]
        out = {}
        specs = {name: graph.tensors[tid]
                 for name, tid in graph.inputs.items()}
        # decode: the rows half full (a k_cache input is (B, s_max, ...))
        start = next((t.shape[1] // 2 for name, t in specs.items()
                      if name.endswith("k_cache")), 0)
        for name, t in specs.items():
            shape = tuple(t.shape)
            if name == "ids":
                out[name] = torch.randint(0, model.cfg.vocab, shape,
                                          generator=gen, device=dev,
                                          dtype=torch.int32)
            elif name == "positions":
                out[name] = (start + torch.arange(
                    shape[1], dtype=torch.int32, device=dev)
                ).expand(shape).contiguous()
            elif name == "cache_len":
                out[name] = torch.full(shape, start, dtype=torch.int32,
                                       device=dev)
            elif t.dtype.is_floating_point:
                out[name] = torch.randn(shape, generator=gen, device=dev
                                        ).to(t.dtype)
            else:
                out[name] = torch.zeros(shape, dtype=t.dtype, device=dev)
        made[key] = (graph, out)        # keeps the graph alive: ids unique
        return out

    return params_of, inputs_of


def winners_policy(auto):
    """A ``StrategyPolicy`` that schedules every context the autotuner
    ``auto`` holds a verdict for with that verdict's winner."""
    from repro_torch.core.autotune import context_fingerprint
    from repro_torch.core.policy import StrategyPolicy

    class Winners(StrategyPolicy):
        name = "winners"

        def __init__(self):
            self.table = {fp: (v.winner, v.params)
                          for fp, v in auto._verdicts.items()}
            self._rules = auto.partition_rules()

        def __call__(self, ctx):
            graph = ctx.extra["graph"]
            win, prm = self.table[context_fingerprint(ctx, graph)]
            return auto._instantiate(win, dict(prm), auto.tp)

        def identity(self):
            return ("winners",) + tuple(sorted(
                (fp, w, tuple(p)) for fp, (w, p) in self.table.items()))

        def partition_rules(self):
            return self._rules

    return Winners()


def phase_autotune(dev, params, gpu, totals, arch="chatglm3-6b"):
    """``compile(arch, policy=AutoPolicy(measure_top_k=3, measurer=
    realizer_measurer(...)))`` at the (4, 2048) prefill group and tier-4
    decode: the verdicts (winner, modeled against measured seconds of
    each refined candidate, the sequential baseline), where the model's
    ranking and the card's disagree; the mix served under the autotuner
    against a fixed policy of its winners; a bundle saved and loaded
    serves with no re-tune."""
    import tempfile

    from repro_torch.api import Program, compile
    from repro_torch.core.autotune import AutoPolicy, realizer_measurer
    from repro_torch.core.plan import graph_fingerprint
    from repro_torch.models.registry import build_model
    from repro_torch.configs import get_config
    from repro_torch.models.layers import MeshInfo
    model = build_model(get_config(arch), MeshInfo(tp=1, dp=1))
    params_of, inputs_of = segment_feeds(model, params, dev)
    measure = realizer_measurer(params_of, inputs_of, repeats=3)
    rows: list = []

    def measurer(info, graph, plan):
        t = measure(info, graph, plan)
        rep, _ = auto._score(graph, plan, auto.tp)
        rows.append({"context": f"{info.phase} b={info.local_batch} "
                                f"s={info.seq_len}",
                     "graph": graph_fingerprint(graph)[:12],
                     "num_mb": plan.num_mb, "steps": len(plan.steps),
                     "t_model_us": rep.t_overlapped * 1e6,
                     "measured_us": None if t is None else t * 1e6})
        return t
    auto = AutoPolicy(measure_top_k=3, measurer=measurer)
    prog = compile(model, policy=auto)
    t0 = time.perf_counter()
    prog.prefill(*PREFILL_GROUP, s_max=4096)
    prog.decode_tiers(4, 4096, tiers=(4,))
    build_s = time.perf_counter() - t0
    explain = prog.explain()
    # each context's refined candidates: the model's order against the
    # card's (labels from the verdict's scores, whose refined entries
    # hold the measured seconds)
    by_ctx: dict = {}
    for r in rows:
        by_ctx.setdefault((r["context"], r["graph"]), []).append(r)
    for v in explain:
        for (ctx, _g), rs in by_ctx.items():
            if ctx != f"{v['phase']} b={v['local_batch']} s={v['seq_len']}":
                continue
            for r in rs:
                r.setdefault("label", next(
                    (lab for lab, t, _m in v["scores"]
                     if r["measured_us"] is not None
                     and abs(t * 1e6 - r["measured_us"]) < 1e-9), None))
    # a pair of refined candidates the model orders strictly (a tie
    # orders nothing) and the card the other way round
    disagreements, ordered_pairs = [], 0
    for (ctx, g), rs in by_ctx.items():
        for a in range(len(rs)):
            for b in range(len(rs)):
                ra, rb = rs[a], rs[b]
                if ra["t_model_us"] >= rb["t_model_us"]:
                    continue
                ordered_pairs += 1
                if (ra["measured_us"] or 0.0) > (rb["measured_us"] or 0.0):
                    disagreements.append({
                        "context": ctx, "graph": g,
                        "model_faster": ra.get("label") or a,
                        "card_faster": rb.get("label") or b,
                        "t_model_us": [ra["t_model_us"], rb["t_model_us"]],
                        "measured_us": [ra["measured_us"],
                                        rb["measured_us"]]})
    # serve the mix under the autotuner, then under its winners fixed
    engine = serve_engine(prog, params, 16)
    reqs, wall, counts = served(engine, totals)
    tokens = tokens_of(reqs)
    retunes_serving = auto.retunes
    del engine
    fixed = compile(model, policy=winners_policy(auto))
    f_engine = serve_engine(fixed, params, 16)
    f_reqs, f_wall, _ = served(f_engine)
    del f_engine, fixed
    gc.collect()
    with tempfile.TemporaryDirectory() as d:
        bundle = os.path.join(d, "prog.dfpb")
        prog.save(bundle)
        loaded = Program.load(bundle)
        l_engine = serve_engine(loaded, params, 16)
        l_reqs, l_wall, _ = served(l_engine)
        loaded_retunes = loaded.policy.retunes
        loaded_spec = loaded.policy_spec
        del l_engine, loaded
    gc.collect()
    measured_ok = bool(rows) and all(r["measured_us"] is not None
                                     for r in rows)
    ok = (measured_ok and all(r.ok for r in reqs)
          and tokens == tokens_of(f_reqs) and tokens == tokens_of(l_reqs)
          and loaded_retunes == 0)
    log({"phase": PREFIX[model.cfg.family] + "autotune", "arch": arch,
         "gpu": gpu, "build_s": build_s,
         "explain": [{k: r[k] for k in (
             "context", "winner", "params", "t_model_us", "t_sequential_us",
             "speedup", "provenance", "measured_us", "scores", "pruned")}
             for r in explain],
         "measured": rows, "model_ordered_pairs": ordered_pairs,
         "model_vs_card_disagreements": disagreements,
         "retunes": retunes_serving,
         "served": {"auto_tokens_per_s": sum(map(len, tokens)) / wall,
                    "winners_tokens_per_s":
                        sum(map(len, tokens_of(f_reqs))) / f_wall,
                    "winners_tokens_equal": tokens == tokens_of(f_reqs),
                    "loaded_tokens_equal": tokens == tokens_of(l_reqs),
                    "loaded_policy_spec": loaded_spec,
                    "loaded_retunes": loaded_retunes},
         "launches": counts, "ok": ok})
    return ok


# ---------------------------------------------------------------------------
# phase: training
# ---------------------------------------------------------------------------

# the kernels every dense train step launches, and TokenWeave's pair
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "rmsnorm",
                 "rmsnorm_bwd")
FUSED_PAIR = ("fused_add_rmsnorm", "fused_add_rmsnorm_bwd")
# the GPU (kernels) against the CPU (plain versions), and dynamic against
# sequential: bf16 round-off.  The backward kernels round P and dS to
# bf16 for the tensor cores, the card's LM head takes the bf16-rounded
# softmax - onehot for its dx and dW products, TokenWeave normalizes the
# unrounded f32 sum where sequential normalizes its bf16 rounding; each
# gradient leaf sums such differences over every token
TRAIN_TOL = dict(loss_rel=2e-3, grad_norm_rel=2e-2, leaf_rel_l2=5e-2)
LOOP_STEPS, LOOP_LR, LOOP_WARMUP = 30, 1e-3, 3
# The loss must fall: the mean of the last 5 steps below the first step's
# loss by LOOP_MARGIN.  A CPU run of the same loop (the plain versions) on
# smollm-135m cut to 2 layers, B=8 S=2048 under dynamic
# (tools/train_loop_cpu.py --threads 4) fell from 10.9211 to a last-5
# mean of 2.6674; the margin is a quarter of that drop, as the
# full-depth model need not memorize the batch as fast
LOOP_CPU_FIRST, LOOP_CPU_LAST5 = 10.9211, 2.6674
LOOP_MARGIN = 0.25 * (LOOP_CPU_FIRST - LOOP_CPU_LAST5)
CRASH_AT, CKPT_EVERY, CRASH_STEPS = 9, 5, 15
# (B, S) of the GPU-against-CPU cut, smollm-135m and chatglm3-6b's cut
CUT_SHAPE, SMOLLM_SHAPE, GLM_SHAPE = (2, 512), (8, 2048), (2, 2048)


def train_batch(B, S, vocab, dev, seed=SEED):
    """One ``SyntheticBackend`` batch (uniform tokens) with its positions."""
    import torch

    from repro_torch.data import DataConfig, SyntheticBackend
    b = SyntheticBackend(vocab).batch(
        DataConfig(seq_len=S, global_batch=B, seed=seed), 0)
    pos = torch.arange(S, dtype=torch.int32).expand(B, S).contiguous()
    return {"ids": torch.from_numpy(b["ids"]).to(dev),
            "labels": torch.from_numpy(b["labels"]).to(dev),
            "positions": pos.to(dev)}


class RepeatedBatch:
    """A pipeline that hands out one batch every step, with the cursor a
    checkpoint saves and restores."""

    def __init__(self, batch):
        self.batch, self.step = batch, 0

    def seek(self, step):
        self.step = step

    def state_dict(self):
        return {"step": self.step}

    def load_state_dict(self, st):
        self.seek(int(st["step"]))

    def __iter__(self):
        return self

    def __next__(self):
        self.step += 1
        return self.batch


def _copy_tree(tree, dev=None):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach().to(dev or t.device, copy=True),
                    tree)


def grads_agree(got, want):
    """(checks, ok) of two ``train_step.grads`` results: the loss and each
    gradient leaf, finite, within ``TRAIN_TOL``."""
    import torch

    from repro_torch.tree import leaves_with_paths
    (gg, (ls_g, c_g)), (gw, (ls_w, c_w)) = got, want
    loss_g = float(ls_g) / max(float(c_g), 1.0)
    loss_w = float(ls_w) / max(float(c_w), 1.0)
    leaves_w = dict(leaves_with_paths(gw))
    worst, finite = {}, True
    for path, a in leaves_with_paths(gg):
        b = leaves_w[path]
        finite = finite and bool(torch.isfinite(a.float()).all())
        worst["/".join(path)] = rel_err(a.to(b.device), b)
    checks = {"loss": loss_g, "loss_want": loss_w,
              "loss_rel_err": abs(loss_g - loss_w) / abs(loss_w),
              "tokens": float(c_g), "finite": finite,
              "leaf_rel_l2_max": max(worst.values()),
              "leaf_rel_l2": worst}
    ok = (finite and float(c_g) == float(c_w)
          and checks["loss_rel_err"] < TRAIN_TOL["loss_rel"]
          and checks["leaf_rel_l2_max"] < TRAIN_TOL["leaf_rel_l2"])
    return checks, ok


def train_flops(cfg, params, B, S):
    """Model FLOPs of one train step: 6 N per token for the matmul
    params (every param but an untied embedding table, which is a
    lookup; a tied table is the head's matmul) plus the causal
    attention's 2 (B S^2 H hd / 2) per layer forward, three times for the
    forward and backward.  Recomputation under remat is not counted."""
    from repro_torch.tree import leaves
    n = sum(t.numel() for t in leaves(params))
    if not cfg.tie_embeddings:
        n -= cfg.vocab * cfg.d_model
    attn = 3 * 4.0 * B * S * S * cfg.n_heads * cfg.hd * 0.5 * cfg.n_layers
    return 6.0 * n * B * S + attn, n


def step_timings(step, params, opt, batch, cfg, totals, first_step):
    """Warm timings of ``step``: wall ms a step (CUDA events over 3 steps),
    the profiler's device ms a step and busy share, tokens/s, MFU, peak
    memory and the launches of one step.  Trains ``params`` on."""
    import torch
    B, S = batch["ids"].shape
    i = first_step
    step(params, opt, batch, i)                   # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (_, _, m), launches = counted(totals, lambda: step(params, opt, batch,
                                                       i + 1))
    peak = torch.cuda.max_memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for j in range(3):
        step(params, opt, batch, i + 2 + j)
    end.record()
    end.synchronize()
    wall = start.elapsed_time(end) / 3
    prof = _profile(lambda: step(params, opt, batch, i + 5), 2)
    flops, n = train_flops(cfg, params, B, S)
    return {"step_wall_ms": wall,
            "step_device_ms": prof["device_ms_per_step"],
            "device_busy_share": prof["device_busy_share"],
            "kernel_launches_per_step": prof["kernel_launches_per_step"],
            "top_device_ms_per_step": prof["top_device_ms_per_step"],
            "tokens_per_s": B * S / (wall / 1e3),
            "model_flops_per_step": flops, "matmul_params": n,
            "mfu": flops / (wall / 1e3) / PEAK_BF16_FLOPS,
            "peak_memory_gb": peak / 1e9,
            "kernel_launches_one_step": launches,
            "loss_after": float(m["loss"])}


def phase_train_cut(dev, totals):
    """smollm-135m at full width cut to 2 layers: ``Program.train_step(2,
    512)`` on the card (kernels) against the same program on the CPU
    (plain versions): loss, every gradient leaf, and one full step's
    loss and grad_norm."""
    import torch

    from repro_torch.api import compile
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("smollm-135m"), n_layers=2)
    prog = compile(cfg)
    step = prog.train_step(*CUT_SHAPE)
    params = prog.init_params(SEED, device="cpu", phase="train")
    gpu_params = _copy_tree(params, dev)
    batch = train_batch(*CUT_SHAPE, cfg.vocab, "cpu")
    gpu_batch = {k: v.to(dev) for k, v in batch.items()}
    want = step.fn.grads(params, batch)
    got, counts = counted(totals, lambda: step.fn.grads(gpu_params,
                                                        gpu_batch))
    checks, ok = grads_agree(got, want)
    del got, want
    opt, gpu_opt = step.init_opt(params), step.init_opt(gpu_params)
    _, _, m_cpu = step(params, opt, batch, 0)
    _, _, m_gpu = step(gpu_params, gpu_opt, gpu_batch, 0)
    metrics = {k: (float(m_gpu[k]), float(m_cpu[k])) for k in m_cpu}
    gn_err = abs(metrics["grad_norm"][0] - metrics["grad_norm"][1]) \
        / metrics["grad_norm"][1]
    ok = (ok and gn_err < TRAIN_TOL["grad_norm_rel"]
          and abs(metrics["loss"][0] - metrics["loss"][1])
          < TRAIN_TOL["loss_rel"] * metrics["loss"][1]
          and all(counts.get(k, 0) > 0 for k in TRAIN_KERNELS))
    log({"phase": "train_cut",
         "config": "smollm-135m at full width, 2 layers, B=%d S=%d, "
                   "policy dynamic" % CUT_SHAPE, "strategies": step.strategies,
         "grads": checks, "step_metrics_gpu_cpu": metrics,
         "grad_norm_rel_err": gn_err, "kernel_launches": counts,
         "tolerance": TRAIN_TOL, "ok": ok})
    return ok


def _dyn_seq_train(cfg, B, S, dev, totals, tcfg, want_strategy):
    """``dynamic`` against ``sequential`` on one batch from the same
    params: (dynamic step, params, batch, record, ok)."""
    from repro_torch.api import compile
    dyn = compile(cfg, policy="dynamic").train_step(B, S, cfg=tcfg)
    seq = compile(cfg, policy="sequential").train_step(B, S, cfg=tcfg)
    params = compile(cfg).init_params(SEED, phase="train")
    batch = train_batch(B, S, cfg.vocab, dev)
    want = seq.fn.grads(params, batch)
    got, counts = counted(totals, lambda: dyn.fn.grads(params, batch))
    checks, ok = grads_agree(got, want)
    del got, want
    fused = dyn.strategies.get("layers") == "tokenweave"
    ok = (ok and dyn.strategies.get("layers") == want_strategy
          and all(counts.get(k, 0) > 0 for k in TRAIN_KERNELS)
          # a run that fuses nothing must not pass as having fused
          and all((counts.get(k, 0) > 0) == fused for k in FUSED_PAIR))
    rec = {"dynamic_strategies": dyn.strategies,
           "first_step_dynamic_vs_sequential": checks,
           "first_step_launches": counts}
    return dyn, params, batch, rec, ok


def phase_train(dev, totals):
    """smollm-135m as published (B=8, S=2048): dynamic against sequential,
    the loss falling over a loop on one repeated batch, crash-restart;
    then chatglm3-6b at full width cut to 4 layers (B=2, S=2048)."""
    import gc
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.ft import FailureSimulator
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (TrainLoopConfig, TrainStepConfig,
                                   train_loop)
    ok = phase_train_cut(dev, totals)

    cfg = get_config("smollm-135m")
    tcfg = TrainStepConfig(optimizer=AdamWConfig(lr=LOOP_LR),
                           warmup=LOOP_WARMUP, total_steps=LOOP_STEPS)
    dyn, params, batch, rec, this_ok = _dyn_seq_train(
        cfg, *SMOLLM_SHAPE, dev, totals, tcfg, "tokenweave")
    init = _copy_tree(params)
    loop_cfg = TrainLoopConfig(steps=LOOP_STEPS, log_every=10 ** 9)
    t0 = time.perf_counter()
    p, o, hist = train_loop(dyn.fn, params, dyn.init_opt(params),
                            RepeatedBatch(batch), loop_cfg)
    loop_s = time.perf_counter() - t0
    losses = [h["loss"] for h in hist]
    last5 = sum(losses[-5:]) / 5
    falls = last5 < losses[0] - LOOP_MARGIN
    # crash at CRASH_AT, restored from the checkpoint at step CKPT_EVERY
    with tempfile.TemporaryDirectory() as ckpt:
        sim = FailureSimulator(crash_steps=(CRASH_AT,))
        cp = _copy_tree(init)
        _, _, chist = train_loop(
            dyn.fn, cp, dyn.init_opt(cp), RepeatedBatch(batch),
            TrainLoopConfig(steps=CRASH_STEPS, ckpt_dir=ckpt,
                            ckpt_every=CKPT_EVERY, log_every=10 ** 9),
            failure_sim=sim)
    restart = chist[CRASH_AT:]
    rerun_steps = [h["step"] for h in restart]
    crash_err = max(abs(h["loss"] - losses[h["step"]]) / losses[h["step"]]
                    for h in restart)
    crash_ok = (sim.injected == [("crash", CRASH_AT)]
                and rerun_steps == list(range(CKPT_EVERY, CRASH_STEPS))
                and crash_err < 1e-4)
    timings = step_timings(dyn.fn, p, o, batch, cfg, totals, LOOP_STEPS)
    this_ok = this_ok and falls and crash_ok
    ok = ok and this_ok
    log({"phase": "train", "config": "smollm-135m as published, B=%d "
         "S=%d, TrainStepConfig(lr=1e-3, warmup=3, total_steps=30, "
         "remat)" % SMOLLM_SHAPE, **rec,
         "loop": {"steps": LOOP_STEPS, "losses": losses,
                  "first": losses[0], "last5_mean": last5,
                  "margin": LOOP_MARGIN, "falls": falls, "loop_s": loop_s,
                  "step_time_s": [h["step_time_s"] for h in hist]},
         "crash_restart": {"crash_at": CRASH_AT, "ckpt_every": CKPT_EVERY,
                           "steps_rerun": rerun_steps,
                           "max_loss_rel_err_vs_uncrashed": crash_err,
                           "ok": crash_ok},
         **timings, "tolerance": dict(TRAIN_TOL, crash_loss_rel=1e-4),
         "ok": this_ok})
    del dyn, params, p, o, init
    gc.collect()
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config("chatglm3-6b"), n_layers=4)
    dyn, params, batch, rec, this_ok = _dyn_seq_train(
        cfg, *GLM_SHAPE, dev, totals, TrainStepConfig(), "nanoflow")
    timings = step_timings(dyn.fn, params, dyn.init_opt(params), batch, cfg,
                           totals, 0)
    ok = ok and this_ok
    log({"phase": "train_chatglm3", "config": "chatglm3-6b at full width, "
         "4 layers, B=%d S=%d, TrainStepConfig() (remat)" % GLM_SHAPE, **rec,
         **timings, "tolerance": TRAIN_TOL, "ok": this_ok})
    del dyn, params
    gc.collect()
    torch.cuda.empty_cache()
    return ok


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
    dev_ms = sum(_dev_us(e) for e in kernels) / 1e3
    by_dev = sorted(kernels, key=_dev_us, reverse=True)[:8]
    cpu = [e for e in ka if e.device_type == DeviceType.CPU]
    by_cpu = sorted(cpu, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:8]
    return {"steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
            "device_ms_per_step": dev_ms / steps,
            "device_busy_share": dev_ms / (wall * 1e3),
            "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
            "cpu_ops_per_step": sum(e.count for e in cpu
                                    if e.key.startswith("aten::")) / steps,
            "top_device_ms_per_step": {e.key[:60]: _dev_us(e) / 1e3 / steps
                                       for e in by_dev},
            "top_cpu_self_ms_per_step": {
                e.key[:60]: e.self_cpu_time_total / 1e3 / steps
                for e in by_cpu}}


def phase_profile(dev, params, arch="chatglm3-6b"):
    """One warm prefill (B=4, bucket 2048), eager through the program's
    step and replayed as the serve engine's graph, a window of tier-4
    decode steps of the serve path, with graphs and with the
    interpreter, and (dense) the (4, 2048) chunk group's graph, under
    the profiler."""
    from repro_torch.api import compile
    prog = compile(arch)
    cfg = prog.model.cfg
    step = prog.prefill(4, 2048)
    batch = prefill_batch(4, 2048, cfg.vocab, dev, SEED + 2)
    step(params, batch)
    prefill = _profile(lambda: step(params, batch), 2)
    decode = {}
    for name, lowered in (("graphs", True), ("interpreter", False)):
        engine = serve_engine(prog, params, 64, lowered)
        if lowered:
            # the prefill group's graph, as the engine replays it (on the
            # staging buffer's contents; the engine's own prefill follows
            # and rewrites what it wrote)
            g = engine._group_graph("prefill", *PREFILL_GROUP)
            g.replay()
            prefill_graph = _profile(g.replay, 2)
        for _ in range(4):              # prefill + warm decode steps
            engine.step()
        decode[name] = _profile(engine.step, 16)
        engine.run()
    chunk_graph = None
    if cfg.family == "dense":
        # the (4, 2048) chunk group's graph on the long prompts' first
        # chunks, staged through an idle engine
        engine = serve_engine(prog, params, 1, submit=False)
        engine.warmup(chunks=[CHUNK_GROUP])
        chunk_step_ms(engine, long_prompts(prog))
        chunk_graph = _profile(
            engine._group_graph("chunk", *CHUNK_GROUP).replay, 2)
        del engine
    log({"phase": PREFIX[cfg.family] + "profile",
         "arch": arch, "prefill_strategies": step.strategies,
         "prefill_B4_S2048": prefill,
         "prefill_B4_S2048_graph": prefill_graph,
         "chunk_group_4x2048_graph": chunk_graph,
         "decode_tier4": decode["graphs"],
         "decode_tier4_interpreter": decode["interpreter"]})


# ---------------------------------------------------------------------------


def init_params(arch):
    import torch

    from repro_torch.api import compile
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    params = compile(get_config(arch)).init_params(SEED)
    torch.cuda.synchronize()
    log({"phase": "init", "arch": arch,
         "params": sum(t.numel() for t in _leaves(params)),
         "gb": sum(t.numel() * t.element_size()
                   for t in _leaves(params)) / 1e9,
         "init_s": time.perf_counter() - t0})
    return params


def run_dense(phases, dev, gpu, totals):
    ok = True
    if "reference" in phases:
        ok = phase_reference(dev, totals) and ok
    if phases & {"transparency", "serve", "profile", "lifecycle", "paged",
                 "sampling", "spec", "autotune"}:
        params = init_params("chatglm3-6b")
        if "transparency" in phases:
            ok = phase_transparency(dev, params, totals) and ok
        if "profile" in phases:
            phase_profile(dev, params)
        if "serve" in phases:
            ok = phase_serve(dev, params, gpu, totals) and ok
        if "lifecycle" in phases:
            ok = phase_lifecycle(dev, params, gpu, totals) and ok
        if "paged" in phases:
            ok = phase_paged(dev, params, gpu, totals) and ok
        if "sampling" in phases:
            ok = phase_sampling(dev, params, gpu, totals) and ok
        if "spec" in phases:
            ok = phase_spec(dev, params, gpu, totals) and ok
        if "autotune" in phases:
            ok = phase_autotune(dev, params, gpu, totals) and ok
    return ok


def run_moe(phases, dev, gpu, totals):
    ok = True
    if "moe_reference" in phases:
        ok = phase_reference(dev, totals, "deepseek-moe-16b") and ok
    if phases & {"moe_transparency", "moe_serve", "moe_profile", "spec",
                 "autotune"}:
        params = init_params("deepseek-moe-16b")
        if "moe_transparency" in phases:
            ok = phase_moe_transparency(dev, params, totals) and ok
        if "moe_profile" in phases:
            phase_profile(dev, params, "deepseek-moe-16b")
        if "moe_serve" in phases:
            ok = phase_serve(dev, params, gpu, totals,
                             "deepseek-moe-16b") and ok
            ok = phase_moe_chunked(dev, params, totals) and ok
            ok = phase_moe_paged(dev, params, totals) and ok
        if "spec" in phases:
            ok = phase_moe_spec(dev, params, gpu, totals) and ok
        if "autotune" in phases:
            ok = phase_autotune(dev, params, gpu, totals,
                                "deepseek-moe-16b") and ok
    return ok


def run_ssm(phases, dev, gpu, totals):
    import torch
    ok = True
    if "ssm_reference" in phases:
        ok = phase_reference(dev, totals, "mamba2-2.7b", S=256) and ok
        # one group of 6 Mamba2 layers and the shared block; from 2048
        # tokens on ``dynamic`` fuses the block's chain under TokenWeave
        ok = phase_reference(dev, totals, "zamba2-1.2b", S=1024, n_layers=6,
                             policy="dynamic") and ok
    if phases & {"ssm_transparency", "ssm_serve", "ssm_profile"}:
        for arch in ("mamba2-2.7b", "zamba2-1.2b"):
            params = init_params(arch)
            if "ssm_transparency" in phases:
                ok = phase_ssm_transparency(dev, params, totals, arch) and ok
            if "ssm_profile" in phases:
                phase_profile(dev, params, arch)
            if "ssm_serve" in phases:
                ok = phase_serve(dev, params, gpu, totals, arch) and ok
            del params        # each model's weights go before the next's
            gc.collect()
            torch.cuda.empty_cache()
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="kernels,reference,transparency,"
                    "serve,lifecycle,paged,sampling,spec,autotune,"
                    "moe_reference,moe_transparency,moe_serve,ssm_reference,"
                    "ssm_transparency,ssm_serve,train")
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
    kernel_rows = (phase_kernels(dev, args.build_log) if "kernels" in phases
                   else [])
    ok = all(r["ok"] for r in kernel_rows)
    totals: dict = {}     # launches summed over the model phases that ran
    ok = run_dense(phases, dev, gpu, totals) and ok
    gc.collect()          # the chatglm3-6b params go before the MoE's
    torch.cuda.empty_cache()
    ok = run_moe(phases, dev, gpu, totals) and ok
    gc.collect()          # the MoE params go before the SSM models'
    torch.cuda.empty_cache()
    ok = run_ssm(phases, dev, gpu, totals) and ok
    if "train" in phases:
        ok = phase_train(dev, totals) and ok
    model_phases = phases - {"kernels"}
    for r in kernel_rows:
        r["launches"] = totals.get(r["name"], 0) if model_phases else None
        ok = ok and (not model_phases or r["launches"] > 0)
    if kernel_rows:
        keys = ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "composition_ms", "device_ms",
                "library_device_ms", "composition_device_ms",
                "device_ms_by", "host_us")
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
