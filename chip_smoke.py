#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Runs four models the repository supports at their full published width
(four more in the phases ``dense_configs``, ``encdec`` and ``vlm``
below; and trains a fifth, smollm-135m: 30 layers, d_model 576, 9 q / 3
kv heads of 64, d_ff 1536, vocab 49152, tied embeddings; 135 M
parameters),
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
            ``F.rms_norm``'s autograd as yardsticks; the AdamW kernel bit
            for bit at the train models' leaf sets and at odd sizes; the
            grouped FFN's gate backward at the MoE train step's shapes,
            with ``GroupedFFN``'s whole backward against torch.autograd
            of the f32 plain forward beside it; the SSD scan's backward
            at the SSM train steps' NanoFlow halves, with torch.autograd
            of the plain scan as its yardstick);
            time kernel, plain
            version and the one-call PyTorch yardstick where there is one
            over back-to-back calls (``ms``: CUDA events, which measure
            the host where a call costs it more than the card), and
            kernel and yardstick on the device alone (``device_ms``,
            ``library_device_ms``: torch.profiler's kernel durations, in
            turns, or CUDA events where no profiler window is whole:
            ``device_ms_by``; decode attention cold, rotating over caches
            that pass the 50 MB L2) with the host's enqueue cost a call
            (``host_us``)
  frontend  one chatglm3-6b decoder layer at full width traced as a raw
            ``Module``: ``compile(layer, example_inputs=...)`` under
            ``dynamic`` (NanoFlow) against ``sequential`` through
            ``Program.__call__`` (plans differ, outputs agree, flash
            attention and RMSNorm launch)
  examples  the four ``examples/torch_*.py`` in subprocesses, at once:
            each exits 0 with its OK line (serve and train on the
            published smollm-135m: the smoke configs' head dim is below
            what the attention kernels take)
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
            own tokens (acceptance, tokens/s against plain, k=4 and 8, one
            pass in that order); the tier-4 verify graph at k=2, 4, 8 against the plain
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
  moe_train deepseek-moe-16b at full width cut to 4 layers (2.27 B
            parameters; the served model freed first), B=2 S=2048
            through ``Program.train_step``'s graphed step: ``dynamic``
            resolves DBO; DBO against two sequential B=1 runs (its
            per-micro-batch capacity) on the first step's loss and every
            gradient leaf, route flips counted; the loss falling over 8
            steps on one repeated batch; two replays against ``fn.eager``
            bit for bit; wall and device time, MFU, memory, launches (both
            grouped-FFN kernels)
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
  ssm_train mamba2-2.7b at full width cut to 16 layers (0.77 B
            parameters) and zamba2-1.2b as published, each B=2 S=2048
            through ``Program.train_step``'s graphed step (the served
            models freed first): ``dynamic`` resolves NanoFlow on the
            Mamba2 stacks and TokenWeave on the shared block; a cut at
            full width on the card against the CPU (mamba2-2.7b 2 layers
            B=2 S=512, zamba2-1.2b one group B=1 S=256); ``dynamic``
            against ``sequential`` on the first step's loss and every
            gradient leaf; the same gradients over per-resource streams
            and on one stream bit for bit; the loss falling over 8 steps
            on one repeated batch; two replays against ``fn.eager`` bit
            for bit; wall and device time, busy share, tokens/s, MFU,
            memory and the graph pool, the largest device ops, launches
            (the scan's forward and backward kernels; zamba2's flash and
            fused add+RMSNorm backwards)
  dense_configs
            minitron-8b (32 layers, d_model 4096, 32 q / 8 kv heads, d_ff
            16384, vocab 256000; 9.88 B, 19.76 GB), then
            deepseek-coder-33b (62 layers, d_model 7168, 56 q / 8 kv
            heads, d_ff 19200, vocab 32256; 33.34 B, 66.69 GB, alone on
            the card), each as published: a 2-layer cut on the GPU
            against the CPU (B=2 S=128), then the serve mix with graphs
            and with the interpreter (tokens and launch counts equal), the
            prefill group's and the tier-4 decode graph replayed alone
  encdec    whisper-tiny as published (4 encoder and 4 decoder layers,
            d_model 384, 6 heads of 64, vocab 51865, GELU, tied): the
            whole model on the GPU against the CPU (B=2 S=256); prefill
            at B=4 S=1500 (random frames and ids), then 16 greedy decode
            steps at tier 4 against the encoder's states zero-padded to
            s_max 2048, the prefill and each step one CUDA Graph, tokens
            equal to the same lowered steps run eagerly and to the
            interpreter's
  vlm       qwen2-vl-7b (28 layers, d_model 3584, 28 q / 4 kv heads,
            M-RoPE sections (16, 24, 24); 7.62 B, 15.23 GB): a 2-layer
            cut on the GPU against the CPU; as published, prefill at B=4
            S=2048 (1024 image patches on a 1 x 32 x 32 grid with random
            ``vis``, then text) and 16 greedy decode steps at s_max 4096
            as ``encdec`` runs them; ``dynamic`` and ``nanoflow`` against
            ``sequential`` at that prefill
  encdec_train / vlm_train
            whisper-tiny as published (B=8 S=1500, TokenWeave) and
            qwen2-vl-7b at full width cut to 4 layers (B=2 S=2048,
            NanoFlow) through ``Program.train_step``'s graphed step as
            ``ssm_train`` runs it (a cut against the CPU, ``dynamic``
            against ``sequential``, 8 steps of a falling loss, replays
            against ``fn.eager`` bit for bit, timings; whisper's MFU
            counts its encoder and cross-attention in full)
  train     smollm-135m cut to 2 layers at full width: ``Program.
            train_step(2, 512)`` on the card against the CPU (loss, every
            gradient leaf, one step's metrics); smollm-135m as published
            (B=8 S=2048): ``dynamic`` (TokenWeave) against ``sequential``
            on the first step's loss and gradients, 30 steps of
            ``train_loop`` on one repeated ``SyntheticBackend`` batch
            (the loss must fall by ``LOOP_MARGIN``) with the step one
            CUDA Graph (one capture: its seconds, pool bytes and the
            loop's peak memory), three replays against three steps of
            ``fn.eager`` bit for bit, a crash at step 9 restored from
            the step-5 checkpoint repeating the uncrashed losses with no
            second capture, the replay's wall and device time, busy
            share, tokens/s, MFU, peak allocated and reserved memory and
            launches, and the eager step's device time by range
            (forward+backward, grad reduction and norm, AdamW) with the
            AdamW chain op by op and as the kernel; then chatglm3-6b at
            full width cut to 4 layers (B=2 S=2048, NanoFlow) the same
            way, without the loop
  streams   every lowered plan runs over per-resource CUDA streams; each
            served model, on the params its other phases used, against
            the one-stream program of the same plans in turns (the
            (4, 2048) prefill group's logits and the mix's 16 greedy
            tokens and launches bit for bit; the prefill group and the
            steady tier-4 step timed as ``serve`` times them; from one
            profiled replay of each graph, and of one eager prefill, the
            kernel time on the busiest streams and the share of the
            device time in which kernels of two or more streams overlap;
            each graph's pool bytes; ``dynamic`` against ``sequential``
            tokens/s on the mix, both on streams; zamba2-1.2b's prefill
            graph with TokenWeave's fused add+RMSNorm at 16 blocks
            against NanoFlow's separate add and norm, each way); then,
            after ``train``, both train configurations' graphed steps:
            params, m, v and metrics after 3 steps bit for bit, the step
            time in turns, the overlap, the pool bytes

  mesh      the launch layer: ``python -m repro_torch.launch.serve``'s
            ``main()`` in this process for chatglm3-6b at full width (the
            JAX package's default flags: 8 requests of 4-29 tokens, 16
            greedy tokens each, max_batch 4, s_max 128), its tokens equal
            to ``compile("chatglm3-6b").serve``'s on the same params and
            prompts, its tokens/s and TTFT; a one-rank mesh over NCCL
            (``launch.mesh.make_mesh((1, 1), ("data", "model"))``, an
            in-memory store): ``compile("chatglm3-6b", mesh=mesh)``'s
            ``prefill(2, 2048)`` logits and ``decode_tiers(4, 4096)``
            outputs bit-equal to the no-mesh program's, each timed in
            turns; a ``dryrun`` line: ``launch/dryrun.py`` counts the same
            two steps on the ``meta`` device (mesh {data: 1, model: 1})
            and each graph's replay must take at least the count's
            roofline ``t_bound`` (the share at the unmasked FLOPs printed
            beside it), the prefill's counted arguments must equal the
            bytes of its params and batch, an eager prefill's growth of
            allocated memory, over the plans' streams and over one, must
            lie within 20% of each program's counted output and
            temporaries, and grok-1-314b x decode_32k x pod16x16 is
            counted at full
            depth (its memory, terms and bottleneck printed); then
            grok-1-314b at full width cut to 2 of its 64
            layers (every earlier model freed; ~23 GB of bf16 weights) on
            that mesh with FSDP as ``fsdp_serve`` asks: prefill built with
            ``MeshInfo(fsdp=True)`` (weight gathers and zero3 experts on
            the network stream), decode with ``fsdp_resident`` (resident
            linears, ff-sharded experts), a B=1 S=2048 prefill and 16
            greedy decode steps inside captured graphs, logits and tokens
            bit-equal to the same cut built without FSDP; the group is
            destroyed at the end of the phase

Each model phase zeroes the launch counts just before the run it checks
and reads them just after; the ``kernels`` line reports their sum over
the phases that ran (null when none did), and every kernel must have
launched on some path.

Usage:  python3 chip_smoke.py [--phases kernels,frontend,examples,
            reference,transparency,serve,lifecycle,paged,sampling,spec,
            autotune,moe_reference,moe_transparency,moe_serve,moe_train,
            ssm_reference,ssm_transparency,ssm_serve,ssm_train,
            dense_configs,encdec,vlm,encdec_train,vlm_train,mesh,train,
            streams]
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
PEAK_F32_FLOPS = 67e12        # H100 SXM data sheet, f32 outside the tensor cores
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
    # the gate's backward: f32 arithmetic in both (expf against
    # torch.sigmoid's exp, FMAs nvcc may contract), each output rounded
    # once to bf16: one ulp (2^-7 relative), and atol for dh1 where
    # silu'(h1) = s (1 + h1 (1 - s)) cancels near h1 = -1.28
    "grouped_ffn_gate_bwd": dict(atol_of_max=1e-5, rtol=2 ** -7, l2=1e-3),
    # GroupedFFN's whole backward (bf16 products through cuBLAS around
    # the gate kernel) against torch.autograd of the f32 plain version:
    # h1, h3, dh, dh1, dh3 and h are rounded to bf16 (2^-9 relative each)
    # before products that sum up to 2048 or 1408 such terms, as flash's
    # backward rounds P and dS
    "grouped_ffn_bwd": dict(atol_of_max=2e-2, rtol=2e-2, l2=2e-2),
    # the SSD scan's backward: the same bf16 operands in both, the
    # kernel's products on the tensor cores with every f32 operand in a
    # bf16 high and low part (~2^-16 relative), the plain version's in
    # f32 through cuBLAS, the sums in other orders (the kernel's over a
    # unit's heads in head order, then over head sets); dx, dB and dC each
    # rounded once to bf16: one ulp (2^-7 relative) apart where two values
    # straddle a rounding boundary, plus 2e-3 of the largest magnitude
    # where the sums cancel, and 1e-2 relative L2; ddt, dA and dD stay
    # f32: 1e-3 relative L2 (dA sums dt times a reverse cumsum that
    # cancels)
    "ssd_scan_bwd": dict(atol_of_max=2e-3, rtol=2 ** -7, l2=1e-2,
                         f32_l2=1e-3),
}
SEED = 0
# phase-name prefix of each model family
PREFIX = {"dense": "", "moe": "moe_", "ssm": "ssm_", "hybrid": "ssm_",
          "encdec": "encdec_", "vlm": "vlm_"}
# the kernels each family's serve path must launch
SERVE_KERNELS = {
    "dense": ("flash_attention", "decode_attention", "rmsnorm"),
    "moe": ("flash_attention", "decode_attention", "rmsnorm", "grouped_ffn"),
    "ssm": ("ssd_scan", "rmsnorm"),
    "hybrid": ("ssd_scan", "rmsnorm", "flash_attention", "decode_attention",
               "fused_add_rmsnorm"),
    "encdec": ("flash_attention", "decode_attention", "rmsnorm"),
    "vlm": ("flash_attention", "decode_attention", "rmsnorm"),
}


START = time.perf_counter()


def log(obj):
    """One JSON line; a phase's line also carries ``at_s``, the seconds
    since the script started, so the run's time splits by phase."""
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - START, 1)}
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
    holds one of ``parts`` (the passes of a multi-launch kernel, each
    launched once a call), from ``torch.profiler``'s kernel durations
    over ``iters`` calls: a pass's mean over its launches.  The profiler
    drops a window's first kernel now and then (seen on an H100: 19 of
    20), so a pass counts with ``iters - 1`` launches; a window missing
    more is measured again, up to ``windows`` times (None where none was
    whole; then ``_counts`` has each device event's name and count in the
    last window)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    out, events = {}, []
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
            n = sum(e.count for e in mine)
            out[part] = (sum(_dev_us(e) for e in mine) / 1e3 / n
                         if n >= iters - 1 else None)
        if all(v is not None for v in out.values()):
            return out
    out["_counts"] = {e.key[:100]: e.count for e in events}
    return out


def bound(c):
    """``bound_ms`` and ``bound_by`` of a kernel's work, a
    ``kernels/cost.py`` ``Cost``: its operations at the peak of their
    units, its bytes at the HBM rate (the dry run charges the same
    functions, ``roofline/count.py``)."""
    t_ops = c.flops / (PEAK_F32_FLOPS if c.f32 else PEAK_BF16_FLOPS) * 1e3
    t_mem = c.nbytes / PEAK_BYTES * 1e3
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

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES as LAUNCHES_
    from repro_torch.kernels import _build, reset_launch_counts, sm_count
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.kernels import cost
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

    def flash(what, B, S, H, Hk, hd=128, causal=True, Sq=None):
        """A case at q (B, Sq, H, hd) against K/V (B, S, Hk, hd); Sq
        defaults to S.  The causal mask is aligned top-left."""
        Sq = S if Sq is None else Sq
        q, k, v = randn(B, Sq, H, hd), randn(B, S, Hk, hd), randn(B, S, Hk, hd)
        kvh = (torch.arange(H, device=dev) // (H // Hk)).to(torch.int32)
        out = fa.flash_attention(q, k, v, causal=causal, kv_head=kvh)
        ref = fa.flash_attention_plain(q, k, v, causal=causal, kv_head=kvh)
        pv = fa.flash_attention_plain(q, k, v.abs(), causal=causal,
                                      kv_head=kvh)
        torch.cuda.synchronize()
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        seq = f"S={S}" if Sq == S else f"Sq={Sq} Sk={S}"
        return dict(
            shape=f"{what}: B={B} {seq} H={H} Hkv={Hk} hd={hd} "
                  f"{'causal' if causal else 'non-causal'} bf16",
            **compare("flash_attention", [(out, ref)], pv=pv),
            ms=cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                                  kv_head=kvh)),
            plain_ms=cuda_ms(lambda: fa.flash_attention_plain(
                q, k, v, causal=causal, kv_head=kvh), iters=5),
            **bound(cost.flash_attention(B, Sq, S, H, Hk, hd,
                                         causal=causal)),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)),
            **device_times(
                [lambda: fa.flash_attention(q, k, v, causal=causal,
                                            kv_head=kvh)],
                [lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True)]))

    def flash_bwd(what, B, S, H, Hk, hd, causal=True):
        q, k, v = randn(B, S, H, hd), randn(B, S, Hk, hd), randn(B, S, Hk, hd)
        do = randn(B, S, H, hd)
        kvh = (torch.arange(H, device=dev) // (H // Hk)).to(torch.int32)
        o, lse = fa._flash_fwd(q, k, v, causal, kvh, lse=True)
        lse_ref = fa.flash_attention_lse_plain(q, k, causal, kvh)
        got = fa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                     kv_head=kvh)
        ref = fa.flash_attention_bwd_plain(q, k, v, o, do, lse,
                                           causal=causal, kv_head=kvh)
        torch.cuda.synchronize()
        # the yardstick: SDPA's backward alone (its forward graph kept)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                             enable_gqa=True)
        dot = do.transpose(1, 2)

        def sdpa_bwd():
            return torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)

        def kernel():
            return fa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                          kv_head=kvh)
        need = cost.flash_attention_bwd(B, S, S, H, Hk, hd, causal=causal)
        # a product of 2 S^2 hd FLOP a (batch, head), causal: half the
        # tiles; the function needs 5, the kernel's two passes do 7 (S and
        # dP in both), the dK/dV pass 4 of them and the dQ pass 3
        product = need.flops / 5
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
            shape=f"{what}: B={B} S={S} H={H} Hkv={Hk} hd={hd} "
                  f"{'causal' if causal else 'non-causal'} bf16",
            geometry=geo,
            lse_max_abs_err=max_err(lse, lse_ref),
            **compare_bwd("flash_attention_bwd", list(zip(got, ref))),
            ms=cuda_ms(kernel, iters=10),
            plain_ms=cuda_ms(lambda: fa.flash_attention_bwd_plain(
                q, k, v, o, do, lse, causal=causal, kv_head=kvh), iters=3),
            # 2.5 times the forward's products, causal: half the tiles
            **bound(need),
            library_ms=cuda_ms(sdpa_bwd, iters=10),
            **times,
            pass_device_ms=parts,
            tflops_bound_work=tflops(5 * product, times["device_ms"]),
            tflops_two_pass_work=tflops(7 * product, times["device_ms"]),
            tflops_dkdv_pass=tflops(4 * product, parts["flash_bwd_dkdv"]),
            tflops_dq_pass=tflops(3 * product, parts["flash_bwd_dq"]))

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def with_norm_bwd_parts(row, kernel, n, d, fused):
        """``row`` with the backward's geometry (and its instantiation's
        registers and blocks resident an SM), the bound's share, the device
        ms of each pass (the row pass and the dg pass), and failed unless
        two calls give the same bits."""
        geo = rn.norm_bwd_geometry(n, d, sms)
        first, again = kernel(), kernel()
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        return dict(row, ok=row["ok"] and same, same_bits_twice=same,
                    geometry=dict(geo, **rn.norm_bwd_info(
                        geo["warps_per_row"], geo["packs"], fused)),
            bound_share=row["bound_ms"] / row["device_ms"],
            pass_device_ms=pass_ms(kernel, ("norm_bwd_kernel",
                                            "norm_bwd_dg_kernel")))

    def norm_bwd(what, n, d):
        x, gw, dh = randn(n, d), randn(d), randn(n, d)
        got, ref = rn.rmsnorm_bwd(x, gw, dh), rn.rmsnorm_bwd_plain(x, gw, dh)
        torch.cuda.synchronize()
        xr, gr = (t.clone().requires_grad_() for t in (x, gw))
        out = F.rms_norm(xr, (d,), gr, 1e-5)

        def library():
            return torch.autograd.grad(out, (xr, gr), dh, retain_graph=True)
        return with_norm_bwd_parts(dict(
            shape=f"{what}: n={n} d={d} bf16",
            **compare_bwd("rmsnorm_bwd", list(zip(got, ref))),
            ms=cuda_ms(lambda: rn.rmsnorm_bwd(x, gw, dh), iters=50),
            plain_ms=cuda_ms(lambda: rn.rmsnorm_bwd_plain(x, gw, dh),
                             iters=20),
            **bound(cost.rmsnorm_bwd(n, d)),
            library_ms=cuda_ms(library, iters=50),
            **device_times([lambda: rn.rmsnorm_bwd(x, gw, dh)], [library])),
            lambda: rn.rmsnorm_bwd(x, gw, dh), n, d, False)

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
        return with_norm_bwd_parts(dict(
            shape=f"{what}: n={n} d={d} bf16",
            **compare_bwd("fused_add_rmsnorm_bwd",
                          [(got[0], ref[0]), (got[2], ref[2])]),
            ms=cuda_ms(lambda: rn.fused_add_rmsnorm_bwd(s, gw, dh, dso),
                       iters=50),
            plain_ms=cuda_ms(lambda: rn.fused_add_rmsnorm_bwd_plain(
                s, gw, dh, dso), iters=20),
            **bound(cost.fused_add_rmsnorm_bwd(n, d)),
            # no single PyTorch call computes it: the backward of
            # torch.add then F.rms_norm is timed beside it as a yardstick
            library_ms=None,
            composition_ms=cuda_ms(composition, iters=50),
            **device_times([lambda: rn.fused_add_rmsnorm_bwd(
                s, gw, dh, dso)], [composition], name="composition"),
            library_device_ms=None),
            lambda: rn.fused_add_rmsnorm_bwd(s, gw, dh, dso), n, d, True)

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
            **bound(cost.decode_attention(lens, H, Hk, hd)),
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
            **bound(cost.rmsnorm(n, d)),
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
            **bound(cost.fused_add_rmsnorm(n, d)),
            # no single PyTorch call computes it: torch.add then
            # F.rms_norm is timed beside it as a yardstick
            library_ms=None,
            composition_ms=cuda_ms(composition, iters=50),
            **device_times([lambda: rn.fused_add_rmsnorm(
                x, y, gw, block_rows=block_rows)], [composition],
                name="composition"),
            library_device_ms=None)

    def ffn_weights(E, D, Fd):
        return ((randn(E, D, Fd).float() * D ** -0.5).to(torch.bfloat16),
                (randn(E, D, Fd).float() * D ** -0.5).to(torch.bfloat16),
                (randn(E, Fd, D).float() * Fd ** -0.5).to(torch.bfloat16))

    def ffn(what, N, E=64, D=2048, Fd=1408, rows_of=None, weights=None):
        # rows_of: x is rows [N, 2N) of a (E, rows_of, D) buffer, read in
        # place (a Comet chunk of the dispatch buffer); weights: shared
        # between cases (grok's 9.7 GB)
        x = randn(E, N, D) if rows_of is None else randn(E, rows_of, D)[
            :, N:2 * N]
        w1, w3, w2 = weights or ffn_weights(E, D, Fd)
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
            **bound(cost.grouped_ffn(E, N, D, Fd)),
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

    def grok_ffn():
        # grok-1-314b's 8 experts at D=6144, F=32768 (the mesh phase's
        # one rank: zero3 prefill and ff-sharded decode both run the
        # whole F): the B=1 S=2048 prefill's capacity 640 and the B=1
        # decode's 4, on one set of weights
        g = "grok-1-314b (mesh phase, one rank)"
        w = ffn_weights(8, 6144, 32768)
        cases = [ffn(f"{g} prefill B=1 S=2048, zero3", 640, E=8, D=6144,
                     Fd=32768, weights=w),
                 ffn(f"{g} decode B=1, ff-sharded", 4, E=8, D=6144,
                     Fd=32768, weights=w)]
        del w
        gc.collect()
        torch.cuda.empty_cache()
        return cases

    def gate_bwd(what, N, E=64, D=2048, Fd=1408):
        h1, h3, dh = randn(E, N, Fd), randn(E, N, Fd), randn(E, N, Fd)
        got = gm.grouped_ffn_gate_bwd(h1, h3, dh)
        want = gm.grouped_ffn_gate_bwd_plain(h1, h3, dh)
        gate = compare_bwd("grouped_ffn_gate_bwd", list(zip(got, want)))
        # GroupedFFN's whole backward at the expert FFN's own shape
        x, dy = randn(E, N, D), randn(E, N, D)
        ws = [(randn(*sh).float() * sh[1] ** -0.5).to(torch.bfloat16)
              for sh in ((E, D, Fd), (E, D, Fd), (E, Fd, D))]
        ins = [t.requires_grad_() for t in (x, *ws)]
        y = gm.grouped_ffn(*ins)
        bwd = torch.autograd.grad(y, ins, dy, retain_graph=True)
        ref = [t.detach().float().requires_grad_() for t in ins]
        want_bwd = torch.autograd.grad(gm.grouped_ffn_plain(*ref), ref,
                                       dy.float())
        whole = compare_bwd("grouped_ffn_bwd", list(zip(bwd, want_bwd)))
        del ref, want_bwd
        torch.cuda.synchronize()
        n = E * N * Fd

        def kernel():
            return gm.grouped_ffn_gate_bwd(h1, h3, dh)

        def plain():
            return gm.grouped_ffn_gate_bwd_plain(h1, h3, dh)
        return dict(
            shape=f"{what}: E={E} N={N} F={Fd} bf16 (h1, h3, dh)",
            **{**gate, "ok": gate["ok"] and whole["ok"]},
            grouped_ffn_backward=dict(
                shape=f"x ({E}, {N}, {D}), w1/w3 ({E}, {D}, {Fd}), w2 "
                      f"({E}, {Fd}, {D}) bf16, against torch.autograd of "
                      "the f32 plain forward", **whole,
                ms=cuda_ms(lambda: torch.autograd.grad(
                    y, ins, dy, retain_graph=True), iters=5)),
            ms=cuda_ms(kernel),
            plain_ms=cuda_ms(plain, iters=5),
            **bound(cost.grouped_ffn_gate_bwd(n)),
            # no single PyTorch call computes the gate's backward: the
            # plain composition of torch ops is the yardstick
            library_ms=None,
            composition_ms=cuda_ms(plain),
            **device_times([kernel], [plain], name="composition"),
            library_device_ms=None)

    def scan(what, b, H, N, L=2048, P=64, G=1):
        args = ssd_inputs(g, b, L, H, P, N)
        out, ref = ssd.ssd_scan(*args), ssd.ssd_scan_plain(*args)
        torch.cuda.synchronize()
        Q = ssd.chunk_len(L, 128)
        return dict(
            shape=f"{what}: b={b} L={L} H={H} P={P} G={G} N={N} Q={Q} bf16",
            **compare("ssd_scan", [(out, ref)]),
            ms=cuda_ms(lambda: ssd.ssd_scan(*args), iters=10),
            plain_ms=cuda_ms(lambda: ssd.ssd_scan_plain(*args), iters=3),
            **bound(cost.ssd_scan(b, L, H, P, G, N, Q)),
            # no single PyTorch call computes an SSD scan
            library_ms=None,
            **device_times([lambda: ssd.ssd_scan(*args)]))

    def scan_bwd(what, b, H, N, L=2048, P=64, G=1):
        args = ssd_inputs(g, b, L, H, P, N)
        dy = randn(b, L, H, P)
        got = ssd.ssd_scan_bwd(*args, dy)
        want = ssd.ssd_scan_bwd_plain(*args, dy)
        again = ssd.ssd_scan_bwd(*args, dy)
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        row = compare_bwd("ssd_scan_bwd", [
            (a, w) for a, w in zip(got, want) if a.dtype == torch.bfloat16])
        f32_l2 = {n: rel_err(a, w) for n, a, w in zip(
            ("dx", "ddt", "dA", "dB", "dC", "dD"), got, want)
            if a.dtype == torch.float32}
        row["f32_rel_l2"] = f32_l2
        row["ok"] = (row["ok"] and same and max(f32_l2.values())
                     <= TOL["ssd_scan_bwd"]["f32_l2"])
        del got, want, again
        # the composition: torch.autograd of ssd_scan_plain, its backward
        # alone (the forward's graph kept)
        leaf = [t.detach().requires_grad_() for t in args]
        y = ssd.ssd_scan_plain(*leaf)

        def comp():
            return torch.autograd.grad(y, leaf, dy, retain_graph=True)

        def kernel():
            return ssd.ssd_scan_bwd(*args, dy)

        Q = ssd.chunk_len(L, 128)
        geo = ssd.ssd_bwd_geometry(b, L, H, G, N, Q, sm_count(0))
        out = dict(
            shape=f"{what}: b={b} L={L} H={H} P={P} G={G} N={N} Q={Q}, "
                  "bf16 x/B/C/dy, f32 dt/A/D",
            **row, same_bits_twice=same,
            geometry={k: geo[k] for k in ("sets", "units",
                                          "heads_per_unit")},
            workspace_bytes=4 * geo["words"],
            ms=cuda_ms(kernel, iters=10),
            plain_ms=cuda_ms(lambda: ssd.ssd_scan_bwd_plain(*args, dy),
                             iters=3),
            **bound(cost.ssd_scan_bwd(b, L, H, P, G, N, Q)),
            # no single PyTorch call computes the scan's gradient: the
            # yardstick is autograd of the plain composition
            library_ms=None,
            composition_ms=cuda_ms(comp, iters=3),
            **device_times([kernel], [comp], name="composition"),
            library_device_ms=None,
            pass_device_ms=pass_ms(kernel, (
                "ssd_bwd_states", "ssd_bwd_walk", "ssd_bwd_chunk",
                "ssd_bwd_reduce")))
        out["bound_share"] = out["bound_ms"] / out["device_ms"]
        del leaf, y
        torch.cuda.empty_cache()
        return out

    def adamw_state(shapes, dtypes, gdtypes=None):
        ps = [randn(*sh).to(dt) for sh, dt in zip(shapes, dtypes)]
        gs = [(randn(*sh).float() * 1e-2).to(dt)
              for sh, dt in zip(shapes, gdtypes or dtypes)]
        ms = [randn(*sh).float() * 1e-3 for sh in shapes]
        vs = [torch.rand(sh, generator=g, device=dev) * 1e-5
              for sh in shapes]
        return ps, gs, ms, vs

    def adamw_scalars(count, clip):
        cf = torch.full((), float(count), device=dev)
        return dict(lr=torch.full((), 3e-4, device=dev),
                    scale=torch.full((), 0.37, device=dev) if clip else None,
                    c1=1.0 - torch.pow(torch.full((), 0.9, device=dev), cf),
                    c2=1.0 - torch.pow(torch.full((), 0.95, device=dev), cf))

    consts = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)

    def adamw_bits(ps, gs, ms, vs, sc):
        """One kernel update against the plain chain on clones: (max abs
        error, the same bits)."""
        want = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
        kadamw.adamw_plain(want[0], gs, want[1], want[2], **sc, **consts)
        kadamw.adamw(ps, gs, ms, vs, **sc, **consts)
        torch.cuda.synchronize()
        pairs = list(zip(ps + ms + vs, want[0] + want[1] + want[2]))
        return (max(max_err(a, b) for a, b in pairs),
                all(torch.equal(a, b) for a, b in pairs))

    def adamw_odd():
        """The odd leaf sizes (not multiples of the vector width), bf16
        and f32 params, count 1 and 1000, clipping off and on: the same
        bits as the plain chain in every case."""
        shapes = [(1,), (577,), (4097, 3), (65024, 4096)]
        cases = []
        for dt in (torch.bfloat16, torch.float32):
            for count in (1, 1000):
                for clip in (0, 1):
                    st = adamw_state(shapes, [dt] * len(shapes))
                    err, same = adamw_bits(*st, adamw_scalars(count, clip))
                    cases.append({"dtype": str(dt), "count": count,
                                  "grad_clip": clip, "max_abs_err": err,
                                  "same_bits": same})
                    del st
        return cases

    def adamw_set(what, cfg, odd=None):
        """The train step's leaf set of ``cfg``: bits against the plain
        chain, then the kernel's and the chain's times."""
        from repro_torch.api import compile
        from repro_torch.tree import leaves
        tree = compile(cfg).init_params(SEED, phase="train")
        shapes = [tuple(t.shape) for t in leaves(tree)]
        dtypes = [t.dtype for t in leaves(tree)]
        del tree
        st = adamw_state(shapes, dtypes)
        sc = adamw_scalars(1000, 1)
        err, same = adamw_bits(*st, sc)
        n = sum(p.numel() for p in st[0])
        need = cost.adamw([(p.numel(), p.element_size(), g.element_size())
                           for p, g in zip(st[0], st[1])])
        before = LAUNCHES_["adamw"]
        kadamw.adamw(*st, **sc, **consts)
        launches = LAUNCHES_["adamw"] - before
        row = dict(
            shape=f"{what}: {len(shapes)} leaves, {n} params "
                  f"({', '.join(sorted({str(d) for d in dtypes}))}), "
                  "count 1000, grad_clip 1",
            leaves=len(shapes), params=n, launches_per_call=launches,
            max_abs_err=err, same_bits=same,
            rel_l2=0.0 if same else 1.0, ok=same and launches == 1
            and (odd is None or all(c["same_bits"] for c in odd)),
            tolerance="bitwise",
            ms=cuda_ms(lambda: kadamw.adamw(*st, **sc, **consts), iters=20),
            plain_ms=cuda_ms(lambda: kadamw.adamw_plain(*st, **sc, **consts),
                             iters=3),
            **bound(need),
            bytes_per_param=need.nbytes / n,
            # torch.optim.AdamW's arithmetic differs (optim/adamw.py), so
            # no single PyTorch call computes this function
            library_ms=None,
            info=kadamw.adamw_info(),
            **device_times([lambda: kadamw.adamw(*st, **sc, **consts)]))
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        if odd is not None:
            row["odd_sizes"] = odd
        del st
        torch.cuda.empty_cache()
        return row

    glm, m2, z2 = "chatglm3-6b", "mamba2-2.7b", "zamba2-1.2b"
    sm = "smollm-135m"
    mt, dc, wt, qw = DENSE_CONFIGS + ("whisper-tiny", "qwen2-vl-7b")
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
                    flash(f"{sm} train B=8", 8, 2048, 9, 3, hd=64),
                    # whisper-tiny's encoder self-attention and its
                    # prefill cross-attention (S_enc = S = 1500: the last
                    # K/V tile is short), then one decode row against the
                    # zero-padded encoder states
                    flash(f"{wt} encoder / cross prefill", 4, 1500, 6, 6,
                          hd=64, causal=False),
                    flash(f"{wt} decode cross-attention", 4, 2048, 6, 6,
                          hd=64, causal=False, Sq=1),
                    # GQA groups of 7
                    flash(f"{qw} prefill", 4, 2048, 28, 4),
                    flash(f"{dc} prefill", 4, 2048, 56, 8)]),
        kernel_row("decode_attention", "cuda",
                   "src/repro_torch/kernels/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:56",
                   [decode(f"{glm} decode", 32, 2),
                    decode(f"{z2} shared block decode", 32, 32),
                    decode("deepseek-moe-16b decode", 16, 16),
                    decode(f"{dc} decode", 56, 8),
                    decode(f"{qw} decode", 28, 4),
                    decode(f"{mt} decode", 32, 8),
                    # the self-attention of whisper-tiny's decode steps,
                    # past its 1500-token prefill
                    decode(f"{wt} decode", 6, 6, S=2048, hd=64,
                           lens=(1516, 1510, 1505, 1501))]),
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
                    norm(f"{sm} train B=8", 16384, 576),
                    # the prefills of minitron-8b, deepseek-coder-33b,
                    # whisper-tiny and qwen2-vl-7b
                    norm(f"{wt} prefill B=4 S=1500", 6000, 384),
                    norm(f"{qw} prefill B=4", 8192, 3584),
                    norm(f"{mt} prefill B=4", 8192, 4096),
                    norm(f"{dc} prefill B=4", 8192, 7168)]),
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
                    fused(f"{sm} train B=8, TokenWeave", 16384, 576),
                    # whisper-tiny is not sequence parallel: ``dynamic``
                    # fuses its chains under TokenWeave at prefill
                    fused(f"{wt} prefill B=4 S=1500, TokenWeave", 6000,
                          384)]),
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
                    ffn("deepseek-moe-16b chunk (1, 1024)", 120)]
                   + grok_ffn()),
        # the MoE train step's gate backward (deepseek-moe-16b B=2
        # S=2048): capacity 480 of 4096 tokens (sequential), 240 of a
        # DBO micro-batch's 2048
        kernel_row("grouped_ffn_gate_bwd", "cuda",
                   "src/repro_torch/kernels/csrc/grouped_ffn_bwd.cu",
                   "src/repro/models/moe.py:211",
                   [gate_bwd("deepseek-moe-16b train, sequential", 480),
                    gate_bwd("deepseek-moe-16b train, DBO micro-batch",
                             240)]),
        # x, B and C are column views of one post-conv buffer, as the
        # model hands them over
        kernel_row("ssd_scan", "cuda",
                   "src/repro_torch/kernels/csrc/ssd_scan.cu",
                   "src/repro/kernels/ssd_scan.py:63",
                   [scan(f"{m2} prefill", 4, 80, 128),
                    scan(f"{m2} NanoFlow half", 2, 80, 128),
                    scan(f"{z2} NanoFlow half", 2, 64, 64)]),
        # the scan's gradient at the ssm_train phase's NanoFlow halves
        # (B=2 S=2048 split in two rows): the VJP of the reference's
        # SSDScanOp._ref, whose Pallas scan has no VJP
        kernel_row("ssd_scan_bwd", "cuda",
                   "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                   "src/repro/models/mamba2.py:132",
                   [scan_bwd(f"{m2} train, NanoFlow half", 1, 80, 128),
                    scan_bwd(f"{z2} train, NanoFlow half", 1, 64, 64)]),
        # the backward kernels, at the train phase's shapes
        kernel_row("flash_attention_bwd", "cuda",
                   "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                   "src/repro/models/layers.py:563",
                   [flash_bwd(f"{sm} train", 8, 2048, 9, 3, 64),
                    flash_bwd(f"{glm} train", 2, 2048, 32, 2, 128),
                    # whisper-tiny's encoder and cross-attention; qwen2-vl
                    # GQA group of 7
                    flash_bwd(f"{wt} train encoder / cross", 8, 1500, 6, 6,
                              64, causal=False),
                    flash_bwd(f"{qw} train", 2, 2048, 28, 4, 128)]),
        kernel_row("rmsnorm_bwd", "cuda",
                   "src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
                   "src/repro/models/layers.py:170",
                   [norm_bwd(f"{sm} train B=8", 16384, 576),
                    norm_bwd(f"{glm} train B=2", 4096, 4096),
                    norm_bwd(f"{wt} train B=8", 12000, 384),
                    norm_bwd(f"{qw} train B=2", 4096, 3584)]),
        kernel_row("fused_add_rmsnorm_bwd", "cuda",
                   "src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
                   "src/repro/kernels/ops.py:63",
                   [fused_bwd(f"{sm} train B=8", 16384, 576),
                    fused_bwd(f"{glm} train B=2", 4096, 4096),
                    # whisper-tiny's train step under TokenWeave
                    fused_bwd(f"{wt} train B=8", 12000, 384)]),
        # the train step's update over every leaf, one launch: the JAX
        # package has no Pallas call here (XLA fuses the chain in its
        # jitted step)
        kernel_row("adamw", "cuda", "src/repro_torch/kernels/csrc/adamw.cu",
                   "src/repro/optim/adamw.py:70",
                   [adamw_set(f"{glm} 4 layers", dataclasses.replace(
                       get_config(glm), n_layers=4), odd=adamw_odd()),
                    adamw_set(sm, get_config(sm))]),
    ]
    lib = _build.library()
    builds = ptxas_report(_build.BUILD_LOG, ("flash_fwd_kernel",
                                             "flash_bwd_dkdv_kernel",
                                             "flash_bwd_dq_kernel",
                                             # both backwards' bodies,
                                             # <W, NP, FUSED>
                                             "norm_bwd_kernelI",
                                             "ffn_gemm_kernel",
                                             "ssd_scan_kernel",
                                             "ssd_bwd_",
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
           for n in (128, 64)},
        **{f"ssd_scan_bwd {part} N={n}": _build.kernel_info(
            lambda v, *a, w=w: lib.repro_ssd_scan_bwd_info(v, w, *a), n)
           for n in (128, 64) for w, part in enumerate(
               ("states", "walk", "chunk", "reduce"))},
        "grouped_ffn_gate_bwd": _gate_bwd_info(lib)}
    reset_launch_counts()
    log({"phase": "kernels", "build_s": build_s, "builds": builds,
         "tolerance": "per kernel: |kernel - plain| <= atol + rtol*|plain| "
                      "(+ pv*P|V| for flash) elementwise and relative L2 "
                      "<= l2 (reasons in chip_smoke.py TOL)",
         "results": rows})
    return rows


def _gate_bwd_info(lib):
    """Registers a thread, spill bytes and resident blocks an SM of the
    gate backward kernel."""
    import ctypes

    from repro_torch.kernels import _build
    regs, local, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _build.check(lib.repro_grouped_ffn_gate_bwd_info(
        ctypes.byref(regs), ctypes.byref(local), ctypes.byref(per_sm)),
        "grouped_ffn_gate_bwd_info")
    return {"registers": regs.value, "local_bytes": local.value,
            "blocks_per_sm": per_sm.value}


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


def mrope_positions(B, S, grid):
    """M-RoPE's (3, B, S) int32 positions as Qwen2-VL lays them out: image
    patches on a (t, h, w) grid, each stream a coordinate, then text
    whose three streams continue equal from the grid's largest position
    + 1."""
    import torch
    t, h, w = grid
    n = t * h * w
    img = torch.stack([a.flatten() for a in torch.meshgrid(
        torch.arange(t), torch.arange(h), torch.arange(w), indexing="ij")])
    first = int(img.max()) + 1
    txt = torch.arange(first, first + S - n).expand(3, S - n)
    pos = torch.cat([img, txt], 1).to(torch.int32)
    return pos[:, None, :].expand(3, B, S).contiguous()


def vlm_grid(S):
    """The image grid of a VLM input of S positions: 1 x s x s patches,
    the largest square of at most half the sequence (1 x 32 x 32 at
    S = 2048)."""
    side = 1
    while (side + 1) ** 2 <= S // 2:
        side += 1
    return (1, side, side)


def model_batch(cfg, B, S, dev, seed, labels=False):
    """A prefill's inputs (with ``labels``, a train step's) for ``cfg``'s
    family: ids and positions as ``prefill_batch`` (``train_batch``) draws
    them; M-RoPE's (3, B, S) positions on ``vlm_grid(S)`` with ``vis``
    random on the patches and zero on the text (vlm); random ``frames``
    (encdec), the stub frontends' outputs."""
    import torch
    batch = (train_batch(B, S, cfg.vocab, "cpu", seed) if labels
             else prefill_batch(B, S, cfg.vocab, "cpu", seed))
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    if cfg.rope == "mrope":
        grid = vlm_grid(S)
        batch["positions"] = mrope_positions(B, S, grid)
    if cfg.family == "vlm":
        n = grid[0] * grid[1] * grid[2]
        vis = torch.zeros((B, S, cfg.d_model))
        vis[:, :n] = torch.randn((B, n, cfg.d_model), generator=g)
        batch["vis"] = vis.to(torch.bfloat16)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((B, S, cfg.d_model),
                                      generator=g).to(torch.bfloat16)
    return {k: v.to(dev) for k, v in batch.items()}


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
    t0 = time.perf_counter()
    # drawn on the card (the CPU's generator takes tens of seconds at
    # minitron-8b's 2.6 B parameters) and copied to the CPU
    gpu_params = prog.init_params(SEED)
    params = _copy_tree(gpu_params, "cpu")
    init_s = time.perf_counter() - t0
    step = prog.prefill(B, S)
    batch = model_batch(cfg, B, S, "cpu", SEED)
    t0 = time.perf_counter()
    with recorded_routes() as cpu_routes:
        want = step(params, batch)
    cpu_s = time.perf_counter() - t0
    gpu_batch = {k: v.to(dev) for k, v in batch.items()}
    with recorded_routes() as gpu_routes:
        got, counts = counted(totals, lambda: step(gpu_params, gpu_batch))
    checks = {}
    for key in [k for k in want if k in ("logits", "enc")
                or k.split(".")[-1] in ("k", "v")]:
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
           "kernel_launches": counts, "init_s": init_s, "cpu_s": cpu_s}
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
    for k in ("plain", 4, 8):
        spec = None if k == "plain" else spec_config(
            oracle_proposer(seqs), k)
        r = spec_run(prog, params, spec)
        st = r["counters"]
        row = oracle[str(k)] = {"tokens_per_s": [r["tokens_per_s"]],
                                "wall_s": [r["wall_s"]], "counters": st}
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

# the kernels of every dense step's gradients, of the whole step (the
# AdamW pass too), and TokenWeave's pair
GRAD_KERNELS = ("flash_attention", "flash_attention_bwd", "rmsnorm",
                "rmsnorm_bwd")
TRAIN_KERNELS = GRAD_KERNELS + ("adamw",)
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
    lookup; a tied table is the head's matmul; of a MoE's routed experts
    only the top_k of n_experts a token passes, not the capacity's
    padding) plus the causal attention's 2 (B S^2 H hd / 2) per layer
    forward, three times for the forward and backward.  Recomputation
    under remat is not counted."""
    from repro_torch.tree import leaves
    n = sum(t.numel() for t in leaves(params))
    if not cfg.tie_embeddings:
        n -= cfg.vocab * cfg.d_model
    if cfg.moe is not None:
        routed = sum(t.numel() for t in leaves(
            params["layers"]["moe"]["experts"]))
        n -= routed * (1 - cfg.moe.top_k / cfg.moe.n_experts)
    attn = 3 * 4.0 * B * S * S * cfg.n_heads * cfg.hd * 0.5 * cfg.n_layers
    return 6.0 * n * B * S + attn, n


def _bits_equal(a, b):
    """(every leaf of ``a`` equal to ``b``'s bit for bit, the names of
    those that differ)."""
    import torch

    from repro_torch.tree import leaves_with_paths
    want = dict(leaves_with_paths(b))
    bad = ["/".join(p) for p, t in leaves_with_paths(a)
           if not torch.equal(t, want[p])]
    return not bad, bad


def graph_vs_eager(step, params, opt, batch, first_step, steps=3):
    """``steps`` replays of the graphed step (captured on ``params`` and
    ``opt``) against as many steps of ``step.eager`` on copies of the same
    state and the same batch: params, m, v, count and the four metrics
    compared bit for bit after every step.  Trains ``params`` on."""
    import torch
    ep, eo = _copy_tree(params), _copy_tree(opt)
    replays = step.stats["graph_replays"]
    per_step, ok = [], True
    for j in range(steps):
        _, _, m = step(params, opt, batch, first_step + j)
        m = _copy_tree(m)
        _, _, em = step.eager(ep, eo, batch, first_step + j)
        torch.cuda.synchronize()
        checks = {name: _bits_equal(a, b) for name, a, b in (
            ("metrics", m, em), ("params", params, ep), ("opt", opt, eo))}
        per_step.append({"loss": float(m["loss"]),
                         "eager_loss": float(em["loss"]),
                         **{k: v[0] for k, v in checks.items()},
                         "differ": [n for v in checks.values()
                                    for n in v[1]][:8]})
        ok = ok and all(v[0] for v in checks.values())
    del ep, eo
    replayed = step.stats["graph_replays"] - replays
    return {"steps": per_step, "replays": replayed,
            "ok": ok and replayed == steps}


# the step's parts, as ranges of the profiled eager step
PARTS = (("adamw", "adamw_update"),
         ("grad_reduce_norm", "reduce_grads"),
         ("grad_reduce_norm", "global_grad_norm"))


def _elementwise(name):
    return "elementwise" in name or "reduce_kernel" in name


def train_attribution(step, params, opt, batch, first_step, windows=3):
    """Device time of the eager step by part (``_profile``'s ``ranges``):
    ``adamw`` (under ``adamw_update``), ``grad_reduce_norm`` (under
    ``reduce_grads`` and ``global_grad_norm``) and ``forward_backward``
    (the rest: the forward, the loss and the backward), before the fused
    pass (the AdamW chain op by op, ``kernels.adamw.adamw_plain``) and
    after it (the kernel).  The ranges are wrapped around the step
    module's functions here, not in the package.  Trains ``params``
    on."""
    from torch.profiler import record_function

    from repro_torch.kernels import adamw as kadamw
    from repro_torch.train import step as step_mod

    def ranged(name, fn):
        def call(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return call

    saved = {fn: getattr(step_mod, fn) for _, fn in PARTS}
    real = kadamw.adamw
    at = [first_step]

    def one():
        step.eager(params, opt, batch, at[0])
        at[0] += 1

    out = {}
    try:
        for part, fn in PARTS:
            setattr(step_mod, fn, ranged(part, saved[fn]))
        for when, chain in (("before_fused_pass", kadamw.adamw_plain),
                            ("after_fused_pass", real)):
            kadamw.adamw = chain
            one()                                   # warm
            prof = _profile(one, 1, windows,
                            ranges={part for part, _ in PARTS})
            out[when] = {k: prof[k] for k in (
                "window_kernels", "windows_dropped",
                "kernel_launches_per_step", "device_ms_per_step", "ranges",
                "attributed_by_name_ms")}
    finally:
        kadamw.adamw = real
        for fn, orig in saved.items():
            setattr(step_mod, fn, orig)
    return out


def step_timings(step, params, opt, batch, cfg, totals, first_step,
                 flops=None):
    """Warm timings of ``step`` (a replay of its graph once it was
    captured on ``params``): wall ms a step (CUDA events, three windows of
    3 steps), the profiler's device ms a step and busy share, tokens/s,
    MFU (``flops``: (model FLOPs a step, matmul params), by default
    ``train_flops``), peak allocated and reserved memory over one step and
    the launches of one step.  Trains ``params`` on."""
    import torch
    B, S = batch["ids"].shape
    i = first_step
    step(params, opt, batch, i)                   # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (_, _, m), launches = counted(totals, lambda: step(params, opt, batch,
                                                       i + 1))
    loss_after = float(m["loss"])     # the next replay rewrites m
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    walls = []
    for w in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for j in range(3):
            step(params, opt, batch, i + 2 + 3 * w + j)
        end.record()
        end.synchronize()
        walls.append(start.elapsed_time(end) / 3)
    wall = sum(walls) / len(walls)
    prof = _profile(lambda: step(params, opt, batch, i + 11), 2)
    flops, n = flops or train_flops(cfg, params, B, S)
    return {"step_wall_ms": wall, "step_wall_ms_windows": walls,
            "step_device_ms": prof["device_ms_per_step"],
            "device_busy_share": prof["device_busy_share"],
            "kernel_launches_per_step": prof["kernel_launches_per_step"],
            "profile_window_kernels": prof["window_kernels"],
            "profile_windows_dropped": prof["windows_dropped"],
            "cpu_ops_per_step": prof["cpu_ops_per_step"],
            "top_device_ms_per_step": prof["top_device_ms_per_step"],
            "tokens_per_s": B * S / (wall / 1e3),
            "model_flops_per_step": flops, "matmul_params": n,
            "mfu": flops / (wall / 1e3) / PEAK_BF16_FLOPS,
            "peak_memory_gb": peak / 1e9,
            "peak_reserved_gb": peak_reserved / 1e9,
            "kernel_launches_one_step": launches,
            "loss_after": loss_after}


def capture_record(step, before):
    """The graph counters the step moved since ``before`` (a copy of its
    ``stats``), with its pool's bytes."""
    return {"graph_captures": step.stats["graph_captures"]
            - before["graph_captures"],
            "capture_s": step.stats["capture_s"] - before["capture_s"],
            "graph_pool_gb": (step.stats["graph_nbytes"]
                              - before["graph_nbytes"]) / 1e9}


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
    (_, _, m_gpu), step_counts = counted(
        totals, lambda: step(gpu_params, gpu_opt, gpu_batch, 0))
    metrics = {k: (float(m_gpu[k]), float(m_cpu[k])) for k in m_cpu}
    gn_err = abs(metrics["grad_norm"][0] - metrics["grad_norm"][1]) \
        / metrics["grad_norm"][1]
    ok = (ok and gn_err < TRAIN_TOL["grad_norm_rel"]
          and abs(metrics["loss"][0] - metrics["loss"][1])
          < TRAIN_TOL["loss_rel"] * metrics["loss"][1]
          and all(counts.get(k, 0) > 0 for k in GRAD_KERNELS)
          and all(step_counts.get(k, 0) > 0 for k in TRAIN_KERNELS))
    log({"phase": "train_cut",
         "config": "smollm-135m at full width, 2 layers, B=%d S=%d, "
                   "policy dynamic" % CUT_SHAPE, "strategies": step.strategies,
         "grads": checks, "step_metrics_gpu_cpu": metrics,
         "grad_norm_rel_err": gn_err, "kernel_launches": counts,
         "step_kernel_launches": step_counts,
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
          and all(counts.get(k, 0) > 0 for k in GRAD_KERNELS)
          # a run that fuses nothing must not pass as having fused
          and all((counts.get(k, 0) > 0) == fused for k in FUSED_PAIR))
    rec = {"dynamic_strategies": dyn.strategies,
           "first_step_dynamic_vs_sequential": checks,
           "first_step_launches": counts}
    return dyn, params, batch, rec, ok


def phase_train(dev, totals):
    """smollm-135m as published (B=8, S=2048): dynamic against sequential,
    the loss falling over a loop on one repeated batch, the graphed step
    against the eager one bit for bit, crash-restart; then chatglm3-6b
    at full width cut to 4 layers (B=2, S=2048)."""
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
    stats0 = dict(dyn.fn.stats)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    p, o, hist = train_loop(dyn.fn, params, dyn.init_opt(params),
                            RepeatedBatch(batch), loop_cfg)
    loop_s = time.perf_counter() - t0
    capture = {**capture_record(dyn.fn, stats0),
               "loop_peak_allocated_gb": torch.cuda.max_memory_allocated()
               / 1e9,
               "loop_peak_reserved_gb": torch.cuda.max_memory_reserved()
               / 1e9}
    losses = [h["loss"] for h in hist]
    last5 = sum(losses[-5:]) / 5
    falls = last5 < losses[0] - LOOP_MARGIN
    bitwise = graph_vs_eager(dyn.fn, p, o, batch, LOOP_STEPS)
    # crash at CRASH_AT, restored from the checkpoint at step CKPT_EVERY
    # into the same tensors: one capture (of the fresh copies), none after
    with tempfile.TemporaryDirectory() as ckpt:
        sim = FailureSimulator(crash_steps=(CRASH_AT,))
        cp = _copy_tree(init)
        stats1 = dict(dyn.fn.stats)
        _, _, chist = train_loop(
            dyn.fn, cp, dyn.init_opt(cp), RepeatedBatch(batch),
            TrainLoopConfig(steps=CRASH_STEPS, ckpt_dir=ckpt,
                            ckpt_every=CKPT_EVERY, log_every=10 ** 9),
            failure_sim=sim)
        crash_captures = capture_record(dyn.fn, stats1)["graph_captures"]
    del cp
    restart = chist[CRASH_AT:]
    rerun_steps = [h["step"] for h in restart]
    crash_err = max(abs(h["loss"] - losses[h["step"]]) / losses[h["step"]]
                    for h in restart)
    crash_ok = (sim.injected == [("crash", CRASH_AT)]
                and rerun_steps == list(range(CKPT_EVERY, CRASH_STEPS))
                and crash_err < 1e-4 and crash_captures == 1)
    first = LOOP_STEPS + bitwise["replays"]
    timings = step_timings(dyn.fn, p, o, batch, cfg, totals, first)
    attribution = train_attribution(dyn.fn, p, o, batch, first + 20)
    this_ok = (this_ok and falls and crash_ok and bitwise["ok"]
               and capture["graph_captures"] == 1
               and all(timings["kernel_launches_one_step"].get(k, 0) > 0
                       for k in TRAIN_KERNELS))
    ok = ok and this_ok
    log({"phase": "train", "config": "smollm-135m as published, B=%d "
         "S=%d, TrainStepConfig(lr=1e-3, warmup=3, total_steps=30, "
         "remat), the step one CUDA Graph" % SMOLLM_SHAPE, **rec,
         "capture": capture,
         "loop": {"steps": LOOP_STEPS, "losses": losses,
                  "first": losses[0], "last5_mean": last5,
                  "margin": LOOP_MARGIN, "falls": falls, "loop_s": loop_s,
                  "step_time_s": [h["step_time_s"] for h in hist]},
         "graph_vs_eager": bitwise,
         "crash_restart": {"crash_at": CRASH_AT, "ckpt_every": CKPT_EVERY,
                           "steps_rerun": rerun_steps,
                           "max_loss_rel_err_vs_uncrashed": crash_err,
                           "graph_captures": crash_captures,
                           "ok": crash_ok},
         **timings, "attribution": attribution,
         "tolerance": dict(TRAIN_TOL, crash_loss_rel=1e-4,
                           graph_vs_eager="bitwise"),
         "ok": this_ok})
    del dyn, params, p, o, init
    gc.collect()
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config("chatglm3-6b"), n_layers=4)
    dyn, params, batch, rec, this_ok = _dyn_seq_train(
        cfg, *GLM_SHAPE, dev, totals, TrainStepConfig(), "nanoflow")
    opt = dyn.init_opt(params)
    stats0 = dict(dyn.fn.stats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dyn.fn(params, opt, batch, 0)             # runs the step, captures it
    torch.cuda.synchronize()
    capture = {**capture_record(dyn.fn, stats0),
               "capture_peak_allocated_gb": torch.cuda.max_memory_allocated()
               / 1e9,
               "capture_peak_reserved_gb": torch.cuda.max_memory_reserved()
               / 1e9}
    bitwise = graph_vs_eager(dyn.fn, params, opt, batch, 1)
    gc.collect()
    torch.cuda.empty_cache()                  # the eager copies' memory
    timings = step_timings(dyn.fn, params, opt, batch, cfg, totals,
                           1 + bitwise["replays"])
    attribution = train_attribution(dyn.fn, params, opt, batch, 30)
    this_ok = (this_ok and bitwise["ok"] and capture["graph_captures"] == 1
               and all(timings["kernel_launches_one_step"].get(k, 0) > 0
                       for k in TRAIN_KERNELS))
    ok = ok and this_ok
    log({"phase": "train_chatglm3", "config": "chatglm3-6b at full width, "
         "4 layers, B=%d S=%d, TrainStepConfig() (remat), the step one "
         "CUDA Graph" % GLM_SHAPE, **rec, "capture": capture,
         "graph_vs_eager": bitwise, **timings, "attribution": attribution,
         "tolerance": dict(TRAIN_TOL, graph_vs_eager="bitwise"),
         "ok": this_ok})
    del dyn, params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return ok


# ---------------------------------------------------------------------------
# phase: moe_train — deepseek-moe-16b trains (DBO, the grouped FFN's
# backward)
# ---------------------------------------------------------------------------

# full width, the dense first layer and 3 MoE layers (2.27 B parameters:
# 4.5 GB of bf16 weights, as much of gradients, 18.2 GB of f32 AdamW
# moments); B=2 S=2048, 4096 tokens: dynamic resolves the MoE layers to
# DBO
MOE_TRAIN_LAYERS, MOE_TRAIN_SHAPE, MOE_LOOP_STEPS = 4, (2, 2048), 8
# DBO against sequential on the first step's loss and gradients.  DBO
# dispatches each micro-batch alone, at a micro-batch's capacity (240 of
# 2048 tokens), so the sequential side is two B=1 runs, as in
# moe_transparency (one B=2 run drops other assignments: its gradients
# differ from two B=1 runs' by ~60% relative L2 on the card); then the
# products differ only in batch size (the merged attention's 4096 rows
# against 2048) and routes flip only on near ties (counted by
# route_check): TRAIN_TOL's loss and leaf limits
MOE_TRAIN_TOL = dict(loss_rel=TRAIN_TOL["loss_rel"],
                     leaf_rel_l2=TRAIN_TOL["leaf_rel_l2"])
MOE_TRAIN_KERNELS = TRAIN_KERNELS + ("grouped_ffn", "grouped_ffn_gate_bwd")


def phase_moe_train(dev, gpu, totals):
    """deepseek-moe-16b at full width cut to 4 layers, B=2 S=2048, through
    ``Program.train_step``'s graphed ``TrainStep``: ``dynamic`` resolves
    the MoE layers to DBO; DBO against two sequential B=1 runs on the
    first step's loss and gradients with route flips counted; the loss
    falling over a short loop on one repeated batch; graph replays
    against ``fn.eager`` bit for bit; the replay's wall and device time,
    MFU, memory and launches, in which both grouped-FFN kernels must
    appear."""
    import math

    import torch

    from repro_torch.api import compile
    from repro_torch.configs import get_config
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (TrainLoopConfig, TrainStepConfig,
                                   train_loop)
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"),
                              n_layers=MOE_TRAIN_LAYERS)
    B, S = MOE_TRAIN_SHAPE
    tcfg = TrainStepConfig(optimizer=AdamWConfig(lr=LOOP_LR),
                           warmup=LOOP_WARMUP, total_steps=MOE_LOOP_STEPS)
    dyn = compile(cfg, policy="dynamic").train_step(B, S, cfg=tcfg)
    seq1 = compile(cfg, policy="sequential").train_step(1, S, cfg=tcfg)
    params = compile(cfg).init_params(SEED, phase="train")
    batch = train_batch(B, S, cfg.vocab, dev)
    rows = [{key: v[b:b + 1] for key, v in batch.items()} for b in range(B)]
    k = cfg.moe.top_k
    wrs = list(params["layers"]["moe"]["router"]["wr"])
    # the routes of one forward each way (DBO routes merged, before the
    # split MoE section)
    with torch.no_grad():
        seq_routes = []
        for row in rows:
            with recorded_routes() as r:
                seq1.fn.forward(params, row)
            seq_routes.append(r)
        seq_routes = [(torch.cat([x for x, _ in layer]),
                       torch.cat([v for _, v in layer]))
                      for layer in zip(*seq_routes)]
        with recorded_routes() as dbo_routes:
            dyn.fn.forward(params, batch)
        share, unexplained = route_check(dbo_routes, seq_routes, wrs, k)
    del seq_routes, dbo_routes
    # the two runs' gradients of their mean losses, weighted by tokens:
    # the gradient of the batch's mean loss
    parts = [seq1.fn.grads(params, row) for row in rows]
    cnt = sum(c for _, (_, c) in parts)
    weights = [c / cnt for _, (_, c) in parts]
    want = (tree_map(lambda *gs: sum(g.float() * w
                                     for g, w in zip(gs, weights)),
                     *[g for g, _ in parts]),
            (sum(ls for _, (ls, _) in parts), cnt))
    del parts
    got, counts = counted(totals, lambda: dyn.fn.grads(params, batch))
    grads, _ = grads_agree(got, want)
    del got, want
    gc.collect()
    torch.cuda.empty_cache()
    vs_seq = {"against": "two sequential B=1 runs",
              "loss": grads["loss"], "loss_sequential": grads["loss_want"],
              "loss_rel_err": grads["loss_rel_err"],
              "routes_agree_share": share,
              "routes_differing_off_a_near_tie": unexplained,
              "grad_leaf_rel_l2_max": grads["leaf_rel_l2_max"],
              "grad_leaf_rel_l2": grads["leaf_rel_l2"],
              "finite": grads["finite"], "launches": counts}
    this_ok = (dyn.strategies.get("layers") == "dbo"
               and grads["finite"] and unexplained == 0
               and grads["loss_rel_err"] < MOE_TRAIN_TOL["loss_rel"]
               and grads["leaf_rel_l2_max"] < MOE_TRAIN_TOL["leaf_rel_l2"]
               and all(counts.get(n, 0) > 0 for n in
                       GRAD_KERNELS + ("grouped_ffn",
                                       "grouped_ffn_gate_bwd")))
    opt = dyn.init_opt(params)
    stats0 = dict(dyn.fn.stats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, hist = train_loop(
        dyn.fn, params, opt, RepeatedBatch(batch),
        TrainLoopConfig(steps=MOE_LOOP_STEPS, log_every=10 ** 9))
    loop_s = time.perf_counter() - t0
    capture = {**capture_record(dyn.fn, stats0),
               "loop_peak_allocated_gb": torch.cuda.max_memory_allocated()
               / 1e9,
               "loop_peak_reserved_gb": torch.cuda.max_memory_reserved()
               / 1e9}
    losses = [h["loss"] for h in hist]
    falls = all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
    bitwise = graph_vs_eager(dyn.fn, params, opt, batch, MOE_LOOP_STEPS,
                             steps=2)
    gc.collect()
    torch.cuda.empty_cache()                  # the eager copies' memory
    timings = step_timings(dyn.fn, params, opt, batch, cfg, totals,
                           MOE_LOOP_STEPS + bitwise["replays"])
    this_ok = (this_ok and falls and bitwise["ok"]
               and capture["graph_captures"] == 1
               and all(timings["kernel_launches_one_step"].get(n, 0) > 0
                       for n in MOE_TRAIN_KERNELS))
    log({"phase": "moe_train", "gpu": gpu,
         "config": "deepseek-moe-16b at full width, %d layers (the dense "
                   "first and %d MoE), B=%d S=%d, TrainStepConfig(lr=1e-3, "
                   "warmup=3, remat), the step one CUDA Graph"
                   % (MOE_TRAIN_LAYERS, MOE_TRAIN_LAYERS - 1, B, S),
         "params": sum(t.numel() for t in _leaves(params)),
         "strategies": dyn.strategies,
         "dbo_vs_sequential": vs_seq, "capture": capture,
         "loop": {"steps": MOE_LOOP_STEPS, "losses": losses,
                  "falls": falls, "loop_s": loop_s,
                  "step_time_s": [h["step_time_s"] for h in hist]},
         "graph_vs_eager": bitwise, **timings,
         "tolerance": dict(MOE_TRAIN_TOL, routes="every differing route on "
                           "a near tie of sequential's router logits",
                           graph_vs_eager="bitwise"),
         "ok": this_ok})
    del dyn, seq1, params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return this_ok


# mamba2-2.7b's depth in ``ssm_train``: at 16 of its 64 layers (0.77 B
# parameters) the graph-against-eager copies of the parameters and the
# AdamW state fit beside the step; at full depth (2.70 B: ~32 GB of
# weights, gradients and state) they would take about as much again
SSM_TRAIN_LAYERS = 16
SSM_TRAIN_SHAPE, SSM_LOOP_STEPS = (2, 2048), 8
# (layers kept in each stack, (B, S)) of each model's GPU-against-CPU
# train cut at full width: mamba2-2.7b 2 layers; zamba2-1.2b one group (6
# Mamba2 layers and the shared block); whisper-tiny 2 encoder and 2
# decoder layers; qwen2-vl-7b 2 layers
TRAIN_CUTS = {"mamba2-2.7b": (2, (2, 512)), "zamba2-1.2b": (6, (1, 256)),
              "whisper-tiny": (2, (2, 256)), "qwen2-vl-7b": (2, (1, 256))}
SSM_GRAD_KERNELS = ("ssd_scan", "ssd_scan_bwd", "rmsnorm", "rmsnorm_bwd")
HYBRID_GRAD_KERNELS = SSM_GRAD_KERNELS + ("flash_attention",
                                          "flash_attention_bwd")


def ssm_train_flops(model, params, B, S):
    """(model FLOPs of one SSM or hybrid train step, matmul params): 6 per
    matmul parameter a token (the linears' weights, the shared block's at
    each of its uses, the tied embedding as the head's matmul; not the
    convolutions' taps, the norms' gains or the scan's per-head
    parameters), plus 3 x ``SSDScanOp.flops_estimate`` per Mamba2 layer
    and 3 x the causal attention's 4 B S^2 H hd / 2 per use of the shared
    block.  Recomputation under remat is not counted."""
    import torch

    from repro_torch.core.module import TensorSpec
    from repro_torch.models.mamba2 import SSDScanOp
    from repro_torch.tree import leaves_with_paths
    cfg = model.cfg
    uses = getattr(model, "n_groups", 0)
    n = 0
    for path, t in leaves_with_paths(params):
        if path[-2:] == ("lin", "w") or path == ("embed", "emb", "w"):
            n += t.numel() * (uses if path[0] == "shared_attn" else 1)
    op = SSDScanOp(cfg, model.mesh)
    scan = op.flops_estimate([TensorSpec((B, S, op.ch_loc),
                                         torch.bfloat16)])
    attn = 4.0 * B * S * S * cfg.n_heads * cfg.hd * 0.5 * uses
    return 6.0 * n * B * S + 3 * (scan * cfg.n_layers + attn), n


def _train_cut(dev, totals, arch):
    """``arch`` at full width cut to ``TRAIN_CUTS[arch]``'s layers (in
    both of whisper's stacks): ``Program.train_step`` on the card
    (kernels) against the same program on the CPU (plain versions), the
    loss and every gradient leaf."""
    from repro_torch.api import compile
    from repro_torch.configs import get_config
    layers, (B, S) = TRAIN_CUTS[arch]
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=layers,
                              enc_layers=min(cfg.enc_layers, layers))
    prog = compile(cfg)
    step = prog.train_step(B, S)
    gpu_params = prog.init_params(SEED, phase="train")
    params = _copy_tree(gpu_params, "cpu")
    batch = model_batch(cfg, B, S, "cpu", SEED, labels=True)
    gpu_batch = {k: v.to(dev) for k, v in batch.items()}
    t0 = time.perf_counter()
    want = step.fn.grads(params, batch)
    cpu_s = time.perf_counter() - t0
    got, counts = counted(totals, lambda: step.fn.grads(gpu_params,
                                                        gpu_batch))
    checks, ok = grads_agree(got, want)
    need = {"ssm": SSM_GRAD_KERNELS,
            "hybrid": HYBRID_GRAD_KERNELS}.get(cfg.family, GRAD_KERNELS)
    ok = ok and all(counts.get(k, 0) > 0 for k in need)
    log({"phase": PREFIX[cfg.family] + "train_cut", "arch": arch,
         "config": f"{arch} at full width, {layers} layers"
                   + (" a stack" if cfg.enc_layers else "")
                   + f", B={B} S={S}, policy dynamic",
         "strategies": step.strategies, "grads": checks,
         "kernel_launches": counts, "cpu_grads_s": cpu_s,
         "tolerance": TRAIN_TOL, "ok": ok})
    del step, params, gpu_params, got, want
    gc.collect()
    return ok


def _ssm_train_model(dev, gpu, totals, arch):
    """``arch`` (mamba2-2.7b cut to ``SSM_TRAIN_LAYERS``, zamba2-1.2b as
    published) at B=2 S=2048 through the graphed ``TrainStep``."""
    import math

    import torch

    from repro_torch.api import compile
    from repro_torch.configs import get_config
    from repro_torch.core.streams import one_stream
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (TrainLoopConfig, TrainStepConfig,
                                   train_loop)
    cfg = get_config(arch)
    if cfg.family == "ssm":
        cfg = dataclasses.replace(cfg, n_layers=SSM_TRAIN_LAYERS)
    B, S = SSM_TRAIN_SHAPE
    tcfg = TrainStepConfig(optimizer=AdamWConfig(lr=LOOP_LR),
                           warmup=LOOP_WARMUP, total_steps=SSM_LOOP_STEPS)
    dyn_prog = compile(cfg, policy="dynamic")
    dyn = dyn_prog.train_step(B, S, cfg=tcfg)
    seq = compile(cfg, policy="sequential").train_step(B, S, cfg=tcfg)
    params = dyn_prog.init_params(SEED, phase="train")
    batch = train_batch(B, S, cfg.vocab, dev)
    want = seq.fn.grads(params, batch)
    got, counts = counted(totals, lambda: dyn.fn.grads(params, batch))
    grads, this_ok = grads_agree(got, want)
    del want
    # the same plans on one stream: the gradients bit for bit
    with one_stream():
        single = dyn.fn.grads(params, batch)
    torch.cuda.synchronize()
    same, differ = _bits_equal(got[0], single[0])
    same = same and all(torch.equal(a, b) for a, b in zip(got[1], single[1]))
    del got, single
    gc.collect()
    torch.cuda.empty_cache()
    strat = dyn.strategies
    mamba = [k for k in strat if k == "layers" or k.startswith("mamba")]
    shared = [k for k in strat if k.startswith("shared_attn@")]
    hybrid = cfg.family == "hybrid"
    need = HYBRID_GRAD_KERNELS + FUSED_PAIR if hybrid else SSM_GRAD_KERNELS
    this_ok = (this_ok and same and bool(mamba)
               and all(strat[k] == "nanoflow" for k in mamba)
               and all(strat[k] == "tokenweave" for k in shared)
               and len(shared) == getattr(dyn_prog.model, "n_groups", 0)
               and all(counts.get(k, 0) > 0 for k in need))
    opt = dyn.init_opt(params)
    stats0 = dict(dyn.fn.stats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, hist = train_loop(
        dyn.fn, params, opt, RepeatedBatch(batch),
        TrainLoopConfig(steps=SSM_LOOP_STEPS, log_every=10 ** 9))
    loop_s = time.perf_counter() - t0
    capture = {**capture_record(dyn.fn, stats0),
               "loop_peak_allocated_gb": torch.cuda.max_memory_allocated()
               / 1e9,
               "loop_peak_reserved_gb": torch.cuda.max_memory_reserved()
               / 1e9}
    losses = [h["loss"] for h in hist]
    falls = all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
    bitwise = graph_vs_eager(dyn.fn, params, opt, batch, SSM_LOOP_STEPS,
                             steps=2)
    gc.collect()
    torch.cuda.empty_cache()                  # the eager copies' memory
    timings = step_timings(dyn.fn, params, opt, batch, cfg, totals,
                           SSM_LOOP_STEPS + bitwise["replays"],
                           flops=ssm_train_flops(dyn_prog.model, params,
                                                 B, S))
    this_ok = (this_ok and falls and bitwise["ok"]
               and capture["graph_captures"] == 1
               and all(timings["kernel_launches_one_step"].get(n, 0) > 0
                       for n in need + ("adamw",)))
    log({"phase": "ssm_train", "arch": arch, "gpu": gpu,
         "config": "%s at full width, %d layers%s, B=%d S=%d, "
                   "TrainStepConfig(lr=1e-3, warmup=3, remat), the step one "
                   "CUDA Graph over per-resource streams"
                   % (arch, cfg.n_layers,
                      " (the shared block used %d times)" % len(shared)
                      if hybrid else "", B, S),
         "params": sum(t.numel() for t in _leaves(params)),
         "strategies": strat,
         "dynamic_vs_sequential": grads, "first_step_launches": counts,
         "streams_vs_one_stream": {"grads_bitwise": same,
                                   "differ": differ[:8]},
         "capture": capture,
         "loop": {"steps": SSM_LOOP_STEPS, "losses": losses,
                  "falls": falls, "loop_s": loop_s,
                  "step_time_s": [h["step_time_s"] for h in hist]},
         "graph_vs_eager": bitwise, **timings,
         "mfu_counts": "6 x matmul params a token (the shared block's at "
                       "each use) + 3 x SSDScanOp.flops_estimate a Mamba2 "
                       "layer + 3 x the shared block's causal attention, "
                       "over 989 TFLOP/s",
         "tolerance": dict(TRAIN_TOL, graph_vs_eager="bitwise",
                           streams_vs_one_stream="bitwise"),
         "ok": this_ok})
    del dyn, seq, dyn_prog, params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return this_ok


def phase_ssm_train(dev, gpu, totals):
    """mamba2-2.7b and zamba2-1.2b train: each at a cut on the card
    against the CPU, then at B=2 S=2048 through the graphed step."""
    ok = True
    for arch in ("mamba2-2.7b", "zamba2-1.2b"):
        ok = _train_cut(dev, totals, arch) and ok
        ok = _ssm_train_model(dev, gpu, totals, arch) and ok
    return ok


# ---------------------------------------------------------------------------
# phases: frontend and examples — the raw-graph path and the user scripts
# ---------------------------------------------------------------------------

FRONTEND_SHAPE = (4, 2048)


def phase_frontend(dev, totals):
    """One chatglm3-6b decoder layer at full width, traced as a raw
    ``Module``: ``compile(layer, example_inputs=...)`` under ``dynamic``
    against ``sequential``, both through ``Program.__call__`` on the same
    params and inputs.  A raw program's context counts rows of the batch
    dim (4 here), not tokens, so ``dynamic`` takes its thresholds in
    those units (``dynamic_policy(split_tokens=4, seq_tokens=2)``) and
    resolves NanoFlow, whose plan splits the layer in two micro-batches.
    The plans must differ, the outputs agree within the transparency
    phase's limit, and the flash attention and RMSNorm kernels launch."""
    import torch

    from repro_torch.api import compile
    from repro_torch.configs import get_config
    from repro_torch.core.module import TensorSpec
    from repro_torch.core.policy import resolve_strategy
    from repro_torch.core.scheduler import ScheduleContext
    from repro_torch.core.strategies.dynamic import dynamic_policy
    from repro_torch.models.base import DenseDecoderLayer
    from repro_torch.models.layers import MeshInfo
    cfg = get_config("chatglm3-6b")
    B, S = FRONTEND_SHAPE
    layer = DenseDecoderLayer(cfg, MeshInfo(), cfg.seq_parallel)
    example = {"x": TensorSpec((B, S, cfg.d_model), torch.bfloat16),
               "positions": TensorSpec((B, S), torch.int32)}
    params = layer.init(SEED, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    inputs = {"x": torch.randn((B, S, cfg.d_model), generator=g,
                               device=dev).to(torch.bfloat16),
              "positions": torch.arange(S, dtype=torch.int32, device=dev)
              .expand(B, S).contiguous()}
    policy = dynamic_policy(split_tokens=B, seq_tokens=2)
    seq = compile(layer, policy="sequential", example_inputs=example)
    dyn = compile(layer, policy=policy, example_inputs=example)
    want = seq(params, inputs)["x"]
    got, counts = counted(totals, lambda: dyn(params, inputs)["x"])
    plans = {"sequential": seq.plan(B), "dynamic": dyn.plan(B)}
    strategy = resolve_strategy(policy, ScheduleContext(
        local_batch=B, global_batch=B, phase="train"), graph=dyn.graph).name
    err = rel_err(got, want)
    finite = bool(torch.isfinite(got.float()).all())
    differ = plans["sequential"].fingerprint() \
        != plans["dynamic"].fingerprint()
    ok = (finite and err < 5e-2 and differ and strategy == "nanoflow"
          and counts.get("flash_attention", 0) > 0
          and counts.get("rmsnorm", 0) > 0)
    log({"phase": "frontend",
         "config": "chatglm3-6b DenseDecoderLayer at full width traced as "
                   "a raw Module, x (%d, %d, %d) bf16" % (B, S, cfg.d_model),
         "graph_nodes": len(dyn.graph.nodes), "dynamic_strategy": strategy,
         "plans": {k: {"steps": len(v.steps), "split_sizes": v.split_sizes,
                       "fingerprint": v.fingerprint()}
                   for k, v in plans.items()},
         "rel_err_vs_sequential": err,
         "max_abs_err_vs_sequential": max_err(got, want), "finite": finite,
         "launches": counts,
         "store": {k: dyn.stats[k] for k in ("misses", "hits", "shares")},
         "call_ms": {"sequential": cuda_ms(lambda: seq(params, inputs),
                                           iters=5),
                     "dynamic": cuda_ms(lambda: dyn(params, inputs),
                                        iters=5)},
         "tolerance": "relative L2 error of x < 5e-2 (the transparency "
                      "phase's limit)", "ok": ok})
    return ok


# (script, arguments, its last line).  The smoke configs' head dim (8) is
# below what the attention kernels take, so on the card the serve and
# train examples run published configs; serve_batched the small one
EXAMPLES = (
    ("torch_quickstart.py", ["--device", "cuda"], "quickstart OK"),
    # tracing, plans, the overlap model and the verifier: all on the host
    ("torch_custom_strategy.py", [], "custom_strategy OK"),
    ("torch_serve_batched.py", ["--device", "cuda", "--arch",
                                "smollm-135m"], "serve_batched OK"),
    ("torch_train_ft.py", ["--device", "cuda", "--steps", "40",
                           "--crash-at", "20"], "train_ft OK"),
)


def phase_examples():
    """Each ``examples/torch_*.py`` in a subprocess of its own, all four at
    once: exit code 0 and its OK line last."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs, runs = [], {}
    try:
        for script, args, _ in EXAMPLES:
            procs.append((time.perf_counter(), subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "examples", script),
                 *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
        for (script, args, want), (t0, p) in zip(EXAMPLES, procs):
            try:
                out, err = p.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
            lines = out.strip().splitlines()
            runs[script] = {"args": args, "returncode": p.returncode,
                            "s": time.perf_counter() - t0,
                            "tail": lines[-4:],
                            "stderr_tail": err.strip().splitlines()[-6:],
                            "ok": p.returncode == 0 and bool(lines)
                            and want in lines[-1]}
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ok = len(runs) == len(EXAMPLES) and all(r["ok"] for r in runs.values())
    log({"phase": "examples", "runs": runs, "ok": ok})
    return ok


# ---------------------------------------------------------------------------
# phase: streams — per-resource CUDA streams against one stream
# ---------------------------------------------------------------------------


def stream_overlap(fn):
    """From one profiled call of ``fn`` (a graph's replay, or a step):
    the device time of the kernels (and device copies) on the streams the
    profiler reports (the four busiest, and the rest summed), the time at
    least one of them runs (``busy_ms``) and the time kernels of two or
    more streams run at once, as ms and as a share of ``busy_ms``.
    Eagerly the streams are the plan's resource streams; inside a CUDA
    Graph they are the ones CUDA runs the graph's branches on."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
              e.get("args", {}).get("stream", -1))
             for e in trace.get("traceEvents", [])
             if e.get("ph") == "X" and e.get("cat") in (
                 "kernel", "gpu_memcpy", "gpu_memset")]
    per: dict = {}
    for a, b, st in spans:
        per[st] = per.get(st, 0.0) + (b - a) / 1e3
    # a graph's branches land on many CUDA streams: the four busiest
    top = sorted(per.values(), reverse=True)
    # sweep over starts and ends (an end before a start at one instant)
    points = sorted([(a, 1, st) for a, _b, st in spans]
                    + [(b, -1, st) for _a, b, st in spans])
    live: dict = {}
    busy = both = 0.0
    last = None
    for t, d, st in points:
        if last is not None:
            n = sum(1 for v in live.values() if v > 0)
            busy += (t - last) if n >= 1 else 0.0
            both += (t - last) if n >= 2 else 0.0
        live[st] = live.get(st, 0) + d
        last = t
    return {"kernels": len(spans), "streams": len(per),
            "kernel_ms_top_streams": top[:4],
            "kernel_ms_other_streams": sum(top[4:]),
            "busy_ms": busy / 1e3, "overlap_ms": both / 1e3,
            "overlap_share": both / busy if busy else 0.0}


def _multi_stream(fwd):
    """Whether any of a Forward's lowered plans uses a side stream."""
    return any(rz.lowered is not None and rz.lowered.streams.side
               for rz in fwd.realizers.values())


def phase_streams(dev, params, gpu, arch="chatglm3-6b"):
    """The served model over per-resource streams against the one-stream
    program of the same lowered plans (``core.streams.one_stream``, the
    comparison only tests and this script reach), on one process, in
    turns: the (4, 2048) prefill group's logits (eager through the
    lowered plans) and 16 greedy tokens of the mix (graphs) bit for bit
    and with the same launches; the prefill group and the steady tier-4
    step, each timed like ``serve``; both graphs' overlap from one
    profiled replay and their pool bytes; then ``dynamic`` against
    ``sequential`` tokens/s on the mix, both over streams."""
    import torch

    from repro_torch.api import compile
    from repro_torch.core.streams import one_stream

    def one(fn):
        with one_stream():
            return fn()

    prog = compile(arch)          # policy: dynamic
    cfg = prog.model.cfg
    step = prog.prefill(*PREFILL_GROUP, s_max=4096)
    batch = prefill_batch(*PREFILL_GROUP, cfg.vocab, dev, SEED + 3)
    (logits, n_streams) = counted({}, lambda: step(params, batch)[
        "logits"].clone())
    (logits1, n_one) = counted({}, lambda: one(lambda: step(params, batch)[
        "logits"].clone()))
    multi = _multi_stream(step.fn)
    logits_equal = bool(torch.equal(logits, logits1))
    del logits, logits1
    # the eager prefill's kernels on the plan's own resource streams
    eager_overlap = stream_overlap(lambda: step(params, batch))
    # the mix: one engine over streams, one whose every capture (warm-up
    # included) is the one-stream program
    engines = {"streams": serve_engine(prog, params, 16),
               "one_stream": one(lambda: serve_engine(prog, params, 16))}
    runs = {k: served(e) if k == "streams" else one(lambda: served(e))
            for k, e in engines.items()}
    tokens = {k: tokens_of(r[0]) for k, r in runs.items()}
    tokens_equal = tokens["streams"] == tokens["one_stream"]
    launches_equal = runs["streams"][2] == runs["one_stream"][2]
    ok = (multi and logits_equal and tokens_equal and launches_equal
          and n_streams == n_one
          and all(len(t) == 16 for t in tokens["streams"]))
    # the prefill group through the idle engines, in turns, twice
    prompts = serve_prompts(prog)
    prefill = {k: [] for k in engines}
    for order in (("streams", "one_stream"), ("one_stream", "streams")):
        for k in order:
            prefill[k].append(prefill_group_ms(engines[k], prompts))
    # the steady tier-4 step, in turns
    for e in engines.values():
        for i, p in enumerate(prompts):
            e.submit(serve_request(100 + i, p, 64))
    steady = steady_pair(engines)
    graphs = {k: {"prefill": e._group_graph("prefill", *PREFILL_GROUP),
                  "decode_tier4": e._graph(4)} for k, e in engines.items()}
    overlap = {k: {g: stream_overlap(step_.replay) for g, step_ in gs.items()}
               for k, gs in graphs.items()}
    pool = {k: {g: step_.nbytes for g, step_ in gs.items()}
            for k, gs in graphs.items()}
    del graphs, runs
    # the paper's comparison: dynamic against sequential, both on
    # streams (the streams engine, its steady requests served out)
    served(engines["streams"])
    seq = compile(arch, policy="sequential")
    mix = {"dynamic": engines["streams"],
           "sequential": serve_engine(seq, params, 16, submit=False)}
    del engines
    gc.collect()
    tps = {k: [] for k in mix}
    for turn, order in enumerate((("dynamic", "sequential"),
                                  ("sequential", "dynamic"))):
        for k in order:
            e = mix[k]
            rids = {1000 * (turn + 1) + i for i in range(len(prompts))}
            for rid, p in zip(sorted(rids), prompts):
                e.submit(serve_request(rid, p, 16))
            reqs, wall, _ = served(e)
            # ``run`` returns every request the engine finished so far
            tps[k].append(sum(len(r.output) for r in reqs
                              if r.rid in rids) / wall)
    del mix, seq
    gc.collect()
    fused = (fused_vs_composition(params, batch, arch)
             if cfg.family == "hybrid" else None)
    torch.cuda.empty_cache()
    log({"phase": PREFIX[cfg.family] + "streams", "arch": arch, "gpu": gpu,
         "strategies": step.strategies, "multi_stream": multi,
         "prefill_logits_equal": logits_equal,
         "prefill_launches_equal": n_streams == n_one,
         "tokens_equal": tokens_equal, "launches_equal": launches_equal,
         "tokens_head": [t[:4] for t in tokens["streams"]],
         "prefill_step_ms": prefill, "steady_decode_step_ms": steady,
         "overlap": overlap, "eager_prefill_overlap": eager_overlap,
         "graph_nbytes": pool, "tokens_per_s": tps,
         "tokenweave_fused_vs_composition": fused, "ok": ok})
    return ok


def fused_vs_composition(params, batch, arch):
    """The hybrid's (4, 2048) prefill forward captured as a graph under
    ``dynamic`` (TokenWeave's fused add+RMSNorm at 16 blocks on the
    shared block) and under ``nanoflow`` (the block's add and RMSNorm as
    two ops), each over streams and over one stream: replay ms, four
    graphs in turns (CUDA events over 3 replays, twice)."""
    import torch

    from repro_torch.api import compile
    from repro_torch.core.capture import GraphStep
    from repro_torch.core.streams import one_stream
    # the forwards stay alive with their graphs: a replay reads what
    # their ops cache on the device (the heads' slot maps)
    graphs, fused, fwds = {}, {}, []
    for policy in ("dynamic", "nanoflow"):
        fwd = compile(arch, policy=policy).prefill(*PREFILL_GROUP).fn
        fwds.append(fwd)
        fused[policy] = sum(1 for rz in fwd.realizers.values()
                            for st in rz.plan.steps if st.kind == "fused")
        for mode in ("streams", "one_stream"):
            ctx = one_stream() if mode == "one_stream" \
                else contextlib.nullcontext()
            with ctx:
                graphs[f"{policy}/{mode}"] = GraphStep(
                    lambda: fwd(params, batch)["logits"],
                    lambda: fwd(params, batch),
                    stream=torch.cuda.Stream())
    ms = {k: [] for k in graphs}
    for order in (list(graphs), list(graphs)[::-1]):
        for k in order:
            ms[k].append(replay_ms(graphs[k], 3))
    out = {"replay_ms": ms, "fused_steps": fused,
           "graph_nbytes": {k: g.nbytes for k, g in graphs.items()}}
    del graphs, fwds
    gc.collect()
    return out


def phase_train_streams(dev):
    """Both train configurations of ``train`` (smollm-135m as published,
    chatglm3-6b cut to 4 layers), each as two graphed steps from copies
    of one state: over per-resource streams and the one-stream program.
    Three steps each, in turns, then params, m, v and metrics bit for
    bit; the step's wall time in turns (CUDA events, windows of 3
    steps); the overlap of one profiled replay; the graphs' pool bytes."""
    import torch

    from repro_torch.api import compile
    from repro_torch.configs import get_config
    from repro_torch.core.streams import one_stream
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainStepConfig
    ok = True
    for name, cfg, shape, tcfg in (
            ("smollm-135m", get_config("smollm-135m"), SMOLLM_SHAPE,
             TrainStepConfig(optimizer=AdamWConfig(lr=LOOP_LR),
                             warmup=LOOP_WARMUP, total_steps=LOOP_STEPS)),
            ("chatglm3-6b 4 layers",
             dataclasses.replace(get_config("chatglm3-6b"), n_layers=4),
             GLM_SHAPE, TrainStepConfig())):
        steps = {k: compile(cfg).train_step(*shape, cfg=tcfg)
                 for k in ("streams", "one_stream")}
        params = compile(cfg).init_params(SEED, phase="train")
        batch = train_batch(*shape, cfg.vocab, dev)
        state = {}
        for k, st in steps.items():
            p = params if k == "streams" else _copy_tree(params)
            state[k] = (p, st.init_opt(p))
        del params

        def run(k, i):
            st, (p, o) = steps[k], state[k]
            if k == "streams":
                return st.fn(p, o, batch, i)[2]
            with one_stream():
                return st.fn(p, o, batch, i)[2]
        metrics = {k: [] for k in steps}
        for i in range(3):
            for k in steps:
                metrics[k].append(_copy_tree(run(k, i)))
        torch.cuda.synchronize()
        bits = {part: _bits_equal(a, b)[0] for part, a, b in (
            ("params", state["streams"][0], state["one_stream"][0]),
            ("opt", state["streams"][1], state["one_stream"][1]))}
        bits["metrics"] = all(_bits_equal(a, b)[0] for a, b in zip(
            metrics["streams"], metrics["one_stream"]))
        multi = _multi_stream(steps["streams"].fn.forward)
        walls = {k: [] for k in steps}
        i = 3
        for order in (("streams", "one_stream"), ("one_stream", "streams")):
            for k in order:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(3):
                    run(k, i)
                    i += 1
                end.record()
                end.synchronize()
                walls[k].append(start.elapsed_time(end) / 3)
        overlap = {k: stream_overlap(lambda: run(k, 100)) for k in steps}
        captures = {k: st.fn.stats["graph_captures"]
                    for k, st in steps.items()}
        this_ok = (multi and all(bits.values())
                   and all(c == 1 for c in captures.values()))
        ok = ok and this_ok
        log({"phase": "train_streams", "config": name,
             "shape": list(shape), "strategies": steps["streams"].strategies,
             "multi_stream": multi, "bitwise_after_3_steps": bits,
             "loss": [float(m["loss"]) for m in metrics["streams"]],
             "step_wall_ms": walls, "overlap": overlap,
             "graph_nbytes": {k: st.fn.stats["graph_nbytes"]
                              for k, st in steps.items()},
             "graph_captures": captures, "ok": this_ok})
        del steps, state, metrics
        gc.collect()
        torch.cuda.empty_cache()
    return ok


# ---------------------------------------------------------------------------
# phase 5 (optional): where the time goes
# ---------------------------------------------------------------------------


def _profile(fn, steps, windows=3, ranges=frozenset()):
    """Wall time per step, device busy share and the top ops of ``steps``
    calls of ``fn`` under ``torch.profiler``, over ``windows`` windows.

    A step (an eager one, or a graph's replay) launches the same kernels
    every time, and the profiler can lose events but never adds one, so
    a window that counts fewer kernels than the largest count lost
    device events (seen on an H100: one window read 100 ms against 131,
    9307 kernels against 9314-9316; two of three replay windows 8942
    against 8974).  Such a window is dropped and reported
    (``windows_dropped``, with every window's ``window_kernels``), not
    averaged in.

    ``ranges``: names of ``record_function`` ranges that ``fn`` opens.
    Each kernel then also goes to the outermost range above the CPU op
    that launched it (``forward_backward`` where none is), and the
    result has each range's device ms, elementwise ms and top kernels
    (``ranges``).  A kernel the profiler tied to no CPU op (the AdamW
    kernel's launch, seen on an H100) goes by its name: to ``adamw`` if
    it is the AdamW kernel, else to ``forward_backward``
    (``attributed_by_name_ms``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    runs = []
    for _ in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ka = prof.key_averages()
        # device time: the kernels themselves (the CPU ops that launched
        # them report the same time again, the ranges their own span)
        kernels = [e for e in ka if e.device_type == DeviceType.CUDA
                   and e.key not in ranges]
        runs.append((sum(e.count for e in kernels), wall, ka, kernels,
                     _range_buckets(prof, kernels, ranges)
                     if ranges else None))
    counts = [r[0] for r in runs]
    full = max(counts)
    kept = [r for r in runs if r[0] == full]
    dropped = [i for i, r in enumerate(runs) if r[0] < full]
    n = len(kept) * steps
    dev_ms = sum(_dev_us(e) for r in kept for e in r[3]) / 1e3
    wall_ms = sum(r[1] for r in kept) * 1e3
    by_dev, by_cpu = {}, {}
    cpu_ops = 0
    for _, _, ka, kernels, _ in kept:
        for e in kernels:
            by_dev[e.key[:60]] = by_dev.get(e.key[:60], 0.0) + _dev_us(e)
        for e in ka:
            if e.device_type == DeviceType.CPU:
                by_cpu[e.key[:60]] = (by_cpu.get(e.key[:60], 0.0)
                                      + e.self_cpu_time_total)
                cpu_ops += e.count if e.key.startswith("aten::") else 0
    top = lambda d, k=8: {name: v / 1e3 / n for name, v in sorted(  # noqa
        d.items(), key=lambda kv: -kv[1])[:k]}
    out = {"steps": steps, "windows": windows,
           "window_kernels": counts, "windows_dropped": dropped,
           "wall_ms_per_step": wall_ms / n,
           "device_ms_per_step": dev_ms / n,
           "device_busy_share": dev_ms / wall_ms,
           "kernel_launches_per_step": full / steps,
           "cpu_ops_per_step": cpu_ops / n,
           "top_device_ms_per_step": top(by_dev),
           "top_cpu_self_ms_per_step": top(by_cpu)}
    if ranges:
        tot = {part: {} for part in ("forward_backward", *sorted(ranges))}
        loose = {}
        for *_, (buckets, lo) in kept:
            for part, b in buckets.items():
                for k, us in b.items():
                    tot[part][k] = tot[part].get(k, 0.0) + us
            for k, us in lo.items():
                loose[k] = loose.get(k, 0.0) + us / 1e3 / n
        out["ranges"] = {part: {
            "device_ms": sum(t.values()) / 1e3 / n,
            "elementwise_ms": sum(us for k, us in t.items()
                                  if _elementwise(k)) / 1e3 / n,
            "top_kernels_ms": top(t, 6)} for part, t in tot.items()}
        out["attributed_by_name_ms"] = loose
    return out


def _range_buckets(prof, kernels, ranges):
    """(kernel device us by range and name, the us given by name alone)
    for one profiled window: see ``_profile``."""
    from torch.autograd import DeviceType
    buckets = {"forward_backward": {}, **{r: {} for r in ranges}}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        where, up = "forward_backward", e
        while up is not None:
            if up.name in ranges:
                where = up.name
            up = up.cpu_parent
        for k in e.kernels:
            b = buckets[where]
            b[k.name[:60]] = b.get(k.name[:60], 0.0) + k.duration
    whole, loose = {}, {}
    for e in kernels:
        whole[e.key[:60]] = whole.get(e.key[:60], 0.0) + _dev_us(e)
    for k, us in whole.items():
        left = us - sum(b.get(k, 0.0) for b in buckets.values())
        if left > 1e-3 * us:
            part = "adamw" if "adamw_kernel" in k else "forward_backward"
            buckets[part][k] = buckets[part].get(k, 0.0) + left
            loose[k] = loose.get(k, 0.0) + left
    return buckets, loose


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
# phases: minitron-8b and deepseek-coder-33b served; whisper-tiny
# (encoder-decoder) and qwen2-vl-7b (M-RoPE) through prefill, decode and
# the graphed train step
# ---------------------------------------------------------------------------

DENSE_CONFIGS = ("minitron-8b", "deepseek-coder-33b")
GEN_STEPS = 16            # greedy decode steps after a prefill
# (B, S) of the prefill and s_max of the decode: whisper's 30-second
# encoder length (its states zero-padded to s_max, as the JAX package's
# static shapes have it); qwen2-vl-7b's 1 x 32 x 32 image grid, then text
ENC_SHAPE, ENC_SMAX = (4, 1500), 2048
VLM_SHAPE, VLM_SMAX = (4, 2048), 4096
ENC_TRAIN_SHAPE = (8, 1500)
VLM_TRAIN_LAYERS, VLM_TRAIN_SHAPE = 4, (2, 2048)
NEW_LOOP_STEPS = 8


def serve_mix(dev, params, gpu, totals, arch):
    """The serve mix (prompts of ``SERVE_LENS``, one (4, 2048) prefill
    group, then tier-4 decode of ``GEN_STEPS`` greedy tokens) on
    ``compile(arch)``'s engine with graphs, then on the interpreter's
    (``lowered=False``, its launches not the main path's): the same
    tokens and launch counts.  The graphs' engine goes before the
    interpreter's is built: ``phase_serve`` holds two engines at once,
    and their caches and pools pass what deepseek-coder-33b's 66.7 GB of
    weights leave of the card."""
    import torch

    from repro_torch.api import compile
    prog = compile(arch)          # policy: dynamic
    cfg = prog.model.cfg
    free_gb = torch.cuda.mem_get_info(dev)[0] / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = serve_engine(prog, params, GEN_STEPS)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    done, counts = counted(totals, engine.run)
    wall = time.perf_counter() - t0
    reqs = sorted(done, key=lambda r: r.rid)
    st = engine.stats
    ok = (len(reqs) == 4 and all(r.ok and len(r.output) == GEN_STEPS
                                 for r in reqs)
          and all(0 <= t < cfg.vocab for r in reqs for t in r.output)
          and all(counts.get(k, 0) > 0 for k in SERVE_KERNELS[cfg.family])
          and st["graph_replays"] == st["decode_steps"] > 0
          and st["prefill_graph_replays"] == st["prefill_steps"] > 0)
    prefill_replay = replay_ms(
        engine._group_graph("prefill", *PREFILL_GROUP), 3)
    decode_replay = replay_ms(engine._graph(4), 10)
    peak = torch.cuda.max_memory_allocated() / 1e9
    peak_reserved = torch.cuda.max_memory_reserved() / 1e9
    graphs = {"wall_s": wall,
              "tokens_per_s": sum(len(r.output) for r in reqs) / wall,
              "ttft_s": [r.first_token_s - r.submitted_s for r in reqs],
              "warmup_s": warm_s, "capture_s": st["capture_s"],
              "prefill_capture_s": st["prefill_capture_s"],
              "prefill_graph_replay_ms": prefill_replay,
              "decode_graph_replay_ms": decode_replay,
              "outputs_head": [r.output[:4] for r in reqs],
              "launches": counts}
    tokens = [r.output for r in reqs]
    del engine, done, reqs
    gc.collect()
    torch.cuda.empty_cache()
    i_engine = serve_engine(prog, params, GEN_STEPS, lowered=False)
    t0 = time.perf_counter()
    i_done, i_counts = counted({}, i_engine.run)
    i_wall = time.perf_counter() - t0
    i_tokens = [r.output for r in sorted(i_done, key=lambda r: r.rid)]
    ok = ok and i_tokens == tokens and i_counts == counts
    del i_engine, i_done
    gc.collect()
    torch.cuda.empty_cache()
    log({"phase": "dense_configs", "arch": arch, "gpu": gpu,
         "config": f"{arch} as published: {cfg.n_layers} layers, d_model "
                   f"{cfg.d_model}, {cfg.n_heads} q / {cfg.n_kv} kv heads, "
                   f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, tp=1",
         "layers": cfg.n_layers, "free_gb_after_params": free_gb,
         "prompt_lens": list(SERVE_LENS), "new_tokens": GEN_STEPS,
         **graphs,
         "interpreter": {"wall_s": i_wall,
                         "tokens_per_s": sum(map(len, i_tokens)) / i_wall,
                         "launches": i_counts},
         "tokens_equal": i_tokens == tokens,
         "launches_equal": i_counts == counts,
         "strategies": {f"{ph}:{b}x{s}" + ("" if lo else ":interpreted"):
                        fwd.strategies
                        for (ph, b, s, lo, _g), fwd
                        in prog._serve_steps.items()},
         "peak_mem_gb": peak, "peak_reserved_gb": peak_reserved, "ok": ok})
    return ok


def phase_dense_configs(dev, gpu, totals):
    """minitron-8b, then deepseek-coder-33b (alone on the card: every
    earlier model's params and graph pools freed first), each as
    published: a 2-layer cut on the GPU against the CPU, then the serve
    mix with graphs against the interpreter."""
    import torch
    ok = True
    for arch in DENSE_CONFIGS:
        ok = phase_reference(dev, totals, arch) and ok
        gc.collect()
        torch.cuda.empty_cache()
        params = init_params(arch)
        ok = serve_mix(dev, params, gpu, totals, arch) and ok
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return ok


def generate(prog, params, batch, s_max, mode, totals=None, dec=None):
    """A prefill of ``batch`` through ``prog``, then ``GEN_STEPS`` greedy
    decode steps of its rows at one tier (the prefill's K/V copied into
    caches of ``s_max`` positions; whisper's encoder states zero-padded
    to ``s_max``, M-RoPE's three position streams continuing from the
    prefill's last).  ``mode``: ``"graphs"`` (the prefill and each decode
    step one CUDA Graph, ``GraphStep``, the step's argmax and its
    advance of ids, positions and lengths inside the graph; the
    replays' launches go to ``totals``), ``"eager"`` (the same lowered
    steps op by op) or ``"interpreter"`` (``lowered=False``).  Returns
    ((B, GEN_STEPS + 1) tokens on the CPU, timings).  ``dec``: the
    (program, params) of the decode steps where they are not ``prog``'s
    (grok's FSDP layouts differ between prefill and decode)."""
    import torch

    from repro_torch.core.capture import GraphStep
    from repro_torch.models.base import build_forward
    model, cfg = prog.model, prog.model.cfg
    B, S = batch["ids"].shape
    dev = batch["ids"].device
    if mode == "interpreter":
        def built(phase, q, seq):
            segs, _ = model.build_segments(phase, B, q, s_max=s_max)
            return build_forward(segs, prog.policy,
                                 prog._context(phase, B, seq),
                                 lowered=False,
                                 op_config=model.op_closure_config())
        pre, dec = built("prefill", S, S), built("decode", 1, s_max)
    else:
        dprog, dparams = dec or (prog, params)
        pre = prog.prefill(B, S, s_max=s_max).fn
        dfn = dprog.decode_tiers(B, s_max, tiers=(B,))[B].fn

        def dec(_, batch):
            return dfn(dparams, batch)
    rec = {}
    graphs = mode == "graphs"
    stream = torch.cuda.Stream(dev) if graphs else None

    def prefill():
        return pre(params, batch)
    if graphs:
        pg = GraphStep(prefill, prefill, stream=stream)
        out, rec["prefill_launches"] = counted(totals, pg.replay)
        rec["prefill_capture_s"] = pg.capture_s
    else:
        out = prefill()
    kv = "decoder" if cfg.family == "encdec" else "layers"
    k = out[f"{kv}.k"]
    caches = {}
    for name in ("k", "v"):
        c = torch.zeros(k.shape[:2] + (s_max,) + k.shape[3:], dtype=k.dtype,
                        device=dev)
        c[:, :, :S] = out[f"{kv}.{name}"]
        caches[f"{name}_cache"] = c
    first = out["logits"][:, -1].argmax(-1).to(torch.int32)
    state = {"ids": first[:, None].clone(),
             "positions": (batch["positions"][..., -1:] + 1).contiguous(),
             "cache_len": torch.full((B,), S, dtype=torch.int32, device=dev),
             **caches}
    if cfg.family == "encdec":
        enc = torch.zeros((B, s_max, cfg.d_model), dtype=torch.bfloat16,
                          device=dev)
        enc[:, :S] = out["enc"]
        state["enc"] = enc
    tokens = [first.clone()]
    del out
    if graphs:
        rec["prefill_graph_ms"] = replay_ms(pg, 3)
        del pg

    def step(st):
        o = dec(params, dict(st))
        nxt = o["logits"][:, -1].argmax(-1).to(torch.int32)
        st["ids"].copy_(nxt[:, None])
        st["positions"].add_(1)
        st["cache_len"].add_(1)
        return nxt
    if graphs:
        dg = GraphStep(lambda: step(state),
                       lambda: step({k: t.clone() for k, t in state.items()}),
                       stream=stream)
        rec["decode_capture_s"] = dg.capture_s
        run = dg.replay
    else:
        def run():
            return step(state)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def loop():
        start.record()
        for _ in range(GEN_STEPS):
            tokens.append(run().clone())
        end.record()
    _, rec["decode_launches"] = counted(totals if graphs else {}, loop)
    loop_ms = start.elapsed_time(end)
    rec["decode_step_ms"] = loop_ms / GEN_STEPS
    rec["decode_tokens_per_s"] = B * GEN_STEPS / (loop_ms / 1e3)
    if graphs:
        rec["decode_graph_ms"] = replay_ms(dg, 10)
        del dg
    return torch.stack(tokens, 1).cpu(), rec


def generate_phase(dev, gpu, totals, arch, shape, s_max, params=None):
    """``generate`` with graphs, eagerly and with the interpreter on the
    same params and inputs: the tokens of the three equal, in vocab, and
    the family's kernels launched by the graphs."""
    import torch

    from repro_torch.api import compile
    prog = compile(arch)          # policy: dynamic
    cfg = prog.model.cfg
    params = prog.init_params(SEED) if params is None else params
    B, S = shape
    batch = model_batch(cfg, B, S, dev, SEED + 3)
    torch.cuda.reset_peak_memory_stats()
    runs, tokens = {}, {}
    for mode in ("graphs", "eager", "interpreter"):
        launches = {}
        tokens[mode], runs[mode] = generate(prog, params, batch, s_max, mode,
                                            launches)
        if mode == "graphs":
            for k, v in launches.items():
                totals[k] = totals.get(k, 0) + v
            runs[mode]["launches"] = launches
            peak = torch.cuda.max_memory_allocated() / 1e9
    want = tokens["graphs"]
    same = {m: bool(torch.equal(t, want)) for m, t in tokens.items()}
    steps = prog.prefill(B, S, s_max=s_max).strategies
    fused = "tokenweave" in steps.values()
    launched = runs["graphs"]["launches"]
    ok = (all(same.values()) and bool(((want >= 0) & (want < cfg.vocab))
                                      .all())
          and all(launched.get(k, 0) > 0 for k in SERVE_KERNELS[cfg.family])
          and (launched.get("fused_add_rmsnorm", 0) > 0) == fused)
    log({"phase": PREFIX[cfg.family].rstrip("_"), "arch": arch, "gpu": gpu,
         "config": f"{arch} as published: {cfg.n_layers} layers"
                   + (f" (+ {cfg.enc_layers} encoder layers)"
                      if cfg.enc_layers else "")
                   + f", d_model {cfg.d_model}, {cfg.n_heads} q / "
                   f"{cfg.n_kv} kv heads of {cfg.hd}; prefill B={B} S={S}, "
                   f"{GEN_STEPS} greedy decode steps at tier {B}, "
                   f"s_max {s_max}",
         "prefill_strategies": steps, "tokens_head": want[:, :6].tolist(),
         "tokens_equal": same, **runs, "peak_mem_gb": peak, "ok": ok})
    return ok


def phase_encdec(dev, gpu, totals):
    """whisper-tiny as published: the whole model on the card against
    the CPU (B=2 S=256), then prefill and greedy decode (``generate``)."""
    ok = phase_reference(dev, totals, "whisper-tiny", B=2, S=256,
                         n_layers=4)
    return generate_phase(dev, gpu, totals, "whisper-tiny", ENC_SHAPE,
                          ENC_SMAX) and ok


def phase_vlm(dev, gpu, totals):
    """qwen2-vl-7b: a 2-layer cut on the card against the CPU, then as
    published: prefill and greedy decode (``generate``), and ``dynamic``
    and ``nanoflow`` against ``sequential`` at prefill."""
    import torch

    from repro_torch.api import compile
    from repro_torch.configs import get_config
    arch = "qwen2-vl-7b"
    ok = phase_reference(dev, totals, arch)
    gc.collect()
    params = init_params(arch)
    ok = generate_phase(dev, gpu, totals, arch, VLM_SHAPE, VLM_SMAX,
                        params) and ok
    cfg = get_config(arch)
    B, S = VLM_SHAPE
    batch = model_batch(cfg, B, S, dev, SEED + 1)
    want = compile(cfg, policy="sequential").prefill(B, S)(
        params, batch)["logits"]
    runs = {}
    for policy in ("dynamic", "nanoflow"):
        step = compile(cfg, policy=policy).prefill(B, S)
        got, counts = counted(totals, lambda: step(params, batch)["logits"])
        err = rel_err(got, want)
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        finite = bool(torch.isfinite(got.float()).all())
        this = (finite and err < 5e-2 and agree >= 0.5
                and step.strategies["layers"] == "nanoflow")
        runs[policy] = {"strategies": step.strategies,
                        "rel_err_vs_sequential": err,
                        "argmax_agree": agree, "finite": finite,
                        "launches": counts, "ok": this}
        ok = ok and this
    log({"phase": "vlm_transparency", "shape": f"B={B} S={S}",
         "runs": runs, "tolerance": "relative L2 error of the logits < "
         "5e-2 and the same argmax on at least half the rows",
         "ok": all(r["ok"] for r in runs.values())})
    del params, want
    gc.collect()
    torch.cuda.empty_cache()
    return ok


def whisper_train_flops(cfg, params, B, S):
    """(model FLOPs of one whisper train step, matmul params): 6 per
    parameter a token — the encoder's against its B S frames, the
    decoder's and the tied embedding's (the head's matmul) against the B
    S tokens — plus 3 x 4 B S^2 H hd a layer for the encoder's
    self-attention and the decoder's cross-attention (full: S_enc = S,
    neither causal) and half that for the decoder's causal
    self-attention.  Recomputation under remat is not counted."""
    from repro_torch.tree import leaves
    n = sum(t.numel() for t in leaves(params))
    full = 4.0 * B * S * S * cfg.n_heads * cfg.hd
    return 6.0 * n * B * S + 3 * full * (cfg.enc_layers
                                         + 1.5 * cfg.n_layers), n


def _train_model(dev, gpu, totals, cfg, shape, flops_fn):
    """``cfg`` at ``shape`` through the graphed ``TrainStep`` under
    ``dynamic`` with remat: its gradients against ``sequential``'s, the
    loss falling over ``NEW_LOOP_STEPS`` steps on one repeated batch, two
    replays against ``fn.eager`` bit for bit, then the step's timings."""
    import math

    import torch

    from repro_torch.api import compile
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (TrainLoopConfig, TrainStepConfig,
                                   train_loop)
    B, S = shape
    tcfg = TrainStepConfig(optimizer=AdamWConfig(lr=LOOP_LR),
                           warmup=LOOP_WARMUP, total_steps=NEW_LOOP_STEPS)
    dyn_prog = compile(cfg, policy="dynamic")
    dyn = dyn_prog.train_step(B, S, cfg=tcfg)
    seq = compile(cfg, policy="sequential").train_step(B, S, cfg=tcfg)
    params = dyn_prog.init_params(SEED, phase="train")
    batch = model_batch(cfg, B, S, dev, SEED, labels=True)
    want = seq.fn.grads(params, batch)
    got, counts = counted(totals, lambda: dyn.fn.grads(params, batch))
    grads, ok = grads_agree(got, want)
    del got, want
    gc.collect()
    torch.cuda.empty_cache()
    strat = dyn.strategies
    fused = "tokenweave" in strat.values()
    need = GRAD_KERNELS + (FUSED_PAIR if fused else ())
    ok = (ok and all(counts.get(k, 0) > 0 for k in need)
          and all((counts.get(k, 0) > 0) == fused for k in FUSED_PAIR))
    opt = dyn.init_opt(params)
    stats0 = dict(dyn.fn.stats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, hist = train_loop(
        dyn.fn, params, opt, RepeatedBatch(batch),
        TrainLoopConfig(steps=NEW_LOOP_STEPS, log_every=10 ** 9))
    loop_s = time.perf_counter() - t0
    capture = {**capture_record(dyn.fn, stats0),
               "loop_peak_allocated_gb": torch.cuda.max_memory_allocated()
               / 1e9,
               "loop_peak_reserved_gb": torch.cuda.max_memory_reserved()
               / 1e9}
    losses = [h["loss"] for h in hist]
    falls = all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
    bitwise = graph_vs_eager(dyn.fn, params, opt, batch, NEW_LOOP_STEPS,
                             steps=2)
    gc.collect()
    torch.cuda.empty_cache()
    timings = step_timings(dyn.fn, params, opt, batch, cfg, totals,
                           NEW_LOOP_STEPS + bitwise["replays"],
                           flops=flops_fn(cfg, params, B, S))
    ok = (ok and falls and bitwise["ok"] and capture["graph_captures"] == 1
          and all(timings["kernel_launches_one_step"].get(n, 0) > 0
                  for n in need + ("adamw",)))
    log({"phase": PREFIX[cfg.family] + "train", "arch": cfg.name,
         "gpu": gpu,
         "config": f"{cfg.name} at full width, {cfg.n_layers} layers"
                   + (f" (+ {cfg.enc_layers} encoder layers)"
                      if cfg.enc_layers else "")
                   + f", B={B} S={S}, TrainStepConfig(lr=1e-3, warmup=3, "
                   "remat), the step one CUDA Graph over per-resource "
                   "streams",
         "params": sum(t.numel() for t in _leaves(params)),
         "strategies": strat, "dynamic_vs_sequential": grads,
         "first_step_launches": counts, "capture": capture,
         "loop": {"steps": NEW_LOOP_STEPS, "losses": losses,
                  "falls": falls, "loop_s": loop_s},
         "graph_vs_eager": bitwise, **timings,
         "tolerance": dict(TRAIN_TOL, graph_vs_eager="bitwise"), "ok": ok})
    del dyn, seq, dyn_prog, params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return ok


def phase_encdec_train(dev, gpu, totals):
    """whisper-tiny: a cut against the CPU, then as published at B=8
    S=1500 through the graphed step (TokenWeave under ``dynamic``)."""
    from repro_torch.configs import get_config
    ok = _train_cut(dev, totals, "whisper-tiny")
    return _train_model(dev, gpu, totals, get_config("whisper-tiny"),
                            ENC_TRAIN_SHAPE, whisper_train_flops) and ok


def phase_vlm_train(dev, gpu, totals):
    """qwen2-vl-7b: a cut against the CPU, then at full width cut to
    ``VLM_TRAIN_LAYERS`` layers, B=2 S=2048, with the M-RoPE inputs
    (NanoFlow under ``dynamic``)."""
    from repro_torch.configs import get_config
    ok = _train_cut(dev, totals, "qwen2-vl-7b")
    cfg = dataclasses.replace(get_config("qwen2-vl-7b"),
                              n_layers=VLM_TRAIN_LAYERS)
    return _train_model(
        dev, gpu, totals, cfg, VLM_TRAIN_SHAPE,
        lambda c, p, B, S: train_flops(c, p, B, S)) and ok


def run_new(phases, dev, gpu, totals):
    """The phases of the four configurations, each model's params freed
    before the next's."""
    import torch
    ok = True
    for name, phase in (("dense_configs", phase_dense_configs),
                        ("encdec", phase_encdec), ("vlm", phase_vlm),
                        ("encdec_train", phase_encdec_train),
                        ("vlm_train", phase_vlm_train)):
        if name in phases:
            t0 = time.perf_counter()
            ok = phase(dev, gpu, totals) and ok
            log({"phase": f"{name}_done", "s": time.perf_counter() - t0})
            gc.collect()
            torch.cuda.empty_cache()
    return ok


# ---------------------------------------------------------------------------
# phase: mesh — launch/serve.py, a one-rank mesh over NCCL, grok-1-314b
# ---------------------------------------------------------------------------

MESH_PREFILL = (2, 2048)
MESH_DECODE = (4, 4096)       # (max_batch, s_max) of decode_tiers
GROK_LAYERS = 2               # of 64: ~23 GB of bf16 weights
GROK_PREFILL = (1, 2048)
GROK_S_MAX = 4096


def phase_cli(dev, gpu, totals):
    """``launch.serve.main`` with the JAX package's default flags, then
    ``compile(arch).serve`` on the same params and prompts."""
    import io

    import numpy as np
    import torch

    from repro_torch.api import compile
    from repro_torch.launch import serve as cli
    from repro_torch.serve import Request, ServeConfig
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        done, counts = counted(totals, lambda: cli.main([]))
    lines = out.getvalue().splitlines()
    served = next(ln for ln in lines if ln.startswith("served "))
    prog = compile("chatglm3-6b")
    params = prog.init_params(0)
    eng = prog.serve(params, ServeConfig(max_batch=4, s_max=128,
                                         prefill_buckets=(16, 32, 64),
                                         prefill_batch=4))
    for r in sorted(done, key=lambda r: r.rid):
        eng.submit(Request(r.rid, np.asarray(r.prompt), max_new_tokens=16))
    want = {r.rid: list(r.output) for r in eng.run()}
    eng.shutdown()
    prog.close()
    got = {r.rid: list(r.output) for r in done}
    ttft = [r.first_token_s - r.submitted_s for r in done]
    toks = sum(len(v) for v in got.values())
    ok = (got == want and len(got) == 8 and toks == 8 * 16
          and all(counts.get(k, 0) > 0 for k in SERVE_KERNELS["dense"]))
    log({"phase": "mesh_cli", "gpu": gpu,
         "command": "python -m repro_torch.launch.serve (defaults: "
                    "chatglm3-6b, 8 requests, 16 tokens, max_batch 4, "
                    "s_max 128, dynamic)",
         "printed": [served.split("  stats=")[0]] + lines[-2:],
         "tokens": toks, "tokens_equal_compile_serve": got == want,
         "ttft_ms": {"p50": float(np.percentile(ttft, 50)) * 1e3,
                     "p99": float(np.percentile(ttft, 99)) * 1e3},
         "launches": counts, "ok": ok})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return ok


def _bits_equal_trees(a: dict, b: dict) -> dict:
    import torch
    return {k: bool(torch.equal(a[k], b[k])) for k in a}


def graphs_ms_in_turns(fns: dict, reps: int) -> dict:
    """Each step of ``fns`` (name -> no-argument callable) captured as a
    CUDA Graph and replayed ``reps`` times, in turns: a, b, b, a."""
    import torch

    from repro_torch.core.capture import GraphStep
    stream = torch.cuda.Stream()
    graphs = {k: GraphStep(fn, fn, stream=stream) for k, fn in fns.items()}
    a, b = list(fns)
    out: dict = {}
    for name in (a, b, b, a):
        out.setdefault(name, []).append(replay_ms(graphs[name], reps))
    del graphs
    return out


def phase_mesh_one_rank(dev, gpu, totals, mesh):
    """chatglm3-6b on a one-rank mesh against no mesh: prefill logits and
    every decode tier's outputs bit for bit; the prefill and the tier-4
    step each captured and replayed in turns."""
    import torch

    from repro_torch.api import compile
    plain = compile("chatglm3-6b")
    meshed = compile("chatglm3-6b", mesh=mesh)
    params = plain.init_params(SEED)
    B, S = MESH_PREFILL
    batch = prefill_batch(B, S, plain.model.cfg.vocab, dev, SEED + 11)
    steps = {"no_mesh": plain.prefill(B, S).fn,
             "mesh": meshed.prefill(B, S).fn}
    outs, launches = {}, {}
    for name, fn in steps.items():
        outs[name], launches[f"prefill_{name}"] = counted(
            totals, lambda: fn(params, batch))
    pre_equal = _bits_equal_trees(outs["mesh"], outs["no_mesh"])
    del outs
    pre_ms = graphs_ms_in_turns(
        {k: (lambda fn=fn: fn(params, batch)) for k, fn in steps.items()}, 5)
    max_batch, s_max = MESH_DECODE
    tiers = {"no_mesh": plain.decode_tiers(max_batch, s_max),
             "mesh": meshed.decode_tiers(max_batch, s_max)}
    cfg = plain.model.cfg
    dec_equal, dec_ms = {}, {}
    for tier in sorted(tiers["mesh"]):
        g = torch.Generator(device=dev).manual_seed(SEED + tier)
        inputs = {"ids": torch.randint(0, cfg.vocab, (tier, 1), device=dev,
                                       generator=g, dtype=torch.int32),
                  "positions": torch.full((tier, 1), s_max // 4,
                                          device=dev, dtype=torch.int32),
                  "cache_len": torch.full((tier,), s_max // 4, device=dev,
                                          dtype=torch.int32)}
        for k, spec in plain.model.decode_cache_env(tier, s_max).items():
            inputs[k] = (torch.randn(spec.shape, device=dev, generator=g)
                         * 0.5).to(spec.dtype)
        res = {}
        for name in ("no_mesh", "mesh"):
            fn = tiers[name][tier].fn
            res[name], n = counted(totals, lambda: fn(
                params, {k: v.clone() for k, v in inputs.items()}))
            acc = launches.setdefault(f"decode_{name}", {})
            for k, v in n.items():
                acc[k] = acc.get(k, 0) + v
        dec_equal[tier] = _bits_equal_trees(res["mesh"], res["no_mesh"])
        if tier == max_batch:
            dec_ms = graphs_ms_in_turns(
                {k: (lambda fn=t[tier].fn: fn(params, inputs))
                 for k, t in tiers.items()}, 20)
        del res, inputs
    # the mesh steps went through the kernels: flash attention and
    # RMSNorm in the prefill, decode attention and RMSNorm in the tiers
    mesh_launched = all(
        launches["prefill_mesh"].get(k, 0)
        + launches["decode_mesh"].get(k, 0) > 0
        for k in SERVE_KERNELS["dense"])
    ok = (all(pre_equal.values()) and mesh_launched
          and all(all(v.values()) for v in dec_equal.values()))
    log({"phase": "mesh_one_rank", "gpu": gpu,
         "mesh": {"shape": [1, 1], "axes": ["data", "model"],
                  "backend": torch.distributed.get_backend()},
         "prefill": f"chatglm3-6b B={B} S={S}",
         "prefill_bits_equal": pre_equal,
         "prefill_graph_ms_in_turns": pre_ms,
         "decode": f"chatglm3-6b decode_tiers({max_batch}, {s_max})",
         "decode_bits_equal": dec_equal,
         "decode_tier4_graph_ms_in_turns": dec_ms,
         "launches": launches, "mesh_launched_dense_kernels": mesh_launched,
         "ok": ok})
    del tiers
    gc.collect()
    torch.cuda.empty_cache()
    ok = phase_dryrun(gpu, lambda: steps["mesh"](params, batch),
                      {"prefill": min(pre_ms["mesh"]),
                       "decode": min(dec_ms["mesh"])},
                      (params, batch)) and ok
    del params, steps
    gc.collect()
    torch.cuda.empty_cache()
    return ok


DRYRUN_PEAK_TOL = 0.2        # the eager prefill's growth against the count


def phase_dryrun(dev_gpu, prefill_eager, graph_ms, args_on_card):
    """``launch/dryrun.py`` held to the card: the one-rank mesh's
    chatglm3-6b prefill (2, 2048) graph and tier-4 decode step counted on
    ``meta`` at mesh {data: 1, model: 1}; each replay's measured time at
    or above the dry run's ``t_bound`` (a count over the card's peak is a
    wrong count; ``t_bound`` charges the full products, the masked half
    of causal attention included, so the share at the unmasked FLOPs is
    printed beside it); the prefill's ``argument_bytes`` equal to the
    bytes of the params and batch on the card (``args_on_card``); an
    eager prefill's growth of allocated memory (its peak less what was
    allocated before it) within ``DRYRUN_PEAK_TOL`` of the count's output
    and temporaries (``peak_per_device - argument_bytes``), over the
    plans' own streams and over one stream, each against its own count;
    then
    grok-1-314b x decode_32k x pod16x16 at full depth on ``meta``, whose
    size is a finding (it fails only if not ok or a term is not finite and
    positive)."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import streams
    from repro_torch.launch import dryrun
    from repro_torch.roofline.count import storages
    cfg = get_config("chatglm3-6b")
    one = dryrun.ShapeMesh((1, 1), ("data", "model"))
    shapes = {"prefill": ShapeConfig(f"prefill_{MESH_PREFILL[0]}x"
                                     f"{MESH_PREFILL[1]}", MESH_PREFILL[1],
                                     MESH_PREFILL[0], "prefill"),
              "decode": ShapeConfig(f"decode_{MESH_DECODE[0]}x"
                                    f"{MESH_DECODE[1]}", MESH_DECODE[1],
                                    MESH_DECODE[0], "decode")}
    steps, ok = {}, True
    for kind, shape in shapes.items():
        run = dryrun.count_step(cfg, shape, one)
        rec = dryrun.record(cfg, shape, one, run, mesh_name="1x1")
        rl = rec["roofline"]
        bound_ms = rl["t_bound"] * 1e3
        unmasked = rec["cost"]["flops"] - run["masked_flops"]
        bound_unmasked_ms = max(unmasked / PEAK_BF16_FLOPS,
                                rl["t_memory"], rl["t_collective"]) * 1e3
        step_ok = rec["status"] == "ok" and graph_ms[kind] >= bound_ms
        ok = ok and step_ok
        steps[kind] = {
            "shape": shape.name, "t_bound_ms": bound_ms,
            "graph_replay_ms": graph_ms[kind],
            "roofline_share": bound_ms / graph_ms[kind],
            "bottleneck": rl["bottleneck"],
            "t_compute_ms": rl["t_compute"] * 1e3,
            "t_memory_ms": rl["t_memory"] * 1e3,
            "t_collective_ms": rl["t_collective"] * 1e3,
            "flops": rec["cost"]["flops"],
            "flops_unmasked": unmasked,
            "t_bound_unmasked_ms": bound_unmasked_ms,
            "roofline_share_unmasked": bound_unmasked_ms / graph_ms[kind],
            "bytes": rec["cost"]["bytes accessed"],
            "memory": rec["memory"], "build_s": rec["build_s"],
            "counted_s": rec["lower_s"], "ok": step_ok}
    # what the prefill is given, and what one eager run (lowered, no
    # graph) allocates on top of it, over the plans' own streams (which
    # hold what the side streams touch until the join) and over one
    mem = steps["prefill"]["memory"]
    on_card = sum(storages(args_on_card).values())
    args_ok = on_card == mem["argument_bytes"]
    with streams.one_stream():
        mem_one = dryrun.count_step(cfg, shapes["prefill"], one)["memory"]
    growth = {}
    for name, m, ctx in (("streams", mem, contextlib.nullcontext),
                         ("one_stream", mem_one, streams.one_stream)):
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with ctx():
            out = prefill_eager()
        torch.cuda.synchronize()
        grew = torch.cuda.max_memory_allocated() - before
        del out
        want = m["peak_per_device"] - m["argument_bytes"]
        growth[name] = {"allocated_before": before,
                        "peak_less_before": grew,
                        "dry_run_output_plus_temp": want,
                        "ratio": grew / want,
                        "ok": abs(grew / want - 1.0) <= DRYRUN_PEAK_TOL}
    peak_ok = all(g["ok"] for g in growth.values())
    # a cell that exists only at scale
    grok = dryrun.run_cell("grok-1-314b", "decode_32k", verbose=False)
    terms = {k: grok.get("roofline", {}).get(k) for k in
             ("t_compute", "t_memory", "t_collective", "t_bound")}
    grok_ok = grok["status"] == "ok" and all(
        v is not None and math.isfinite(v) and v > 0 for v in terms.values())
    ok = ok and args_ok and peak_ok and grok_ok
    log({"phase": "dryrun", "gpu": dev_gpu,
         "figures": "hw.py: 989e12 FLOP/s bf16, 3.35e12 B/s HBM, 18 x 25e9 "
                    "B/s NVLink",
         "one_rank_mesh": steps,
         "prefill_arguments": {
             "params_and_batch_on_card": on_card,
             "dry_run_argument_bytes": mem["argument_bytes"],
             "ok": args_ok},
         "eager_prefill_growth": {**growth, "tolerance": DRYRUN_PEAK_TOL,
                                  "ok": peak_ok},
         "grok_decode_32k_pod16x16": {
             "status": grok["status"], "memory": grok.get("memory"),
             "cost": grok.get("cost"),
             "collective_payload_bytes": grok.get(
                 "collective_payload_bytes"),
             "terms_s": terms, "bottleneck": grok.get(
                 "roofline", {}).get("bottleneck"),
             "build_s": grok.get("build_s"), "counted_s": grok.get("lower_s"),
             "ok": grok_ok},
         "ok": ok})
    return ok


def gather_streams(step) -> dict:
    """Stream index -> the FSDP weight gathers (``WeightGatherOp``,
    ``ParamGatherOp``) a built step's lowered plans put on it."""
    out: dict = {}
    for rz in step.fn.fwd.realizers.values():
        lp = rz.lowered
        for ins, st in zip(lp.instrs, lp.streams.streams):
            if ins.label.endswith("gather"):
                out[st] = out.get(st, 0) + 1
    return out


def _modes(model, phase):
    layer = model.layer_stacks(phase)[0][1]
    return {"ShardedLinear": layer.qkv.proj.mode,
            "ExpertFFN": layer.moe.experts.mode}


def phase_grok(dev, gpu, totals, mesh):
    """grok-1-314b at full width cut to ``GROK_LAYERS`` layers, served
    with FSDP on the one-rank mesh against the same cut without FSDP."""
    import torch

    from repro_torch.api import compile
    from repro_torch.configs import get_config
    from repro_torch.core.streams import RESOURCE_STREAM
    from repro_torch.launch.sharding import fsdp_gathered_tree
    from repro_torch.models.layers import MeshInfo
    cfg = dataclasses.replace(get_config("grok-1-314b"), n_layers=GROK_LAYERS)
    plain = compile(cfg)
    t0 = time.perf_counter()
    params = plain.init_params(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    pre_prog = compile(cfg, mesh=mesh, mesh_info=MeshInfo(fsdp=True))
    dec_prog = compile(cfg, mesh=mesh,
                       mesh_info=MeshInfo(fsdp=True, fsdp_resident=True))
    modes = {"prefill": _modes(pre_prog.model, "prefill"),
             "decode": _modes(dec_prog.model, "decode")}
    print(json.dumps({"phase": "mesh_grok_modes", **modes}), flush=True)
    pre_params = fsdp_gathered_tree(params, pre_prog.model)
    B, S = GROK_PREFILL
    batch = prefill_batch(B, S, cfg.vocab, dev, SEED + 13)
    pre_step = pre_prog.prefill(B, S)
    gathers = gather_streams(pre_step)
    logits = {
        "fsdp": pre_step.fn(pre_params, batch)["logits"],
        "no_fsdp": plain.prefill(B, S).fn(params, batch)["logits"]}
    logits_equal = bool(torch.equal(logits["fsdp"], logits["no_fsdp"]))
    finite = bool(torch.isfinite(logits["fsdp"].float()).all())
    del logits, pre_step
    torch.cuda.reset_peak_memory_stats()
    launches = {}
    tokens, rec = generate(pre_prog, pre_params, batch, GROK_S_MAX,
                           "graphs", launches, dec=(dec_prog, params))
    for k, v in launches.items():
        totals[k] = totals.get(k, 0) + v
    peak = torch.cuda.max_memory_allocated() / 1e9
    want, rec_plain = generate(plain, params, batch, GROK_S_MAX, "eager")
    same = bool(torch.equal(tokens, want))
    ok = (logits_equal and same and finite
          and bool(((tokens >= 0) & (tokens < cfg.vocab)).all())
          and modes == {"prefill": {"ShardedLinear": "gather",
                                    "ExpertFFN": "zero3"},
                        "decode": {"ShardedLinear": "resident",
                                   "ExpertFFN": "ff_sharded"}}
          and all(launches.get(k, 0) > 0 for k in SERVE_KERNELS["moe"])
          # two linears and three expert weights a layer, all on the
          # network stream
          and gathers == {RESOURCE_STREAM["network"]: 5})
    log({"phase": "mesh_grok", "gpu": gpu,
         "config": f"grok-1-314b at full width cut to {GROK_LAYERS} of 64 "
                   f"layers: d_model {cfg.d_model}, {cfg.n_heads} q / "
                   f"{cfg.n_kv} kv heads of {cfg.hd}, {cfg.moe.n_experts} "
                   f"experts of {cfg.moe.d_ff_expert} top-"
                   f"{cfg.moe.top_k}, vocab {cfg.vocab}; prefill B={B} "
                   f"S={S}, {GEN_STEPS} greedy decode steps, s_max "
                   f"{GROK_S_MAX}",
         "params_gb": gb, "init_s": init_s, "modes": modes,
         "prefill_gathers_by_stream": gathers,
         "prefill_logits_equal_no_fsdp": logits_equal,
         "tokens_equal_no_fsdp": same, "tokens_head": tokens[:, :6].tolist(),
         "graphs": rec, "eager_no_fsdp": rec_plain,
         "prefill_tokens_per_s": B * S / (rec["prefill_graph_ms"] / 1e3),
         "peak_mem_gb": peak, "launches": launches, "ok": ok})
    del params, pre_params
    gc.collect()
    torch.cuda.empty_cache()
    return ok


def phase_mesh(dev, gpu, totals):
    """The CLI, then the one-rank NCCL mesh's two checks; the group is
    destroyed at the end."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh, unbind_mesh
    ok = phase_cli(dev, gpu, totals)
    mesh = make_mesh((1, 1), ("data", "model"))
    try:
        ok = phase_mesh_one_rank(dev, gpu, totals, mesh) and ok
        gc.collect()
        torch.cuda.empty_cache()
        ok = phase_grok(dev, gpu, totals, mesh) and ok
    finally:
        unbind_mesh(mesh)
        dist.destroy_process_group()
    return ok


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
                 "sampling", "spec", "autotune", "streams"}:
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
        if "streams" in phases:
            ok = phase_streams(dev, params, gpu) and ok
    return ok


def run_moe(phases, dev, gpu, totals):
    import torch
    ok = True
    if "moe_reference" in phases:
        ok = phase_reference(dev, totals, "deepseek-moe-16b") and ok
    if phases & {"moe_transparency", "moe_serve", "moe_profile", "spec",
                 "autotune", "streams"}:
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
        if "streams" in phases:
            ok = phase_streams(dev, params, gpu, "deepseek-moe-16b") and ok
        del params        # the served model goes before the trained cut
        gc.collect()
        torch.cuda.empty_cache()
    if "moe_train" in phases:
        ok = phase_moe_train(dev, gpu, totals) and ok
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
    if phases & {"ssm_transparency", "ssm_serve", "ssm_profile", "streams"}:
        for arch in ("mamba2-2.7b", "zamba2-1.2b"):
            params = init_params(arch)
            if "ssm_transparency" in phases:
                ok = phase_ssm_transparency(dev, params, totals, arch) and ok
            if "ssm_profile" in phases:
                phase_profile(dev, params, arch)
            if "ssm_serve" in phases:
                ok = phase_serve(dev, params, gpu, totals, arch) and ok
            if "streams" in phases:
                ok = phase_streams(dev, params, gpu, arch) and ok
            del params        # each model's weights go before the next's
            gc.collect()
            torch.cuda.empty_cache()
    if "ssm_train" in phases:
        ok = phase_ssm_train(dev, gpu, totals) and ok
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="kernels,frontend,examples,"
                    "reference,transparency,serve,lifecycle,paged,sampling,"
                    "spec,autotune,moe_reference,moe_transparency,moe_serve,"
                    "moe_train,ssm_reference,ssm_transparency,ssm_serve,"
                    "ssm_train,dense_configs,encdec,vlm,encdec_train,"
                    "vlm_train,mesh,train,streams")
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
    if "frontend" in phases:
        ok = phase_frontend(dev, totals) and ok
    if "examples" in phases:
        ok = phase_examples() and ok
    gc.collect()
    torch.cuda.empty_cache()
    ok = run_dense(phases, dev, gpu, totals) and ok
    gc.collect()          # the chatglm3-6b params go before the MoE's
    torch.cuda.empty_cache()
    ok = run_moe(phases, dev, gpu, totals) and ok
    gc.collect()          # the MoE params go before the SSM models'
    torch.cuda.empty_cache()
    ok = run_ssm(phases, dev, gpu, totals) and ok
    gc.collect()          # the SSM models go before the new configurations
    torch.cuda.empty_cache()
    ok = run_new(phases, dev, gpu, totals) and ok
    gc.collect()          # the new configurations go before grok-1-314b
    torch.cuda.empty_cache()
    if "mesh" in phases:
        ok = phase_mesh(dev, gpu, totals) and ok
        gc.collect()
        torch.cuda.empty_cache()
    if "train" in phases:
        ok = phase_train(dev, totals) and ok
    if "streams" in phases:
        ok = phase_train_streams(dev) and ok
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
