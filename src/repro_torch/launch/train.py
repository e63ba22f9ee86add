"""Single-GPU training launcher (the port of ``src/repro/launch/train.py``
without a mesh):

  python -m repro_torch.launch.train --arch smollm-135m --steps 200 \\
      --batch 8 --seq 2048 --strategy dynamic --ckpt-dir /tmp/ckpt

Trains on synthetic tokens (``SyntheticBackend``) on the GPU, or on the
CPU with ``--device cpu`` (with ``--smoke`` for a reduced same-family
config).  ``--crash-at K`` injects a failure at step K, which the loop
survives by restoring the last checkpoint (``--ckpt-dir``).
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import api
from ..data import DataConfig, SyntheticBackend, TokenPipeline
from ..ft.elastic import FailureSimulator
from ..optim import AdamWConfig
from ..train import TrainLoopConfig, TrainStepConfig, train_loop
from ..tree import leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--strategy", default="dynamic")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--quantized-opt", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--crash-at", type=int, default=-1,
                    help="inject a simulated failure at this step")
    args = ap.parse_args(argv)

    program = api.compile(args.arch, policy=args.strategy,
                          smoke=args.smoke, device=args.device)
    cfg = program.model.cfg
    tcfg = TrainStepConfig(
        optimizer=AdamWConfig(lr=args.lr, quantized=args.quantized_opt),
        remat=args.remat, compress_grads=args.grad_compress,
        warmup=max(args.steps // 20, 1), total_steps=args.steps)
    step = program.train_step(args.batch, args.seq, cfg=tcfg)
    params = program.init_params(args.seed, phase="train")
    opt = step.init_opt(params)
    dev = leaves(params)[0].device

    n_params = sum(p.numel() for p in leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"strategy={args.strategy} ({step.strategies}) device={dev}")

    pipe = TokenPipeline(SyntheticBackend(cfg.vocab),
                         DataConfig(seq_len=args.seq,
                                    global_batch=args.batch, seed=args.seed))
    pos = torch.arange(args.seq, dtype=torch.int32, device=dev).expand(
        args.batch, args.seq)
    if cfg.rope == "mrope":       # the three streams equal: text positions
        pos = pos.expand(3, args.batch, args.seq)
    pos = pos.contiguous()
    # the stub frontends' inputs: no patch or frame embeddings
    extra = {name: torch.zeros((args.batch, args.seq, cfg.d_model),
                               dtype=torch.bfloat16, device=dev)
             for name, family in (("vis", "vlm"), ("frames", "encdec"))
             if cfg.family == family}

    def to_device(b):
        return {"ids": torch.from_numpy(b["ids"]).to(dev),
                "labels": torch.from_numpy(b["labels"]).to(dev),
                "positions": pos, **extra}

    sim = (FailureSimulator(crash_steps=(args.crash_at,))
           if args.crash_at >= 0 else None)
    t0 = time.perf_counter()
    params, opt, hist = train_loop(
        step.fn, params, opt, pipe,
        TrainLoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                        ckpt_every=args.ckpt_every, log_every=10),
        failure_sim=sim, to_device=to_device, log=print)
    dt = time.perf_counter() - t0
    toks = args.steps * args.batch * args.seq
    if hist:
        print(f"done: {args.steps} steps in {dt:.1f}s "
              f"({toks/dt:.0f} tok/s), final loss "
              f"{hist[-1]['loss']:.4f} (first {hist[0]['loss']:.4f})")
    return hist


if __name__ == "__main__":
    main()
