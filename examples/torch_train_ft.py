"""Fault-tolerant training driver on the PyTorch port: a ~135M-class
architecture, a synthetic data pipeline, async checkpoints, a simulated
node crash mid-run, exact resume, and gradient compression — the
training substrate exercised end to end.

On the GPU the train step runs as one CUDA Graph, captured at its first
call and replayed every later step; a restore copies the checkpoint into
the same tensors, so the graph replays on with no second capture.  The
CPU runs the smoke config; on the GPU the published one runs, since the
smoke head dim (8) is below the 64 or 128 the attention kernels take.

Run:  PYTHONPATH=src python examples/torch_train_ft.py --device cpu
      PYTHONPATH=src python examples/torch_train_ft.py      # on the GPU
"""
import argparse
import tempfile
import time

import numpy as np
import torch

import repro_torch.api
from repro_torch.data import DataConfig, SyntheticBackend, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.ft.elastic import FailureSimulator
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainLoopConfig, TrainStepConfig, train_loop
from repro_torch.tree import leaves


# the stream's token ids: the first DATA_VOCAB of the model's, so that a
# published vocabulary (49152 for smollm-135m) sees each id often enough
# in a short run to learn the pattern
DATA_VOCAB = 1024


class PatternBackend(SyntheticBackend):
    """Learnable synthetic stream: next token = (id + 7) mod vocab with a
    small amount of noise — loss can actually fall."""

    def batch(self, dcfg, step):
        b = super().batch(dcfg, step)
        ids = b["ids"]
        labels = (ids + 7) % self.vocab
        flip = (ids % 17) == 0
        labels = np.where(flip, ids, labels)
        return {"ids": ids, "labels": labels.astype(np.int32)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--crash-at", type=int, default=60)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    smoke = dev.type != "cuda"      # the kernels refuse the smoke head dim

    tcfg = TrainStepConfig(
        optimizer=AdamWConfig(lr=1e-3, quantized=True),
        remat=False, compress_grads=True,
        warmup=10, total_steps=args.steps)
    # the whole integration: arch + policy in, a trainable Program out
    program = repro_torch.api.compile(args.arch, policy="dynamic",
                                      smoke=smoke, device=dev)
    cfg = program.model.cfg
    step = program.train_step(args.batch, args.seq, cfg=tcfg)
    params = program.init_params(0, phase="train")
    opt = step.init_opt(params)
    n = sum(p.numel() for p in leaves(params))
    print(f"training {cfg.name} on {dev}: {n/1e6:.2f}M params, "
          f"int8 AdamW second moment, int8-compressed DP grads")

    pipe = TokenPipeline(PatternBackend(min(cfg.vocab, DATA_VOCAB)),
                         DataConfig(seq_len=args.seq,
                                    global_batch=args.batch))
    positions = torch.arange(args.seq, dtype=torch.int32, device=dev) \
        .expand(args.batch, args.seq).contiguous()

    def to_dev(b):
        return {"ids": torch.from_numpy(b["ids"]).to(dev),
                "labels": torch.from_numpy(b["labels"]).to(dev),
                "positions": positions}

    # a checkpoint before the crash, so that it restores one
    ckpt_every = max(1, min(25, args.crash_at // 2))
    with tempfile.TemporaryDirectory() as ckpt_dir:
        sim = FailureSimulator(crash_steps=(args.crash_at,))
        t0 = time.perf_counter()
        params, opt, hist = train_loop(
            step.fn, params, opt, pipe,
            TrainLoopConfig(steps=args.steps, ckpt_dir=ckpt_dir,
                            ckpt_every=ckpt_every, log_every=20),
            failure_sim=sim, to_device=to_dev, log=print)
        dt = time.perf_counter() - t0
    losses = [h["loss"] for h in hist]
    print(f"\n{args.steps} steps in {dt:.1f}s "
          f"({args.steps*args.batch*args.seq/dt:.0f} tok/s)")
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"injected failures: {sim.injected}")
    if dev.type == "cuda":
        print(f"train step graph: {step.fn.stats}")
    assert losses[-1] < losses[0]
    assert sim.injected == [("crash", args.crash_at)]
    print("train_ft OK (crashed, restored, converged)")


if __name__ == "__main__":
    main()
