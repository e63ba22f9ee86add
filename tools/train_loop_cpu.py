#!/usr/bin/env python3
"""The loss-falls loop of ``chip_smoke.py``'s train phase, on the CPU.

Runs the port's plain versions through the same loop the card runs on
smollm-135m as published: ``train_loop`` over one ``SyntheticBackend``
batch repeated every step, ``TrainStepConfig(lr=1e-3, warmup=3,
total_steps=30)`` under ``dynamic``, here on smollm-135m at full width
cut to ``--layers`` layers.  Prints each step's loss and, last, a JSON
line with the losses, the first one and the mean of the last 5: what
``chip_smoke.LOOP_MARGIN`` is taken from.  At the default 2 layers, B=8
S=2048 it takes ~40 s a step on 6 CPU threads and ~4 GB.

  PYTHONPATH=src python tools/train_loop_cpu.py [--layers 2] [--batch 8]
      [--seq 2048] [--steps 30] [--threads 6]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--threads", type=int, default=6)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.api import compile
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticBackend
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (TrainLoopConfig, TrainStepConfig,
                                   train_loop)
    torch.set_num_threads(args.threads)
    cfg = dataclasses.replace(get_config("smollm-135m"),
                              n_layers=args.layers)
    prog = compile(cfg, policy="dynamic", device="cpu")
    B, S = args.batch, args.seq
    step = prog.train_step(B, S, cfg=TrainStepConfig(
        optimizer=AdamWConfig(lr=1e-3), warmup=3, total_steps=args.steps))
    print(step.strategies, flush=True)
    params = prog.init_params(0, device="cpu", phase="train")
    b = SyntheticBackend(cfg.vocab).batch(DataConfig(seq_len=S,
                                                     global_batch=B), 0)
    batch = {"ids": torch.from_numpy(b["ids"]),
             "labels": torch.from_numpy(b["labels"]),
             "positions": torch.arange(S, dtype=torch.int32).expand(B, S)}

    class Repeated:
        step = 0

        def seek(self, s):
            self.step = s

        def state_dict(self):
            return {"step": self.step}

        def load_state_dict(self, st):
            self.seek(st["step"])

        def __iter__(self):
            return self

        def __next__(self):
            self.step += 1
            return batch

    t0 = time.perf_counter()
    _, _, hist = train_loop(
        step.fn, params, step.init_opt(params), Repeated(),
        TrainLoopConfig(steps=args.steps, log_every=1),
        log=lambda m: print(m, f"{time.perf_counter() - t0:.0f}s",
                            flush=True))
    losses = [h["loss"] for h in hist]
    print(json.dumps({"losses": losses, "first": losses[0],
                      "last5": sum(losses[-5:]) / 5}))


if __name__ == "__main__":
    main()
