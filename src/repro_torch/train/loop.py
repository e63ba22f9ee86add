"""Fault-tolerant training loop (the port of ``src/repro/train/loop.py``).

Host-side responsibilities: data cursor, checkpoint cadence (async),
straggler deadline, crash-restart (restores params/opt/data cursor from
the latest atomic checkpoint), metrics log.  The step itself is built by
``train/step.py`` and passed in — the loop never touches model internals.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from ..ft.checkpoint import CheckpointManager
from ..ft.elastic import FailureSimulator
from ..tree import leaves


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    step_deadline_s: float = 0.0       # 0 = no straggler deadline
    max_retries: int = 2


def _copy_into(live, restored):
    """Write ``restored``'s leaves into ``live``'s tensors, in place (the
    restore already held the two trees to one leaf count)."""
    with torch.no_grad():
        for d, s in zip(leaves(live), leaves(restored)):
            d.copy_(s)


def train_loop(train_step: Callable, params, opt_state, pipeline,
               cfg: TrainLoopConfig,
               failure_sim: Optional[FailureSimulator] = None,
               to_device: Optional[Callable] = None,
               log: Optional[Callable] = None):
    """Run ``cfg.steps`` optimizer steps.  Returns (params, opt, history),
    ``history`` one dict of float metrics a completed step (with ``step``
    and ``step_time_s``, the host's time of the step including its
    metrics' read back).

    Crash-restart contract: on any step exception the loop restores the
    last checkpoint (params, opt, data cursor) and retries from its step;
    after ``max_retries`` consecutive failures it re-raises.  A restore
    (here or at the start, from ``ckpt_dir``'s latest checkpoint) copies
    the saved values into the tensors passed in, leaf by leaf, so their
    storage stays where it was: a train step captured as a CUDA Graph
    over those tensors replays on, with no second capture.  The values,
    and so the losses, are the reference loop's.
    """
    mgr = CheckpointManager(cfg.ckpt_dir) if cfg.ckpt_dir else None
    history = []
    start = 0
    if mgr is not None:
        restored = mgr.restore({"params": params, "opt": opt_state})
        if restored is not None:
            start, tree, data_state = restored
            _copy_into({"params": params, "opt": opt_state}, tree)
            if data_state:
                pipeline.load_state_dict(data_state)
            if log:
                log(f"restored checkpoint at step {start}")
    pipeline.seek(start)
    it = iter(pipeline)
    step = start
    retries = 0
    first_step = True       # the first step pays the build, not a straggler
    while step < cfg.steps:
        batch = next(it)
        if to_device:
            batch = to_device(batch)
        t0 = time.perf_counter()
        try:
            if failure_sim:
                failure_sim.maybe_fail(step)
            params, opt_state, metrics = train_step(
                params, opt_state, batch, step)
            metrics = {k: float(v) for k, v in metrics.items()}
        except Exception:
            retries += 1
            if retries > cfg.max_retries or mgr is None:
                raise
            restored = mgr.restore({"params": params, "opt": opt_state})
            if restored is not None:
                step, tree, data_state = restored
                _copy_into({"params": params, "opt": opt_state}, tree)
                if data_state:
                    pipeline.load_state_dict(data_state)
            pipeline.seek(step)
            it = iter(pipeline)
            if log:
                log(f"step failed; restarted from checkpoint at {step}")
            continue
        dt = time.perf_counter() - t0
        if cfg.step_deadline_s and dt > cfg.step_deadline_s \
                and not first_step:
            if log:
                log(f"straggler: step {step} took {dt:.3f}s "
                    f"(deadline {cfg.step_deadline_s:.3f}s)")
            metrics["straggler"] = 1.0
        first_step = False
        retries = 0
        metrics.update(step=step, step_time_s=dt)
        history.append(metrics)
        if log and step % cfg.log_every == 0:
            log(f"step {step}: loss={metrics['loss']:.4f} "
                f"({dt*1e3:.0f} ms)")
        step += 1
        if mgr is not None and step % cfg.ckpt_every == 0:
            mgr.save_async(step, {"params": params, "opt": opt_state},
                           data_state=pipeline.state_dict())
    if mgr is not None:
        mgr.save(cfg.steps, {"params": params, "opt": opt_state},
                 data_state=pipeline.state_dict())
    return params, opt_state, history
