"""Elastic restore + failure handling (the port of
``src/repro/ft/elastic.py``).

Checkpoints store whole (host) tensors, so restoring onto another device
is a copy: ``elastic_restore`` loads the tree and moves it to
``device``.  Combined with the seekable data pipeline, a job can restart
with the same sample order.

``FailureSimulator`` injects the failure modes the train loop must
survive (used by tests and ``chip_smoke.py``):
  * ``crash``     — raises mid-step (restart from the last checkpoint)
  * ``straggler`` — delays the step past the deadline

It is a thin specialization of the shared chaos injector
(``repro_torch.serve.faults.FaultInjector``), so serve and train exercise
one deterministic fault mechanism with one ``injected`` event log.
"""
from __future__ import annotations

import time

from ..serve.faults import FaultInjector
from ..tree import tree_map
from .checkpoint import restore_latest


def elastic_restore(directory: str, example_tree, device=None,
                    process_index: int = 0):
    """Load the latest checkpoint, on ``device`` if given (else where the
    example tree's leaves live).  Returns (step, tree, data_state) or
    None."""
    out = restore_latest(directory, example_tree, process_index)
    if out is None:
        return None
    step, tree, data_state = out
    if device is not None:
        tree = tree_map(lambda t: t.to(device), tree)
    return step, tree, data_state


class FailureSimulator(FaultInjector):
    """Train-loop view of the shared injector: ``maybe_fail(step)`` is
    the single site the loop consults (a step either crashes once, or
    straggles once)."""

    def __init__(self, crash_steps=(), straggle_steps=(),
                 straggle_s: float = 0.5, seed: int = 0):
        super().__init__(slow_s=straggle_s, seed=seed)
        self.crash_steps = set(crash_steps)
        self.straggle_steps = set(straggle_steps)
        self.straggle_s = straggle_s

    def maybe_fail(self, step: int):
        if step in self.crash_steps:
            self.crash_steps.discard(step)     # fail once, then recover
            self.injected.append(("crash", step))
            raise RuntimeError(f"simulated node failure at step {step}")
        if step in self.straggle_steps:
            self.straggle_steps.discard(step)
            self.injected.append(("straggler", step))
            time.sleep(self.straggle_s)
