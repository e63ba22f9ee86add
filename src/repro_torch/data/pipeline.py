"""Tokenized data pipeline: host-sharded, seekable, double-buffered (the
port's own copy of ``src/repro/data/pipeline.py``, which is numpy-only;
batches are numpy arrays, which the caller moves to its device).

Design for 1000+ nodes:
  * every host reads only its own shard of the sample space, derived from
    (step, host_index) — no coordination traffic;
  * ``state_dict()/load_state_dict()`` capture the exact cursor so a
    checkpoint restart resumes on the *next* sample (exactly-once);
  * a background prefetch thread hides storage latency behind the step.

Backends: SyntheticBackend (deterministic per-step PRNG tokens — used by
the examples/benchmarks) and MemmapBackend (flat token file, the
production path).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_index: int = 0
    seed: int = 0
    prefetch: int = 2

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0, \
            (self.global_batch, self.n_hosts)
        return self.global_batch // self.n_hosts


class SyntheticBackend:
    """Deterministic synthetic tokens: batch(step, host) is a pure function
    — trivially seekable and identical across restarts."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def batch(self, cfg: DataConfig, step: int) -> dict:
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4093 + cfg.host_index)
        B, S = cfg.host_batch, cfg.seq_len
        ids = rng.integers(0, self.vocab, (B, S + 1), dtype=np.int32)
        return {"ids": ids[:, :-1], "labels": ids[:, 1:]}


class MemmapBackend:
    """Flat int32 token file; sample i = tokens[i*(S+1):(i+1)*(S+1)].
    Host h reads samples (step*GB + h*HB + [0, HB)) mod n_samples."""

    def __init__(self, path: str, seq_len: int):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.stride = seq_len + 1
        self.n_samples = len(self.tokens) // self.stride

    def batch(self, cfg: DataConfig, step: int) -> dict:
        B = cfg.host_batch
        base = step * cfg.global_batch + cfg.host_index * B
        rows = [(base + i) % self.n_samples for i in range(B)]
        buf = np.stack([
            self.tokens[r * self.stride:(r + 1) * self.stride]
            for r in rows])
        return {"ids": buf[:, :-1].astype(np.int32),
                "labels": buf[:, 1:].astype(np.int32)}


class TokenPipeline:
    """Seekable iterator with background prefetch."""

    def __init__(self, backend, cfg: DataConfig, start_step: int = 0):
        self.backend = backend
        self.cfg = cfg
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=max(cfg.prefetch, 1))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- checkpointable cursor ------------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state_dict(self, st: dict):
        self.seek(int(st["step"]))

    def seek(self, step: int):
        self._shutdown()
        self.step = step

    # -- iteration -------------------------------------------------------------
    def _producer(self, from_step: int):
        s = from_step
        while not self._stop.is_set():
            try:
                self._q.put((s, self.backend.batch(self.cfg, s)), timeout=0.2)
                s += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._producer, args=(self.step,), daemon=True)
            self._thread.start()
        s, batch = self._q.get()
        assert s == self.step, (s, self.step)
        self.step += 1
        return batch

    def _shutdown(self):
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=2.0)
            self._thread = None
            while not self._q.empty():
                self._q.get_nowait()

    def __del__(self):
        try:
            self._shutdown()
        except Exception:
            pass
