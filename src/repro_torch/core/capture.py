"""CUDA Graph capture and replay of a whole step — the paper's CUDA-graph
mode (§3.3.2) on PyTorch.

``GraphStep(fn, warm, stream=...)`` captures ``fn()`` once as one
``torch.cuda.CUDAGraph`` and ``replay()`` re-runs it.  A graph bakes in
every address it touches, so ``fn`` must read and write only buffers
whose storage never moves (the caller's fixed inputs, the params, the
caches); its return value is the graph's output, a tensor the graph
rewrites in place on every replay.

Capturing runs nothing on the device, but the first eager call of a
step does one-time host work that may not happen under capture: it
builds the kernel library, sets kernels' shared-memory attributes, and
creates the workspaces and maps that the kernel wrappers cache per
device and stream.  ``warm()`` is that first call.  It runs once, on the
capture stream, before the capture, and must run the same step on
throwaway copies of the state: a step that advances a recurrent state or
writes a KV slot must not run twice for one token.  Or, with
``warm_runs_step=True``, ``warm()`` is the step itself, run for real on
the live state (the train step's first call): the capture after it runs
nothing, so the step still runs once, and no copy of the state is made.

A lowered plan on the card runs over per-resource streams
(``core/streams.py``): its side streams fork from the current stream
when the plan is called and join back before it returns.  Called inside
the capture, they fork from the capture stream, so their work joins the
capture and is joined back into it before ``fn`` returns; the warm-up,
on the same capture stream, runs the plans on the same side streams
(one fixed object per device), so the workspaces the kernel wrappers
cache per stream exist before the capture, which may not make them.

The kernel wrappers count their launches in ``kernels.LAUNCHES`` when
they are called, which under capture is when the graph records them.
``GraphStep`` takes that count back out of ``LAUNCHES`` after the capture
and adds it again on every replay, so the counts follow the steps that
ran; the warm-up's launches, on throwaway copies, are taken back out
too (they stay counted where the warm-up ran the step for real).

Graphs given one ``pool`` (``torch.cuda.graph_pool_handle()``) share
it: a capture reuses what earlier captures freed, so the pool holds the
largest capture plus the graphs' outputs, not the sum of all captures.
That is safe while their replays run in series on one stream (a graph's
side-stream work is ordered inside it, between its fork and its join)
and each caller reads a replay's output before it replays another graph
of the pool (a later replay may reuse the output's memory for
intermediates).

Nothing here falls back to eager execution: a capture or a replay that
fails raises.
"""
from __future__ import annotations

import gc
import time
from collections import Counter
from typing import Any, Callable, Optional

import torch

from ..kernels import LAUNCHES

class Staged:
    """A fixed device buffer of ``n`` values fed from two pinned host
    buffers in turns, for a graph's inputs: two steps may be in flight,
    and a host buffer is rewritten only once the copy that last read it
    has run (its event)."""

    def __init__(self, n: int, device: torch.device,
                 dtype: torch.dtype = torch.int32):
        cuda = device.type == "cuda"
        self.dev = torch.zeros((n,), dtype=dtype, device=device)
        self._host = [torch.zeros((n,), dtype=dtype, pin_memory=cuda)
                      for _ in range(2)]
        self._ev = [torch.cuda.Event() if cuda else None for _ in range(2)]
        self._i = 0

    def put(self, fill, n: int):
        """``fill(a)`` writes the first ``n`` values into a host buffer
        (numpy), which is then copied into ``dev[:n]``."""
        host, ev = self._host[self._i], self._ev[self._i]
        self._i ^= 1
        if ev is not None:
            ev.synchronize()
        fill(host.numpy()[:n])
        self.dev[:n].copy_(host[:n], non_blocking=ev is not None)
        if ev is not None:
            ev.record()


class GraphStep:
    """``fn()`` captured as one CUDA Graph on ``stream`` into ``pool``
    (None: a pool of its own), after ``warm()`` ran there once.
    ``capture_s`` is the time of warm-up and capture; ``nbytes`` the
    device memory the capture took (the growth of the allocator's
    reserved bytes across it: 0 where the pool already held enough)."""

    def __init__(self, fn: Callable[[], Any], warm: Callable[[], Any], *,
                 stream: torch.cuda.Stream, pool: Optional[tuple] = None,
                 warm_runs_step: bool = False):
        t0 = time.perf_counter()
        dev = stream.device
        caller = torch.cuda.current_stream(dev)
        stream.wait_stream(caller)
        before = Counter(LAUNCHES)
        with torch.cuda.stream(stream):
            warm()
        warmed = Counter(LAUNCHES)
        # what entering ``torch.cuda.graph`` does (synchronize, collect,
        # empty the cache), done first so that it does not count below
        torch.cuda.synchronize(dev)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_stats(dev).get(
            "reserved_bytes.all.current", 0)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream):
            self.output = fn()
        self.launches = Counter(LAUNCHES) - warmed
        LAUNCHES.clear()              # the capture ran nothing: replays do
        LAUNCHES.update(warmed if warm_runs_step else before)
        self.nbytes = max(0, torch.cuda.memory_stats(dev).get(
            "reserved_bytes.all.current", 0) - reserved)
        caller.wait_stream(stream)
        self.capture_s = time.perf_counter() - t0

    def replay(self):
        """Re-run the captured step on the current stream; returns the
        graph's output tensor (rewritten in place)."""
        self.graph.replay()
        LAUNCHES.update(self.launches)
        return self.output
