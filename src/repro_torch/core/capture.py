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
writes a KV slot must not run twice for one token.

The kernel wrappers count their launches in ``kernels.LAUNCHES`` when
they are called, which under capture is when the graph records them.
``GraphStep`` takes that count back out of ``LAUNCHES`` after the capture
and adds it again on every replay, so the counts follow the steps that
ran; the warm-up's launches, on throwaway copies, are taken back out
too.

Graphs given one ``pool`` (``torch.cuda.graph_pool_handle()``) share
it: a capture reuses what earlier captures freed, so the pool holds the
largest capture plus the graphs' outputs, not the sum of all captures.
That is safe while their replays run in series on one stream and each
caller reads a replay's output before it replays another graph of the
pool (a later replay may reuse the output's memory for intermediates).

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

class GraphStep:
    """``fn()`` captured as one CUDA Graph on ``stream`` into ``pool``
    (None: a pool of its own), after ``warm()`` ran there once.
    ``capture_s`` is the time of warm-up and capture; ``nbytes`` the
    device memory the capture took (the growth of the allocator's
    reserved bytes across it: 0 where the pool already held enough)."""

    def __init__(self, fn: Callable[[], Any], warm: Callable[[], Any], *,
                 stream: torch.cuda.Stream, pool: Optional[tuple] = None):
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
        LAUNCHES.clear()              # neither ran the step: replays do
        LAUNCHES.update(before)
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
