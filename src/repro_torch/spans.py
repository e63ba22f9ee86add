"""Spans and device spans: where the port's host and device time goes.

``span(name)`` brackets host code.  Each name accrues ``SPANS[name] =
[count, self seconds]``, process-wide like ``kernels.LAUNCHES``: self
time is the span's duration less the time of the spans opened inside it
on the same thread, so the self times of different names never overlap
and sum to the time the spans cover.  Counts and times accrue only while
no ``torch.profiler`` records, since the profiler slows the host several
times over; while one records, a span opens a
``torch.profiler.record_function(name)`` instead, so that the name lies
in the profiler's trace.  Outside a profiler a span costs one test of
the autograd profiler's flag, two clock reads and a table update (an
unguarded ``record_function`` costs twenty times that).

``device_span(key)`` brackets device work (one CUDA Graph replay) on the
current stream with two timing events from a recycled pool.  The pair
accrues into ``DEVICE_S[key] = [count, seconds, gap seconds]`` once its
end event has completed, the gap being the device time from the end of
the span resolved before it to its start: both on the device's clock, so
that the share of device time between spans needs no host clock.
``resolve()`` takes every completed pair in record order and never
waits, so a caller resolves after a sync it makes anyway, and
``snapshot()`` resolves first.

``snapshot()`` copies both tables: ``{"spans": ..., "device_spans":
...}``.  The serve engine reports it in ``stats``; the names in use:

  serve.step        one engine iteration (its count: the iterations)
  serve.admit       shedding, preemption, sorting and row allocation
  serve.prefill     one prefill group staged and launched
  serve.chunk       one chunk group staged and launched
  serve.decode      a decode (or speculative) dispatch: flags,
                    compaction, staging and launch
  serve.sync        the harvest's wait for the device's tokens
  serve.harvest     the bookkeeping after that wait
  stage.wait        waiting for a pinned staging buffer that a queued
                    copy still reads (``core/capture.py``'s ``Staged``,
                    in serving and training alike): a wait for the
                    device, nested in the span that stages
  plan.build        a step built: traced, partitioned, scheduled,
                    lowered or specialised
  plan.restore      a persisted plan redeemed
  graph.warm        a graph's warm-up run (``core/capture.py``)
  graph.settle      synchronize, collect and empty the allocator's cache
  graph.record      the capture proper

and the device spans ``prefill/<bp>/<bucket>``, ``chunk/<bc>/<chunk>``,
``decode/<tier>``, ``verify/<tier>/<k>`` and ``draft/<tier>/<k>``, one
a graph replay.
"""
from __future__ import annotations

import collections
import functools
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

SPANS: dict = {}       # name -> [count, self seconds]
DEVICE_S: dict = {}    # key -> [count, seconds, gap seconds before]

_lock = threading.Lock()
_tls = threading.local()
_pending = collections.deque()   # (key, (start, end, device)) in record order
_free: dict = {}                 # device -> [(start, end, device), ...]
_last: dict = {}                 # device -> the pair resolved last


def _stack() -> list:
    """This thread's open spans: the child seconds of each, innermost
    last."""
    try:
        return _tls.stack
    except AttributeError:
        _tls.stack = []
        return _tls.stack


class span:
    """Time the body as ``name`` (see the module's docstring)."""

    __slots__ = ("name", "_t0", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        else:
            self._rf = None
            _stack().append(0.0)
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
            return False
        dt = time.perf_counter() - self._t0
        stack = _tls.stack
        own = dt - stack.pop()
        if stack:
            stack[-1] += dt
        if not _autograd_profiler._is_profiler_enabled:
            with _lock:
                entry = SPANS.get(self.name)
                if entry is None:
                    SPANS[self.name] = [1, own]
                else:
                    entry[0] += 1
                    entry[1] += own
        return False


def spanned(name: str):
    """Decorate a function so that every call runs inside
    ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


class device_span:
    """Time the device work enqueued in the body on the current CUDA
    stream as ``key``.  Never inside a stream capture."""

    __slots__ = ("key", "_ev")

    def __init__(self, key: str):
        self.key = key

    def __enter__(self):
        dev = torch.cuda.current_device()
        free = _free.setdefault(dev, [])
        self._ev = free.pop() if free else (
            torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True), dev)
        self._ev[0].record()
        return self

    def __exit__(self, *exc):
        self._ev[1].record()
        _pending.append((self.key, self._ev))
        return False


def resolve():
    """Accrue the pending device spans whose end event has completed, in
    record order, without waiting.  A pair's events go back to the pool
    once the next pair's gap has been read from its end."""
    while _pending and _pending[0][1][1].query():
        key, ev = _pending.popleft()
        start, end, dev = ev
        seconds = start.elapsed_time(end) / 1e3
        prev = _last.get(dev)
        gap = prev[1].elapsed_time(start) / 1e3 if prev is not None else 0.0
        _last[dev] = ev
        with _lock:
            entry = DEVICE_S.get(key)
            if entry is None:
                DEVICE_S[key] = [1, seconds, gap]
            else:
                entry[0] += 1
                entry[1] += seconds
                entry[2] += gap
        if prev is not None:
            _free[dev].append(prev)


def snapshot() -> dict:
    """Copies of both tables, the completed device spans resolved
    first."""
    resolve()
    with _lock:
        return {"spans": {k: list(v) for k, v in SPANS.items()},
                "device_spans": {k: list(v) for k, v in DEVICE_S.items()}}
