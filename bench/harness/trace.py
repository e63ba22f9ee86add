"""Read a ``torch.profiler`` window: device busy time, the device
operations that took most time, and the idle gaps by what the host was
doing.

The window is a ``record_function`` range the driver opens around a
steady stretch of its timed loop (``WINDOW``).  Busy time is the union of
every device interval (kernels, copies, sets) inside it, so operations
overlapping on two streams count once.  An idle gap is named by the
innermost host event on the driver's thread that spans the gap's middle:
a runtime call (``cudaGraphLaunch``, ``cudaEventSynchronize``), an aten
op, or one of the driver's own ranges (``bench.*``) when the host was in
plain Python.
"""
from __future__ import annotations

import bisect
import contextlib

WINDOW = "bench.window"
TOP = 10
_SCAN = 4000            # host events searched back from a gap's middle


def profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


@contextlib.contextmanager
def span(name: str):
    """A named host range, seen by the profiler when it runs."""
    import torch
    with torch.profiler.record_function(name):
        yield


def _short(name: str) -> str:
    """A kernel's name without its return type, at most 160 letters."""
    if name.startswith("void "):
        name = name[5:]
    return name[:160]


def _union(intervals):
    """Merged ``[(start, end)]`` of intervals sorted by start."""
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _top(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]


def analyze(prof) -> dict:
    """``busy_s``, ``window_s``, ``device_ops``, ``idle_gaps`` and the
    window's device ``ops`` as ``(name, start_s, seconds)``; ``None`` when
    the window holds no device operation."""
    from torch.autograd import DeviceType
    events = prof.events()
    win = [e for e in events if e.name == WINDOW]
    if not win:
        return None
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    thread = win[0].thread
    dev, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # the host's ranges are mirrored onto the device's timeline
            # as annotations: not device work
            if t > w0 and s < w1 and not e.is_user_annotation \
                    and not e.name.startswith("bench."):
                dev.append((max(s, w0), min(t, w1), _short(e.name)))
        elif e.thread == thread and e.name != WINDOW and t > w0 and s < w1:
            host.append((s, t, e.name))
    if not dev:
        return None
    dev.sort()
    busy = _union([(s, t) for s, t, _ in dev])
    busy_us = sum(t - s for s, t in busy)
    by_op: dict = {}
    for s, t, name in dev:
        by_op[name] = by_op.get(name, 0.0) + (t - s) / 1e6
    host.sort()
    starts = [h[0] for h in host]
    gaps: dict = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        name = "host: outside every range"
        for j in range(i, max(-1, i - _SCAN), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    return {"busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
            "device_ops": _top(by_op), "idle_gaps": _top(gaps),
            "ops": [(name, (s - w0) / 1e6, (t - s) / 1e6)
                    for s, t, name in dev]}
