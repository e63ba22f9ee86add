"""Deterministic fault injection — the serve engine's chaos harness.

A :class:`FaultInjector` is a *schedule* of failures, not a random
process: every fault fires at an exact, reproducible point (an
allocation attempt index, the N-th dispatch at a site, a named request
id, an engine iteration window), so a chaos test can assert the exact
recovery path and a degraded-mode benchmark run is replayable.  The
``seed`` only feeds derived randomized schedules (none built-in today);
the injector never consults wall-clock entropy.

Injection sites (all consulted by
:class:`~repro_torch.serve.engine.ServeEngine` when ``ServeConfig.faults``
is set):

  * **allocation**   — ``deny_alloc()``: the k-th KV-row allocation
    attempt fails as if the pool were exhausted (exercises the
    admission/requeue path without actually filling the pool).
  * **dispatch**     — ``check_dispatch(site, rids)``: the k-th dispatch
    at a site ("prefill" / "decode" / "chunk") raises
    :class:`InjectedFault`, or any dispatch containing a *poisoned*
    request id raises :class:`PoisonedRequest` (targeted — the engine's
    error boundary can blame and excise exactly one request).
  * **harvest**      — ``check_harvest(rid)``: host-side bookkeeping for
    one request raises (a poisoned request on the harvest path).
  * **slow step**    — ``on_iter(it)``: the engine iteration sleeps
    ``slow_s`` (straggler; deadline/TTFT budgets see real delay).
  * **memory pressure** — ``pressure_rows(it)``: during ``[start, stop)``
    iteration windows the KV pool's effective capacity shrinks by
    ``rows`` (the engine must shed, queue, or preempt to fit).

Every fault is raised on the host, before the dispatch it names is
staged or replayed, so the engine's error boundaries catch exactly
:data:`INJECTED` — these exceptions and nothing else.  A real device or
capture error is never turned into a request's ``Failed``: it
propagates out of the engine.
"""
from __future__ import annotations

import random
import time


class InjectedFault(RuntimeError):
    """A scheduled, untargeted fault: the whole dispatch fails.

    The engine's error boundary fails the requests of that dispatch
    (prefill group / chunk / active decode rows), never the engine."""


class PoisonedRequest(RuntimeError):
    """A targeted fault naming the request that caused it.  The engine's
    error boundary excises exactly ``rid`` (it terminates as ``Failed``)
    and retries the dispatch with the survivors."""

    def __init__(self, rid: int, site: str):
        super().__init__(f"poisoned request {rid} at {site}")
        self.rid = rid
        self.site = site


#: what the engine's error boundaries catch: the injector's faults only
INJECTED = (InjectedFault, PoisonedRequest)


class FaultInjector:
    """Deterministic fault schedule.

    Args:
      alloc_fail:    allocation-attempt indices (0-based, global) that
                     are denied.
      dispatch_fail: ``(site, index)`` pairs — the index-th dispatch at
                     that site raises :class:`InjectedFault` (one-shot).
      poison:        ``{rid: site}`` — any dispatch/harvest at ``site``
                     ("prefill" / "decode" / "chunk" / "harvest" /
                     "any") containing ``rid`` raises
                     :class:`PoisonedRequest` (persistent: a poisoned
                     request stays poisoned on retry).
      slow_iters:    engine iteration indices that sleep ``slow_s``.
      pressure:      ``(start, stop, rows)`` windows — during iterations
                     ``start <= it < stop`` the KV pool's effective
                     capacity shrinks by ``rows``.
    """

    def __init__(self, alloc_fail=(), dispatch_fail=(), poison=None,
                 slow_iters=(), slow_s: float = 0.05, pressure=(),
                 seed: int = 0):
        self.alloc_fail = set(alloc_fail)
        self.dispatch_fail = set(tuple(x) for x in dispatch_fail)
        self.poison = dict(poison or {})
        self.slow_iters = set(slow_iters)
        self.slow_s = slow_s
        self.pressure = tuple(tuple(w) for w in pressure)
        self.rng = random.Random(seed)
        self.injected: list = []           # (kind, detail) event log
        self._alloc_attempts = 0
        self._dispatches: dict[str, int] = {}

    # -- serve sites --------------------------------------------------------
    def on_iter(self, it: int):
        """Called once at the top of every engine iteration."""
        if it in self.slow_iters:
            self.slow_iters.discard(it)
            self.injected.append(("slow", it))
            time.sleep(self.slow_s)

    def pressure_rows(self, it: int) -> int:
        """Rows embargoed from the KV pool at iteration ``it``."""
        k = 0
        for start, stop, rows in self.pressure:
            if start <= it < stop:
                k = max(k, rows)
        return k

    def deny_alloc(self) -> bool:
        """True when this KV-row allocation attempt is scheduled to fail."""
        i, self._alloc_attempts = self._alloc_attempts, \
            self._alloc_attempts + 1
        if i in self.alloc_fail:
            self.injected.append(("alloc_fail", i))
            return True
        return False

    def check_dispatch(self, site: str, rids=()):
        """Raise if this dispatch is scheduled to fail.  Targeted
        (poison) faults outrank untargeted ones so the engine's blame
        path is exercised first."""
        for rid in rids:
            at = self.poison.get(rid)
            if at == site or at == "any":
                self.injected.append(("poison", site, rid))
                raise PoisonedRequest(rid, site)
        i = self._dispatches.get(site, 0)
        self._dispatches[site] = i + 1
        if (site, i) in self.dispatch_fail:
            self.dispatch_fail.discard((site, i))
            self.injected.append(("dispatch_fail", site, i))
            raise InjectedFault(f"injected {site} dispatch failure "
                                f"(dispatch #{i})")

    def check_harvest(self, rid: int):
        """Raise if host-side bookkeeping for ``rid`` is poisoned."""
        at = self.poison.get(rid)
        if at in ("harvest", "any"):
            self.injected.append(("poison", "harvest", rid))
            raise PoisonedRequest(rid, "harvest")

    # -- introspection ------------------------------------------------------
    @property
    def counts(self) -> dict:
        out: dict = {}
        for ev in self.injected:
            out[ev[0]] = out.get(ev[0], 0) + 1
        return out
