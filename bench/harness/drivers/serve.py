"""The serving driver: one served configuration under one traffic mix.

Set-up makes the weights from the seed, compiles the program with its
PlanStore file under ``bench/.cache/``, builds the engine with the cell's
settings, warms exactly the decode tiers and prefill groups the mix can
reach, and runs the mix until it is steady (``settle_s``).  Then the
window: the driver calls ``engine.step()`` in a loop, submits requests
(closed loop: a client's next when its last ends; open loop: each at its
scheduled time) and takes its own timestamps after every step, so that
no engine field decides a metric.  A token is timed when the host sees it
in a request's output.  No build or capture may happen in the window.
A traced run profiles the window's last seconds and stops the profiler
once the window has closed, which holds the host for seconds;
``ctx["host_skip"]`` is the span from ``SKIP_BEFORE_S`` before the
trace's start (a request due then may still wait for its first token)
to the profiler's return, which the readers of host times leave out.

The peak memory is the window's: the counter is reset as the window
opens, so the captures' warm-up copies of the cache during set-up do not
count.  Once the window has closed, the peak read and the engine freed,
the judge runs a sample of the requests finished inside the window
through the reference.  A control run (``bench/control.py``) puts the
fp8 control in the program's place: the number held to the limit is the
control's.
"""
from __future__ import annotations

import dataclasses
import gc
import time

from bench.harness import catalog, judge, trace, traffic, weights

# requests of the sample the reference checks, every served token of each;
# fewer requests or served tokens compared than these fail the run
CHECK_REQUESTS, CHECK_TOKENS_MIN = 8, 192
WAIT_AFTER_S = 60.0       # open loop: the longest wait for a due request
SKIP_BEFORE_S = 1.0       # host_skip opens this long before the trace
COUNTERS = ("graph_captures", "prefill_graph_captures",
            "chunk_graph_captures")


def _check_port(prog, cfg: dict, layout) -> None:
    """The port runs the configuration as the file states it."""
    pc = prog.model.cfg
    for field, key in cfg["bench"]["port_fields"].items():
        have = getattr(pc, field) if field != "hd" else pc.hd
        if have != cfg[key]:
            raise SystemExit(f"the port's {field}={have} is not the "
                             f"configuration's {key}={cfg[key]}")
    from repro_torch.tree import leaves_with_paths
    segs, _ = prog.model.build_segments("prefill", 2, 2, s_max=4)
    port = {p: tuple(t.shape) for p, t in
            leaves_with_paths(prog.model.param_shapes(segs))}
    want = {p: tuple(s) for p, s, _, _ in layout}
    if port != want:
        raise SystemExit(f"the port's weights {port} are not the "
                         f"benchmark's layout {want}")


def _warm_shapes(engine, mix) -> tuple:
    """Decode tiers and (group, bucket) prefill pairs the mix reaches: a
    closed loop with as many clients as rows keeps the top tier; an open
    loop may reach every tier.  Every group tier with every bucket that
    a prompt of the mix's range falls in."""
    if mix.loop == "closed":
        tiers = (engine._tier_for(mix.clients, engine.tiers),)
    else:
        tiers = tuple(engine.tiers)
    lo = min(len(r.prompt) for r in mix.requests)
    hi = max(len(r.prompt) for r in mix.requests)
    buckets = sorted({engine._bucket(n) for n in (lo, hi)}
                     | {b for b in engine.cfg.prefill_buckets if lo <= b <= hi})
    pairs = tuple((g, b) for g in engine.prefill_tiers for b in buckets)
    return tiers, pairs


class _Run:
    """The driver's records of every request it sent."""

    def __init__(self, engine, Request):
        self.engine, self.Request = engine, Request
        self.live: dict = {}     # rid -> (record, engine request)
        self.recs: list = []

    def submit(self, tr, now: float, due: float):
        er = self.Request(rid=tr.rid, prompt=tr.prompt,
                          max_new_tokens=tr.max_new)
        rec = {"rid": tr.rid, "prompt": tr.prompt, "max_new": tr.max_new,
               "due": due, "submitted": now, "admitted": None,
               "emits": [], "done": None, "ok": False, "warm": tr.warmup}
        self.recs.append(rec)
        self.live[tr.rid] = (rec, er)
        self.engine.submit(er)

    def poll(self, now: float) -> list:
        """Record what the last step changed; returns the records that
        ended."""
        waiting = {id(r) for r in self.engine.waiting}
        ended = []
        for rid, (rec, er) in list(self.live.items()):
            if rec["admitted"] is None and id(er) not in waiting:
                rec["admitted"] = now
            out = er.output
            n = len(out) - (1 if out and out[-1] == -100 else 0)
            if n > len(rec["emits"]):
                rec["emits"].extend([now] * (n - len(rec["emits"])))
            if er.result is not None:
                rec["done"] = now
                rec["ok"] = bool(er.ok)
                rec["served"] = [t for t in out if t != -100]
                if rec["admitted"] is None:
                    rec["admitted"] = now
                del self.live[rid]
                ended.append(rec)
        return ended


def run(cell: dict, cfg: dict, args, device, t_start: float) -> dict:
    import torch

    from repro_torch.api import compile as port_compile
    from repro_torch.serve import Request, ServeConfig

    ref = catalog.reference(cfg["bench"]["reference"])
    spec = catalog.traffic(cell["traffic"])
    layout = ref.param_layout(cfg)
    parts = {"start": time.perf_counter() - t_start}
    params = weights.make_params(layout, args.seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    parts["weights"] = time.perf_counter() - t_start
    port = cfg["bench"]
    prog = port_compile(port["arch"], smoke=port.get("smoke", False),
                        device=device, plan_store_path=args.plan_store)
    _check_port(prog, cfg, layout)
    ecfg = dict(cell["engine"])
    ecfg["prefill_buckets"] = tuple(ecfg["prefill_buckets"])
    engine = prog.serve(params, ServeConfig(**ecfg))
    vocab = cfg[port["port_fields"]["vocab"]]
    mix = traffic.serve_traffic(spec, args.seed, vocab, args.seconds)
    tiers, pairs = _warm_shapes(engine, mix)
    parts["compile"] = time.perf_counter() - t_start
    engine.warmup(tiers=tiers, prefill=pairs)
    engine.checkpoint()
    warm_stats = engine.stats
    parts["warmup"] = time.perf_counter() - t_start

    run_ = _Run(engine, Request)
    pool = list(mix.requests)
    nxt = 0
    t_traffic = time.perf_counter()
    if mix.loop == "closed":
        for _ in range(mix.clients):
            run_.submit(pool[nxt], t_traffic, t_traffic)
            nxt += 1
    first_wave = list(run_.recs)

    def step_once(now):
        nonlocal nxt
        if mix.loop == "open":
            while nxt < len(pool) and t_traffic + pool[nxt].due_s <= now:
                run_.submit(pool[nxt], now, t_traffic + pool[nxt].due_s)
                nxt += 1
            if not engine._busy():
                if nxt < len(pool):
                    time.sleep(max(0.0, min(
                        1e-3, t_traffic + pool[nxt].due_s - now)))
                return time.perf_counter(), []
        with trace.span("bench.step"):
            engine.step()
        t = time.perf_counter()
        with trace.span("bench.poll"):
            ended = run_.poll(t)
        if mix.loop == "closed":
            for _ in ended:
                tr = pool[nxt % len(pool)]
                if nxt >= len(pool):       # the pool again, under new rids
                    tr = dataclasses.replace(tr, rid=nxt, warmup=False)
                run_.submit(tr, t, t)
                nxt += 1
        return t, ended

    # settle: the first wave admitted and the mix steady
    now = time.perf_counter()
    while True:
        if now - t_traffic >= mix.settle_s and (
                mix.loop == "open"
                or all(r["admitted"] is not None for r in first_wave)):
            break
        now, _ = step_once(now)

    # the window
    kv_cap = engine.cache.token_capacity()
    stats0 = engine.stats
    queue = [len(engine.waiting)]
    in_flight = [len(run_.live)]
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    t1 = t0 + args.seconds
    tr_on = bool(args.trace)
    trace_s = min(3.0, args.seconds / 3)
    tr_from = t1 - trace_s
    prof = trace.profiler() if tr_on else None
    tr_cm, skip = None, None
    iters, ends, kv = [], [], []
    now = t0
    while now < t1:
        if tr_on and tr_cm is None and now >= tr_from:
            prof.start()
            tr_cm = trace.span(trace.WINDOW)
            tr_cm.__enter__()
        before = now
        now, _ = step_once(now)
        iters.append(now - before)
        ends.append(now)
        if tr_on:
            kv.append(engine.cache.resident_tokens() / kv_cap)
    if tr_cm is not None:
        tr_cm.__exit__(None, None, None)
        torch.cuda.synchronize() if device.type == "cuda" else None
        prof.stop()
        skip = (tr_from - SKIP_BEFORE_S, time.perf_counter())
    t1 = now
    stats1 = engine.stats
    queue.append(len(engine.waiting))
    in_flight.append(len(run_.live))
    # open loop: wait for each request due in the window, arrivals going on
    # (those due in the window's last step are sent first)
    if mix.loop == "open":
        while nxt < len(pool) and pool[nxt].due_s <= t1 - t_traffic:
            run_.submit(pool[nxt], time.perf_counter(),
                        t_traffic + pool[nxt].due_s)
            nxt += 1
        due_in = [r for r in run_.recs if t0 <= r["due"] <= t1]
        limit = time.perf_counter() + WAIT_AFTER_S
        while (any(r["done"] is None and not r["emits"] for r in due_in)
               and time.perf_counter() < limit):
            step_once(time.perf_counter())
    wait_end = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device)
        reserved = torch.cuda.memory_reserved(device)
    else:
        peak = reserved = 0
    built = {k: stats1[k] - stats0[k] for k in COUNTERS}
    built["tier_builds"] = len(stats1["tier_builds"]) \
        - len(stats0["tier_builds"])
    built["plan_misses"] = (stats1["plan_store"]["misses"]
                            - stats0["plan_store"]["misses"])
    ctx = {"kind": "serve", "cell": cell["name"], "seconds": args.seconds,
           "window": (t0, t1), "window_s": t1 - t0, "requests": run_.recs,
           "iters": iters, "iter_ends": ends, "host_skip": skip,
           "kv_resident": kv, "stats0": stats0,
           "stats1": stats1, "model": ref.dims(cfg), "setup_s": setup_s,
           "wait_end": wait_end,
           "trace": trace.analyze(prof) if tr_cm is not None else None}
    finished = [(r["prompt"], r["served"]) for r in run_.recs
                if r["ok"] and r["done"] is not None
                and t0 <= r["done"] <= t1]
    attempted = len(run_.recs)
    failed = sum(1 for r in run_.recs
                 if r["done"] is not None and not r["ok"])
    info = {"warmed_tiers": list(tiers), "warmed_prefill": [list(p) for p in
                                                            pairs],
            "warm_captures": {k: warm_stats[k] for k in COUNTERS},
            "built_in_window": built,
            "setup_parts_s": parts, "store": stats1["plan_store"],
            "iterations": len(iters), "queue_at_open_close": queue,
            "in_flight_at_open_close": in_flight,
            "memory_reserved_bytes": reserved,
            "submitted_late_s_max": max(
                [r["submitted"] - r["due"] for r in run_.recs] or [0.0])}
    # free the program's state before the reference runs
    engine.shutdown()
    del engine, prog, run_
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    sample = judge.pick_sample(finished, args.seed, CHECK_REQUESTS)
    got = judge.logit_gaps(ref, params, cfg, sample, device,
                           linear=judge.fp8_linear if args.control else None)
    held = got["control_max_logit_gap" if args.control else "max_logit_gap"]
    if args.control:
        info["judge"] = got
    limit = cell["limits"]["max_logit_gap"]
    checks = [("max_logit_gap", held, limit),
              ("requests_compared_min", got["requests_compared"],
               CHECK_REQUESTS),
              ("tokens_compared_min", got["tokens_compared"],
               CHECK_TOKENS_MIN),
              ("failed_requests", failed, 0),
              ("builds_in_window", sum(built.values()), 0)]
    correct = (held <= limit
               and got["requests_compared"] >= CHECK_REQUESTS
               and got["tokens_compared"] >= CHECK_TOKENS_MIN
               and failed == 0 and sum(built.values()) == 0)
    return {"ctx": ctx, "correct": correct, "attempted": attempted,
            "failed": failed, "peak": peak, "checks": checks, "info": info,
            "judge": got}
