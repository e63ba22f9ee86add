"""The training driver: one configuration trained by ``Program.train_step``.

Set-up makes the weights from the seed, compiles the program with its
PlanStore file under ``bench/.cache/``, builds the step and its AdamW
state, and drives that one step object through its first three steps,
each on a new batch from the seed; the first captures the step's CUDA
Graph.  From those steps it keeps what the judge compares: each loss,
the norm of each leaf's first gradient as the optimizer got it (its m
after one step over 1 - b1) and the norm of each leaf's change after
three steps.  Then the window: the same object, a new batch each step,
until ``--seconds`` have passed; a synchronise closes it.

Once the window has closed, the peak memory read and the program's state
freed, the reference trains its own float32 copy of the same weights on
the same three batches, and the judge holds the program to it
(``judge_train``).
"""
from __future__ import annotations

import gc
import time

from bench.harness import catalog, flops, judge, trace, weights

STEPS_CHECKED = 3


def _batch(gen, spec: dict, vocab: int, device, fault=None) -> dict:
    """A batch drawn on the device: ids and the next ids as labels."""
    import torch
    B, S = int(spec["batch"]), int(spec["seq"])
    toks = torch.randint(0, vocab, (B, S + 1), generator=gen, device=device,
                         dtype=torch.int32)
    out = {"ids": toks[:, :-1].contiguous(),
           "labels": toks[:, 1:].contiguous(),
           "positions": torch.arange(S, device=device, dtype=torch.int32)
           .expand(B, S).contiguous()}
    if fault == "half_batch":
        out["labels"][B // 2:] = -100      # the mean over the other half
    return out


def _batches(seed: int, spec: dict, vocab: int, device, fault=None):
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & ((1 << 63) - 1))
    while True:
        yield _batch(gen, spec, vocab, device, fault)


def run(cell: dict, cfg: dict, args, device, t_start: float) -> dict:
    import torch

    from repro_torch.api import compile as port_compile
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainStepConfig

    ref = catalog.reference(cfg["bench"]["reference"])
    spec = catalog.traffic(cell["traffic"])
    opt_cfg = dict(cell["optimizer"])
    layout = ref.param_layout(cfg)
    parts = {"start": time.perf_counter() - t_start}
    params = weights.make_params(layout, args.seed, device)
    port = cfg["bench"]
    prog = port_compile(port["arch"], smoke=port.get("smoke", False),
                        device=device, plan_store_path=args.plan_store)
    from bench.harness.drivers.serve import _check_port
    _check_port(prog, cfg, layout)
    mode = getattr(args, "control", None)
    adam = AdamWConfig(lr=opt_cfg["lr"], b1=opt_cfg["b1"], b2=opt_cfg["b2"],
                       eps=opt_cfg["eps"],
                       weight_decay=opt_cfg["weight_decay"],
                       grad_clip=opt_cfg["grad_clip"])
    tcfg = TrainStepConfig(optimizer=adam, warmup=opt_cfg["warmup"],
                           total_steps=opt_cfg["total_steps"],
                           remat=cell.get("remat", True),
                           compress_grads=mode == "control")
    B, S = int(spec["batch"]), int(spec["seq"])
    step = prog.train_step(B, S, cfg=tcfg)
    opt = step.init_opt(params)
    parts["compile"] = time.perf_counter() - t_start
    vocab = cfg[port["port_fields"]["vocab"]]
    feed = _batches(args.seed, spec, vocab, device,
                    fault="half_batch" if mode == "half_batch" else None)
    p0 = {p: t.detach().clone() for p, t in weights.leaves(params)}
    losses, first_grad = [], None
    for i in range(STEPS_CHECKED):
        params, opt, met = step.fn(params, opt, next(feed), i)
        losses.append(float(met["loss"]))
        if i == 0:
            first_grad = {p: float(st.norm()) / (1 - adam.b1) for p, st in
                          weights.leaves(opt["state"]) if p[-1] == "m"}
            first_grad = {p[:-1]: v for p, v in first_grad.items()}
    change = {p: float((t.float() - p0[p].float()).norm())
              for p, t in weights.leaves(params)}
    del p0
    if device.type == "cuda":
        torch.cuda.synchronize()
    parts["first_steps"] = time.perf_counter() - t_start

    # the window
    tr_on = bool(args.trace)
    n_done, i = 0, STEPS_CHECKED
    window_losses = []
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    t1 = t0 + args.seconds
    prof, tr = None, None
    trace_steps = 4
    while True:
        now = time.perf_counter()
        if now >= t1:
            break
        if tr_on and prof is None and now >= t0 + 0.5 * args.seconds:
            if device.type == "cuda":
                torch.cuda.synchronize()
            prof = trace.profiler()
            prof.start()
            with trace.span(trace.WINDOW):
                for _ in range(trace_steps):
                    params, opt, met = step.fn(params, opt, next(feed), i)
                    window_losses.append(met["loss"].clone())
                    i += 1
                    n_done += 1
                if device.type == "cuda":
                    torch.cuda.synchronize()
            prof.stop()
            tr = trace.analyze(prof)
            continue
        with trace.span("bench.step"):
            params, opt, met = step.fn(params, opt, next(feed), i)
        window_losses.append(met["loss"].clone())
        i += 1
        n_done += 1
    if device.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    failed = sum(1 for x in window_losses if not torch.isfinite(x).item())
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    ctx = {"kind": "train", "cell": cell["name"], "seconds": args.seconds,
           "window": (t0, t1), "window_s": t1 - t0, "steps": n_done,
           "tokens_per_step": B * S, "setup_s": setup_s, "trace": tr,
           "model": ref.dims(cfg), "trace_steps": trace_steps,
           "flops_step": flops.ssm_train_flops(ref.dims(cfg), layout, B, S)}
    info = {"setup_parts_s": parts, "steps": n_done,
            "graph": dict(step.fn.stats), "program_losses": losses}
    # free the program's state before the reference runs
    del step, opt, params, prog, met, window_losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    got = judge_train(ref, cfg, layout, spec, opt_cfg, args.seed, device,
                      losses, first_grad, change)
    limits = cell["limits"]
    checks = [(k, got[k], limits[k]) for k in limits]
    checks.append(("failed_steps", failed, 0))
    correct = all(v <= lim for _, v, lim in checks)
    info["judge"] = got
    return {"ctx": ctx, "correct": correct, "attempted": n_done,
            "failed": failed, "peak": peak, "checks": checks, "info": info}


def judge_train(ref, cfg, layout, spec, opt_cfg, seed, device, losses,
                first_grad, change) -> dict:
    """The reference's three steps on the same weights and batches, and
    the program's readings held to them.

    ``loss_rel``: the widest relative gap of a step's loss.  The leaf
    numbers are gaps of norms, not norms of differences, each over the
    reference leaf's norm or the median leaf's, whichever is larger:
    ``grad_norm_gap`` of the first clipped gradient, ``change_gap`` of
    the change after three steps.  A leaf whose reference gradient is
    under a thousandth of the median leaf's moves by round-off alone and
    is left out of the change."""
    import torch
    params = weights.make_params(layout, seed, device)
    with judge.no_tf32():
        p32 = {p: t.detach().float().clone().requires_grad_()
               for p, t in weights.leaves(params)}
        del params
        tree = {}
        for p, t in p32.items():
            node = tree
            for k in p[:-1]:
                node = node.setdefault(k, {})
            node[p[-1]] = t
        names = list(p32)
        state = [{"m": torch.zeros_like(t), "v": torch.zeros_like(t)}
                 for t in p32.values()]
        start = {p: t.detach().clone() for p, t in p32.items()}
        feed = _batches(seed, spec, cfg[cfg["bench"]["port_fields"]["vocab"]],
                        device)
        ref_losses, ref_grad = [], None
        for i in range(STEPS_CHECKED):
            b = next(feed)
            lv = ref.loss(tree, cfg, b["ids"], b["labels"])
            grads = torch.autograd.grad(lv, list(p32.values()))
            ref_losses.append(lv.item())
            scale = ref.adamw(list(p32.values()), list(grads), state, i,
                              opt_cfg)
            if i == 0:
                ref_grad = {p: float(g.norm() * scale)
                            for p, g in zip(names, grads)}
            del grads, lv
        ref_change = {p: float((t.detach() - start[p]).norm())
                      for p, t in p32.items()}
    del p32, tree, state, start
    gc.collect()

    def gap(got: dict, want: dict, keep) -> float:
        med = sorted(want.values())[len(want) // 2]
        return max(abs(got[p] - want[p]) / max(want[p], med)
                   for p in want if keep(p))

    med_g = sorted(ref_grad.values())[len(ref_grad) // 2]
    moved = {p for p, v in ref_grad.items() if v >= 1e-3 * med_g}
    leaves = {".".join(p): {"change": [change[p], ref_change[p]],
                            "first_grad": [first_grad[p], ref_grad[p]]}
              for p in ref_change}
    return {
        "leaves": leaves,
        "loss_rel": max(abs(a - b) / abs(b)
                        for a, b in zip(losses, ref_losses)),
        "grad_norm_gap": gap(first_grad, ref_grad, lambda p: True),
        "change_gap": gap(change, ref_change, lambda p: p in moved),
        "reference_losses": ref_losses,
        "leaves_left_out": sorted(".".join(p) for p in ref_grad
                                  if p not in moved),
    }
