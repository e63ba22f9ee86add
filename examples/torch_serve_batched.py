"""End-to-end serving driver on the PyTorch port: batched requests through
the DynaFlow engine.

The whole integration is one ``repro_torch.api.compile`` call: arch +
strategy policy + KV cache backend in, a Program out whose ``serve()``
owns the engine, the schedule contexts and the PlanStore lifecycle.
Serves chatglm3 with bucketed prefill, continuous-batching decode on the
paged KV backend, and the dynamic policy choosing per-bucket plans — the
paper's deployment story in miniature.  On the GPU every decode tier and
prefill group runs as one CUDA Graph replay.  Afterwards the whole
program is packed into ONE file with ``program.save``: arch + policy
spec + cache backend + every lowered plan.  The "restarted" server is a
single ``Program.load``: it serves the same requests again, with the
same tokens, without re-lowering a single plan (restore hits and shares
only).

The CPU runs the smoke configs; on the GPU the published ones run,
since the smoke head dim (8) is below the 64 or 128 the attention
kernels take (``--arch smollm-135m`` is the small one).

Run:  PYTHONPATH=src python examples/torch_serve_batched.py --device cpu
      PYTHONPATH=src python examples/torch_serve_batched.py \\
          --arch smollm-135m                            # on the GPU
"""
import argparse
import os
import tempfile
import time

import numpy as np

import repro_torch.api
from repro_torch.device import resolve_device
from repro_torch.serve import Request, ServeConfig


def requests(n, vocab, max_new, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(0, vocab, int(rng.integers(4, 50)),
                                        dtype=np.int32),
                    max_new_tokens=max_new) for i in range(n)]


def serve(program, params, serve_cfg, reqs):
    eng = program.serve(params, serve_cfg)
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    dt = time.perf_counter() - t0
    st = eng.stats
    eng.shutdown()
    return {r.rid: list(r.output) for r in done}, done, dt, st


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chatglm3-6b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--strategy", default="dynamic")
    ap.add_argument("--bundle", default=None,
                    help="save the program bundle here (default: a temp "
                         "file)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    smoke = dev.type != "cuda"      # the kernels refuse the smoke head dim

    with tempfile.TemporaryDirectory(prefix="dynaflow-") as tmp:
        run(args, dev, smoke,
            args.bundle or os.path.join(tmp, "program.dfpb"))
    print("serve_batched OK")


def run(args, dev, smoke, bundle):
    serve_cfg = ServeConfig(max_batch=8, s_max=128,
                            prefill_buckets=(16, 32, 64))

    program = repro_torch.api.compile(args.arch, policy=args.strategy,
                                      smoke=smoke, cache="paged",
                                      device=dev)
    params = program.init_params(0)
    vocab = program.model.cfg.vocab
    tokens, done, dt, st = serve(
        program, params, serve_cfg,
        requests(args.requests, vocab, args.max_new))
    toks = sum(len(r.output) for r in done)
    ttft = [r.first_token_s - r.submitted_s for r in done]
    print(f"served {len(done)} requests / {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s) on {dev}")
    print(f"TTFT p50={np.percentile(ttft, 50)*1e3:.0f}ms "
          f"p99={np.percentile(ttft, 99)*1e3:.0f}ms")
    print(f"decode tier mix: "
          f"{ {t: n for t, n in st['tier_steps'].items() if n} } "
          f"({st['host_syncs']} host syncs / {st['decode_steps']} decode "
          f"steps, {st['chunk_steps']} chunk steps)")
    print(f"kv backend: {st['kv']}")
    ps = program.stats
    print(f"plan store: {ps['exec_misses']} builds, {ps['exec_hits']} "
          f"replays; {ps['misses']} lowered, {ps['shares']} shared across "
          f"buckets (share rate {ps['share_rate']:.0%})")
    assert len(done) == args.requests
    assert all(len(r.output) == args.max_new for r in done)
    n_plans = program.save(bundle)
    program.close()

    # -- "restart" the server: one file holds the whole deployment --------
    # Program.load rebuilds arch + policy + paged cache backend from the
    # bundle header and restores every lowered plan, so the restarted
    # engine serves with zero lower() calls.
    print(f"\nrestarting from {bundle} "
          f"({n_plans} plans, {os.path.getsize(bundle)} bytes)...")
    program2 = repro_torch.api.Program.load(bundle, device=dev)
    print(f"restored backend: {program2.cache_backend}")
    tokens2, _, dt, _ = serve(
        program2, params, serve_cfg,
        requests(args.requests, vocab, args.max_new))
    ps2 = program2.stats
    print(f"the same {args.requests} requests after restart: {dt:.2f}s; "
          f"{ps2['restore_hits']} restored lowerings, {ps2['shares']} "
          f"shared, {ps2['misses']} cold lowers")
    assert ps2["misses"] == 0, (
        f"warm-started engine re-lowered {ps2['misses']} plans: {ps2}")
    assert tokens2 == tokens, "the restarted server's tokens differ"
    print("=> same tokens as before the restart")
    program2.close()


if __name__ == "__main__":
    main()
