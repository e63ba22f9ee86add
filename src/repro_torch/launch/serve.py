"""Serving launcher: the tiered async batched engine over a model, built
through the ``repro_torch.api`` facade (the port of
``src/repro/launch/serve.py``: the same flags and printed lines, plus
``--device``).

  python -m repro_torch.launch.serve --arch chatglm3-6b \\
      --requests 8 --max-new 16 --strategy dynamic

runs on the GPU; ``--device cpu --smoke`` runs the reduced same-family
config on the CPU.  ``--baseline`` reverts the engine to the synchronous
fixed-batch shape (single decode tier, one-request prefill, per-step
host sync) for A/B comparison against the tiered async default.
``main(argv)`` returns the finished requests.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from .. import api
from ..serve import Request, ServeConfig


def main(argv=None):
    from ..core.strategies.registry import strategy_names
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chatglm3-6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--s-max", type=int, default=128)
    ap.add_argument("--strategy", default="dynamic",
                    choices=strategy_names(),
                    help="strategy registry name; 'dynamic' = built-in "
                         "pick table, 'auto' = cost-model autotuner "
                         "(verdicts persist via --plan-store)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefill-batch", type=int, default=4,
                    help="max requests packed into one prefill call")
    ap.add_argument("--baseline", action="store_true",
                    help="fixed-batch synchronous engine (no tiers, "
                         "batch-1 prefill, per-step host sync)")
    ap.add_argument("--plan-store", default=None,
                    help="persist lowered plans here (warm restarts)")
    args = ap.parse_args(argv)

    program = api.compile(args.arch, policy=args.strategy,
                          smoke=args.smoke, device=args.device,
                          plan_store_path=args.plan_store)
    params = program.init_params(0)
    scfg = ServeConfig(max_batch=args.max_batch, s_max=args.s_max,
                       prefill_buckets=(16, 32, 64),
                       prefill_batch=1 if args.baseline
                       else args.prefill_batch,
                       decode_tiers=(args.max_batch,) if args.baseline
                       else None,
                       async_host=not args.baseline)
    eng = program.serve(params, scfg)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for i in range(args.requests):
        n = int(rng.integers(4, 30))
        eng.submit(Request(rid=i,
                           prompt=rng.integers(0, program.model.cfg.vocab,
                                               n, dtype=np.int32),
                           max_new_tokens=args.max_new))
    done = eng.run()
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    print(f"served {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s)  stats={eng.stats}")
    st = eng.stats
    tier_mix = {t: n for t, n in st["tier_steps"].items() if n}
    print(f"decode tier mix: {tier_mix}  "
          f"({st['host_syncs']} host syncs / {st['decode_steps']} decode "
          f"steps, {st['row_moves']} row moves, "
          f"{st['chunk_steps']} chunk steps)")
    ttfts = [r.first_token_s - r.submitted_s for r in done]
    print(f"TTFT p50={np.percentile(ttfts, 50)*1e3:.0f}ms "
          f"p99={np.percentile(ttfts, 99)*1e3:.0f}ms")
    eng.shutdown()
    program.close()
    return done


if __name__ == "__main__":
    main()
