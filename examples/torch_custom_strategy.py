"""Write-your-own intra-device parallelism strategy (paper Fig. 7), on
the PyTorch port.

Implements a DBO-style scheduler from scratch in ~20 lines against the
real deepseek-moe layer graph, then scores it with the plan-level overlap
model against the built-in strategies — the paper's rapid-prototyping
workflow (§5.3.5: Flux was validated and REJECTED the same way).

The selection is programmable too: the last section wraps
MyDBO in a ``StrategyPolicy`` (~8 lines) so it only fires on large MoE
prefill buckets and every other context falls through to cheap built-ins
— the paper's "dynamic" headline as user code.

Everything here runs on the host: tracing, partitioning, plan recording,
the overlap model and the verifier touch no device.

Run:  PYTHONPATH=src python examples/torch_custom_strategy.py
"""
from repro_torch.configs import get_config
from repro_torch.core import (Mark, OpSchedulerBase, by_phase,
                              by_token_threshold, first_viable, has_ops,
                              partition, record_plan, resolve_strategy, when)
from repro_torch.core.plan import OpHandle
from repro_torch.core.scheduler import ScheduleContext
from repro_torch.core.strategies import (get_strategy, register_strategy,
                                         tunable_candidates)
from repro_torch.models.layers import MeshInfo
from repro_torch.models.registry import build_model
from repro_torch.roofline.overlap import plan_overlap, split_weight_penalty


# ---- the paper's Fig. 7(a-c) example, written by a "user" -----------------


class MyDBO(OpSchedulerBase):
    """Attention merged, MoE split in two, a2a's interleaved."""

    def partition_rules(self):
        return [Mark("moe_dispatch"), Mark("moe_combine"),
                Mark("moe_shared")]

    def schedule(self, ctx):
        if ctx.info.local_batch < 2:          # dynamic context check
            ctx.run_rest_sequential()
            return
        ctx.split([ctx.info.local_batch // 2,
                   ctx.info.local_batch - ctx.info.local_batch // 2])
        g = ctx.graph
        moe = {h.oid for h in ctx.find(r"moe_dispatch|moe_combine|"
                                       r"expert_ffn|moe_shared")}
        for oid in g.topo_order():
            n = g.nodes[oid]
            if oid in moe:
                continue                       # interleaved below
            hs = tuple(OpHandle(oid, i, n.name) for i in (0, 1))
            ctx.execute(hs if g.splittable(oid) else hs[:1])
            if oid + 1 in moe:                 # entering the MoE region
                while True:
                    ready = [h for i in (0, 1)
                             for h in ctx.get_ready_ops(i)
                             if h.oid in moe]
                    if not ready:
                        break
                    nets = [h for h in ready
                            if ctx.resource_of(h) == "network"]
                    ctx.execute(nets[0] if nets else ready[0])


def main():
    cfg = get_config("deepseek-moe-16b")
    # the JAX package builds this graph with attn_impl="chunked", its
    # blockwise attention for TPU pods; the port's MeshInfo has no such
    # knob: its attention op always takes the flash kernel
    model = build_model(cfg, MeshInfo(tp=16, dp=16))
    segs, _ = model.build_segments("prefill", 8, 2048, s_max=2048)
    seg = max((s for s in segs if s.count > 1),
              key=lambda s: len(s.graph.nodes))
    info = ScheduleContext(local_batch=8, seq_len=2048, phase="prefill",
                           arch=cfg.name)

    for fabric, bw in (("pod ICI", 1.0), ("multi-node DCN (~1/8)", 0.125)):
        print(f"\n--- fabric: {fabric} ---")
        print(f"{'strategy':14s}{'t_modeled':>12s}{'coll exposed':>14s}")
        results = {}
        for name in ("sequential", "sbo", "dbo", "mine"):
            strat = (MyDBO() if name == "mine"
                     else get_strategy(name, **({"min_tokens": 1}
                                                if name == "dbo" else {})))
            g = seg.graph
            if strat.partition_rules():
                g = partition(g, strat.partition_rules(), default_depth=2)
            plan = record_plan(g, strat, info)
            pen = split_weight_penalty(g, plan.num_mb)
            rep = plan_overlap(g, plan, tp=16, extra_weight_read_bytes=pen,
                               bw_scale=bw)
            results[name] = rep
            print(f"{name:14s}{rep.t_overlapped*1e3:11.3f}ms"
                  f"{rep.coll_exposed*1e3:13.3f}ms")
        speed = (results["sequential"].t_overlapped
                 / results["mine"].t_overlapped)
        print(f"MyDBO modeled speedup vs sequential: {speed:.3f}x")

    # ---- static verification: catch schedule bugs before any GPU -------
    # The verifier replays the plan's data flow and reports *every*
    # violation as a typed diagnostic (repro_torch.core.verify.CODES) instead
    # of an opaque first-error crash.  A clean MyDBO plan:
    from repro_torch.core import ExecutionPlan, verify
    g = partition(seg.graph, MyDBO().partition_rules(), default_depth=2)
    info = ScheduleContext(local_batch=8, seq_len=2048, phase="prefill",
                           arch=cfg.name)
    plan = record_plan(g, MyDBO(), info)
    report = verify(g, plan, lint=True)
    assert report.ok
    print(f"\nMyDBO plan verified: {report.pretty()}")
    # ...and the same plan with one step dropped — every downstream
    # consequence reported with op + micro-batch provenance:
    broken = ExecutionPlan(plan.steps[:-1], plan.split_sizes,
                           plan.graph_fingerprint)
    bad = verify(g, broken)
    assert not bad.ok
    print(f"one step dropped -> {len(bad.errors)} typed diagnostic(s), "
          f"e.g.\n  {bad.errors[0]}")

    # ---- context-conditional selection: MyDBO as a StrategyPolicy ------
    # 8 lines turn the scheduler into a policy: large MoE prefill buckets
    # get MyDBO, small ones SBO, decode always sequential.  The policy
    # drops straight into repro_torch.api.compile(..., policy=my_policy) and
    # its identity salts the PlanStore, so swapping it never replays a
    # stale plan.
    my_policy = by_phase(
        decode=get_strategy("sequential"),
        default=by_token_threshold(
            [(2048, get_strategy("sbo"))],
            above=first_viable(when(has_ops(r"moe_a2a|expert_ffn"),
                                    MyDBO()),
                               default=get_strategy("nanoflow"))))
    print("\npolicy resolution per context:")
    for phase, b, s in (("prefill", 8, 2048), ("prefill", 2, 128),
                        ("decode", 8, 1)):
        ctx = ScheduleContext(local_batch=b, seq_len=s, phase=phase,
                              arch=cfg.name)
        sched = resolve_strategy(my_policy, ctx, graph=seg.graph)
        print(f"  {phase:8s} B={b:2d} S={s:5d} -> "
              f"{type(sched).__name__}")
    assert isinstance(resolve_strategy(
        my_policy, ScheduleContext(local_batch=8, seq_len=2048,
                                   phase="prefill", arch=cfg.name),
        graph=seg.graph), MyDBO)
    # ---- one registration makes MyDBO a first-class name ---------------
    # ``policy="my_dbo"`` now works through repro_torch.api.compile and the
    # launch --strategy flags, and ``policy="auto"`` ranks it against
    # every built-in with the same cost model used above.
    register_strategy("my_dbo", MyDBO)
    assert isinstance(get_strategy("my_dbo"), MyDBO)
    assert ("my_dbo", {}) in list(tunable_candidates())
    print('registered "my_dbo": usable as policy="my_dbo" and swept by '
          'policy="auto"')
    print("custom_strategy OK — 20 lines of user Python + an 8-line "
          "policy, validated before touching a GPU")


if __name__ == "__main__":
    main()
