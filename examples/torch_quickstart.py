"""DynaFlow quickstart on PyTorch: decouple a model's execution schedule
from its code.

1. Write a model as plain sequential Modules/Ops (no scheduling logic).
2. Trace it into an OpGraph; partition with annotations (Fig. 5 APIs).
3. Write a scheduler in ~15 lines of Python (Fig. 6 APIs).
4. Compile: ``repro_torch.api.compile`` turns (model, policy) into a
   Program — any valid schedule computes the same result, and the Program
   owns plan recording, lowering and caching behind one call.  On the GPU
   each call runs the lowered plan over per-resource CUDA streams, so the
   network branch's stream overlaps the compute branch's.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

import repro_torch.api
from repro_torch.core import Mark, OpSchedulerBase, partition, trace
from repro_torch.core.module import Module, Op, Param, TensorSpec, mark
from repro_torch.device import resolve_device


# ---- 1. a plain sequential model -----------------------------------------


class Linear(Op):
    resource = "compute"

    def __init__(self, d_in, d_out, name):
        super().__init__()
        self.w = Param((d_in, d_out), torch.float32)
        self.named(name)

    def kernel(self, p, x):
        return torch.tanh(x @ p["w"])


class FakeCollective(Op):
    """Stands in for an all-reduce (network-bound) in this 1-GPU demo."""

    resource = "network"

    def __init__(self, name):
        super().__init__()
        self.named(name)

    def kernel(self, p, x):
        return x  # dist.all_reduce(x) under a process group


class Concat(Op):
    resource = "memory"

    def kernel(self, p, a, b):
        return torch.cat([a, b], -1)


class TwoBranchModel(Module):
    def __init__(self, d=32):
        super().__init__()
        self.stem = Linear(d, d, "stem")
        self.heavy = Linear(d, d, "heavy_gemm")
        self.comm = FakeCollective("allreduce")
        self.cat = Concat().named("concat")
        self.out = Linear(2 * d, 8, "out")

    def forward(self, x):
        h = self.stem(x)
        with mark("overlap_me"):     # Fig. 5: annotate a region
            a = self.comm(h)         # network-bound branch
            b = self.heavy(h)        # compute-bound branch (independent!)
        return self.out(self.cat(a, b))


# ---- 3. a custom scheduler (Fig. 6): issue network first, overlap ---------


class OverlapFirst(OpSchedulerBase):
    def schedule(self, ctx):
        while True:
            ready = ctx.get_ready_ops()
            if not ready:
                break
            nets = [h for h in ready if ctx.resource_of(h) == "network"]
            for h in nets:
                ctx.execute(h)          # collective issued first...
            for h in ctx.get_ready_ops():
                ctx.execute(h)          # ...compute fills its window


class SplitBatch(OpSchedulerBase):
    def schedule(self, ctx):
        ctx.split([4, 4])               # two micro-batches
        ctx.run_rest_sequential()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    # ---- 2. trace + partition ---------------------------------------------
    model = TwoBranchModel()
    example = {"x": TensorSpec((8, 32), torch.float32)}
    graph = trace(model, example)
    print("captured operator graph:")
    print(graph.pretty())

    coarse = partition(graph, [Mark("overlap_me")])
    print("\nafter partition([Mark('overlap_me')]):")
    print(coarse.pretty())

    # ---- 4. every schedule computes the same function ---------------------
    # repro_torch.api.compile is the whole integration: model (or traced
    # graph) + policy in, a Program out — plan recording, lowering and
    # the PlanStore are its problem, not the user's.
    params = model.init(0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((8, 32), generator=gen, device=dev)
    baseline = repro_torch.api.compile(model, policy="sequential",
                                       example_inputs=example, device=dev)
    want = baseline(params, {"x": x})["out"]

    for sched in (OverlapFirst(), SplitBatch()):
        program = repro_torch.api.compile(model, policy=sched,
                                          example_inputs=example, device=dev)
        print(f"\n{type(sched).__name__} plan:")
        print(program.plan(local_batch=8).pretty())
        got = program(params, {"x": x})["out"]
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        print("=> output identical to sequential execution")

    print("\nquickstart OK")


if __name__ == "__main__":
    main()
