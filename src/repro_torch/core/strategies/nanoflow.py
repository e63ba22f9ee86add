"""NanoFlow-style intra-device parallelism (paper §5.3.1).

Split the batch into nano-batches, then greedily interleave ready ops so
consecutive plan steps use different resources (compute / memory /
network): a network op followed by the other nano-batch's compute op is
the order an asynchronous collective overlaps in.  Below the
token threshold the strategy falls back to sequential — the dynamic
context condition whose absence degrades the naive SGLang integration to
0.35x (paper Fig. 9).
"""
from ..scheduler import OpSchedulerBase


class NanoFlow(OpSchedulerBase):
    name = "nanoflow"

    def __init__(self, min_tokens: int = 2048, n_split: int = 2):
        self.min_tokens = min_tokens
        self.n_split = n_split

    def schedule(self, ctx):
        from . import tokens_of
        b = ctx.info.local_batch
        if tokens_of(ctx.info) < self.min_tokens or b < self.n_split:
            ctx.run_rest_sequential()
            return
        from ._greedy import greedy_overlap
        n = self.n_split
        sizes = [b // n] * n
        sizes[-1] += b - sum(sizes)
        ctx.split(sizes)
        greedy_overlap(ctx, range(n))
