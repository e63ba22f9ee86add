"""Sequential fallback — the paper's baseline mode (Fig. 8 'fallback')."""
from ..scheduler import OpSchedulerBase


class Sequential(OpSchedulerBase):
    name = "sequential"

    def schedule(self, ctx):
        ctx.run_rest_sequential()
