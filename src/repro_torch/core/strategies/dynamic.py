"""Context-driven strategy selection — the paper's headline capability.

``dynamic_policy()`` states the selection as :mod:`..policy` combinators
— the same API users compose their own policies from — and
``_DynamicAdapter`` is the scheduler adapter over that policy:

  MoE graph, large batch   -> DBO  (attention merged, MoE split+overlap)
  dense graph, large batch -> NanoFlow split + TokenWeave fusion targets
  any graph, small batch   -> SBO reorder-only (no split: the paper's
                              Fig. 2a point — splitting small batches
                              inflates memory traffic)
  tiny batch               -> sequential fallback (lowest CPU overhead,
                              paper Fig. 8)
"""
import dataclasses

from ..policy import (PolicyScheduler, StrategyPolicy, by_token_threshold,
                      first_viable, has_ops, local_batch_below, when)
from .dbo import DualBatchOverlap
from .nanoflow import NanoFlow
from .sbo import SingleBatchOverlap
from .sequential import Sequential
from .tokenweave import TokenWeave


@dataclasses.dataclass(frozen=True)
class has_fusable_triples:
    """Predicate: the graph has [all-reduce -> add -> RMSNorm] chains
    TokenWeave can replace with its fused kernel."""

    def __call__(self, ctx) -> bool:
        g = (ctx.extra or {}).get("graph")
        return g is not None and bool(TokenWeave().triples(g))


def dynamic_policy(split_tokens: int = 2048, seq_tokens: int = 64,
                   fuse: bool = True) -> StrategyPolicy:
    """The built-in ``dynamic`` selection, stated as policy combinators.

    Token thresholds route tiny steps to sequential and sub-split steps
    to SBO; above the split threshold a viability chain prefers DBO on
    MoE graphs, TokenWeave where its fusion targets exist, and NanoFlow
    otherwise.  Users swap any branch without touching the others."""
    sbo = SingleBatchOverlap()
    fuse_branch = (when(has_fusable_triples(), TokenWeave()),) if fuse \
        else ()
    big = first_viable(
        when(local_batch_below(2), sbo),
        when(has_ops(r"moe_a2a|expert_ffn"),
             DualBatchOverlap(min_tokens=split_tokens)),
        *fuse_branch,
        default=NanoFlow(min_tokens=split_tokens))
    return by_token_threshold(
        [(seq_tokens, Sequential()), (split_tokens, sbo)], above=big)


class _DynamicAdapter(PolicyScheduler):
    """Scheduler adapter over ``dynamic_policy`` (or any policy passed as
    ``policy=``): resolves the sub-strategy at plan-record time from the
    partitioned graph + context, then delegates ``schedule``.

    This is the registry's scheduler-path form of ``"dynamic"``
    (``get_strategy("dynamic")``)."""

    name = "dynamic"

    def __init__(self, split_tokens: int = 2048, seq_tokens: int = 64,
                 fuse: bool = True, policy: StrategyPolicy = None):
        self.split_tokens = split_tokens
        self.seq_tokens = seq_tokens
        self.fuse = fuse
        super().__init__(policy or dynamic_policy(split_tokens, seq_tokens,
                                                  fuse),
                         name="dynamic")
