"""Intra-device parallelism strategies (paper Table 2), each implemented
as an ``OpSchedulerBase`` on the DynaFlow frontend APIs.

  sequential   fallback (paper §3.2.2: execute without a kernel)
  nanoflow     split micro-batches + resource-interleave  (Zhu et al.)
  dbo          dual-batch overlap: attention merged, MoE split (DeepSeek)
  sbo          single-batch overlap: reorder independent compute behind
               network ops (LongCat-style)
  tokenweave   fused AR+add+RMSNorm via replace_func        (Gond et al.)
  dynamic      context-driven selection among the above (the paper's
               headline contribution: per-bucket strategy choice)

The authoritative name -> strategy mapping is the **registry**
(:mod:`.registry`).
"""
from ..policy import tokens_of  # noqa: F401  (re-export)
from .dbo import DualBatchOverlap  # noqa: F401
from .dynamic import dynamic_policy  # noqa: F401
from .nanoflow import NanoFlow  # noqa: F401
from .registry import (UnknownStrategyError,  # noqa: F401
                       get_entry, make_scheduler, register_strategy,
                       strategy_names)
from .sbo import SingleBatchOverlap  # noqa: F401
from .sequential import Sequential  # noqa: F401
from .tokenweave import TokenWeave  # noqa: F401


def get_strategy(name: str, **kw):
    """Build a scheduler by registry name.  Unknown names raise
    :class:`UnknownStrategyError` (a ``KeyError``) listing choices."""
    return make_scheduler(name, **kw)
