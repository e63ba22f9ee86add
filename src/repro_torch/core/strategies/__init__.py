"""Intra-device parallelism strategies (paper Table 2), each implemented
as an ``OpSchedulerBase`` on the DynaFlow frontend APIs.

  sequential   fallback (paper §3.2.2: execute without a kernel)
  nanoflow     split micro-batches + resource-interleave  (Zhu et al.)
  dbo          dual-batch overlap: attention merged, MoE split (DeepSeek)
  sbo          single-batch overlap: reorder independent compute behind
               network ops (LongCat-style)
  tokenweave   fused AR+add+RMSNorm via replace_func        (Gond et al.)
  comet        chunked a2a/expert-GEMM overlap via replace_func
  flux         fused GEMM+AR via replace_func (reproduces the paper's
               negative result §5.3.5)
  dynamic      context-driven selection among the above (the paper's
               headline contribution: per-bucket strategy choice)
  auto         cost-model-driven selection + parameterization per context
               (core/autotune.py)

The authoritative name -> strategy mapping is the **registry**
(:mod:`.registry`): ``register_strategy`` adds a strategy to every
consumer at once (``get_strategy``, ``policy="name"`` through
``api.compile``, and the autotuner's candidate enumeration).
``STRATEGIES`` is a read-only view of the registered factories.
"""
from ..policy import tokens_of  # noqa: F401  (re-export)
from .comet import Comet  # noqa: F401
from .dbo import DualBatchOverlap  # noqa: F401
from .dynamic import dynamic_policy  # noqa: F401
from .flux import Flux  # noqa: F401
from .nanoflow import NanoFlow  # noqa: F401
from .registry import (UnknownStrategyError,  # noqa: F401
                       get_entry, make_scheduler, register_strategy,
                       strategy_names, tunable_candidates)
from .registry import _REGISTRY as _REG
from .sbo import SingleBatchOverlap  # noqa: F401
from .sequential import Sequential  # noqa: F401
from .tokenweave import TokenWeave  # noqa: F401

# a view over the registry (name -> factory); prefer get_strategy() /
# register_strategy() — mutating this dict has no effect
STRATEGIES = {name: entry.factory for name, entry in sorted(_REG.items())}


def get_strategy(name: str, **kw):
    """Build a scheduler by registry name.  Unknown names raise
    :class:`UnknownStrategyError` (a ``KeyError``) listing choices."""
    return make_scheduler(name, **kw)
