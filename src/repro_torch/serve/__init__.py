"""Serving: the tiered greedy engine over a dense KV cache."""
from .engine import Finished, Request, ServeConfig, ServeEngine, pow2_tiers  # noqa: F401
from .kv_cache import DenseCache, KVCacheManager  # noqa: F401
