"""Serving: the tiered greedy engine over a dense KV cache, with chunked
prefill and the request lifecycle (admission, faults, preemption,
drain)."""
from .admission import (  # noqa: F401
    AdmissionContext,
    AdmissionPolicy,
    AdmitAll,
    BoundedQueue,
    ChunkingDisabled,
    DeadlineExceeded,
    DeadlineGate,
    EmptyPrompt,
    EngineDraining,
    Failed,
    Finished,
    Overloaded,
    PagePressure,
    PriorityFloor,
    PromptOverflow,
    RejectedRequest,
    Shed,
    UnchunkablePrompt,
    admission_chain,
)
from .engine import Request, ServeConfig, ServeEngine, pow2_tiers  # noqa: F401
from .faults import FaultInjector, InjectedFault, PoisonedRequest  # noqa: F401
from .kv_cache import CacheRowError, DenseCache, KVCacheManager  # noqa: F401
