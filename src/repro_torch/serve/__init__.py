"""Serving: the tiered engine over a dense or paged KV cache, with greedy
or sampled decode on the device, speculative decode, chunked prefill and
the request lifecycle (admission, faults, preemption, drain)."""
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
from .kv_cache import (  # noqa: F401
    CacheBackend,
    CacheRowError,
    DenseCache,
    KVCacheManager,
    PagedCache,
    PagedKVCacheManager,
    UnpageableCache,
    resolve_cache_backend,
)
from .sampling import (  # noqa: F401
    GREEDY,
    SamplingConfig,
    resolve_sampling,
    sampling_salt,
)
from .speculative import (  # noqa: F401
    DRAFT_K_CANDIDATES,
    NGramProposer,
    Proposer,
    SelfSpecProposer,
    SpecConfig,
    resolve_proposer,
)
