"""Architecture config registry.  ``get_config(arch_id)`` returns the exact
published config; ``get_smoke_config(arch_id)`` a reduced same-family config
for CPU smoke tests.  The port registers every config of the JAX
package, grok-1-314b (which serves only with FSDP weight sharding)
included."""
from .base import SHAPES, ArchConfig, MoEConfig, ShapeConfig, SSMConfig  # noqa: F401

_REGISTRY = {}


def register(cfg_fn):
    cfg = cfg_fn()
    _REGISTRY[cfg.name] = cfg_fn
    return cfg_fn


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def get_smoke_config(name: str) -> ArchConfig:
    return get_config(name).smoke()


def list_archs():
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    if _REGISTRY:
        return
    from . import (chatglm3_6b, deepseek_coder_33b,  # noqa: F401
                   deepseek_moe_16b, grok1_314b, mamba2_2p7b, minitron_8b,
                   qwen2_vl_7b, smollm_135m, whisper_tiny, zamba2_1p2b)
