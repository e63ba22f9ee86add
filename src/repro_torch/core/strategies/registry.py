"""Strategy registry — every schedulable strategy, addressable by name.

The registry makes the strategy surface a first-class, extensible API:

  * ``register_strategy(name, factory, param_space)`` — one call adds a
    strategy to every consumer: ``get_strategy(name)``,
    ``as_policy("name")`` / ``api.compile(policy="name")``, and the
    :class:`~repro_torch.core.autotune.AutoPolicy` candidate
    enumeration;
  * ``param_space`` declares the parameterizations the autotuner sweeps
    (a mapping of constructor-kwarg name to a tuple of values — the
    cartesian product is the candidate set);
  * entries may also carry a ``policy_factory`` — names like
    ``"dynamic"`` and ``"auto"`` denote *policies* (context-dependent
    selection), which ``as_policy`` resolves to the policy itself while
    ``get_strategy`` still hands back a scheduler adapter;
  * unknown names raise :class:`UnknownStrategyError` (a ``KeyError``)
    whose message lists every registered choice.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Iterator, Mapping, Optional


class UnknownStrategyError(KeyError):
    """A strategy name with no registry entry; lists the valid choices."""

    def __init__(self, name: str, choices):
        self.unknown_name = name
        self.choices = tuple(choices)
        super().__init__(
            f"unknown strategy {name!r}; registered strategies: "
            f"{', '.join(self.choices)}")

    def __str__(self):          # KeyError.__str__ would repr the message
        return self.args[0]


@dataclasses.dataclass(frozen=True)
class StrategyEntry:
    """One registered strategy.

    ``factory(**params)`` builds a scheduler; ``param_space`` is a
    canonical tuple of ``(kwarg, (values...))`` pairs the autotuner
    enumerates; ``policy_factory`` (optional) builds the
    ``StrategyPolicy`` form of policy-kind entries; ``tunable`` gates
    whether :class:`AutoPolicy` considers the entry a candidate
    (policy-kind entries are selectors, not schedules — never tuned)."""

    name: str
    factory: Callable
    param_space: tuple = ()
    policy_factory: Optional[Callable] = None
    tunable: bool = True

    def candidates(self) -> Iterator[dict]:
        """Parameter dicts over the cartesian product of ``param_space``
        (one empty dict when the strategy has no tunable knobs)."""
        if not self.param_space:
            yield {}
            return
        names = [n for n, _ in self.param_space]
        for combo in itertools.product(*(vs for _, vs in self.param_space)):
            yield dict(zip(names, combo))


_REGISTRY: dict = {}


def register_strategy(name: str, factory: Callable,
                      param_space: Optional[Mapping] = None, *,
                      policy_factory: Optional[Callable] = None,
                      tunable: bool = True,
                      overwrite: bool = False) -> StrategyEntry:
    """Register (or with ``overwrite=True`` replace) a strategy."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(
            f"strategy {name!r} is already registered; pass overwrite=True "
            "to replace it")
    space = tuple(sorted(
        (str(k), tuple(v)) for k, v in dict(param_space or {}).items()))
    entry = StrategyEntry(name, factory, space, policy_factory, tunable)
    _REGISTRY[name] = entry
    return entry


def strategy_names() -> list:
    return sorted(_REGISTRY)


def get_entry(name: str) -> StrategyEntry:
    entry = _REGISTRY.get(name)
    if entry is None:
        raise UnknownStrategyError(name, strategy_names())
    return entry


def make_scheduler(name: str, **params):
    """Build a scheduler instance by registry name (typed error on an
    unknown name) — the implementation behind ``get_strategy``."""
    return get_entry(name).factory(**params)


def tunable_candidates() -> Iterator[tuple]:
    """``(name, params)`` pairs the autotuner enumerates, in a
    deterministic order (sorted names × declared param space)."""
    for name in strategy_names():
        entry = _REGISTRY[name]
        if not entry.tunable:
            continue
        for params in entry.candidates():
            yield name, params


# -- built-in registrations --------------------------------------------------
# Scheduler entries declare the parameterizations worth sweeping:
# NanoFlow/DBO register with min_tokens=1 in the tuning space — the
# autotuner's cost model (split_weight_penalty) decides where splitting
# stops paying, instead of a hand-picked token threshold.


def _dynamic_scheduler(**kw):
    from .dynamic import _DynamicAdapter
    return _DynamicAdapter(**kw)


def _dynamic_as_policy(**kw):
    from .dynamic import dynamic_policy
    return dynamic_policy(**kw)


def _auto_as_policy(**kw):
    from ..autotune import AutoPolicy
    return AutoPolicy(**kw)


def _auto_scheduler(**kw):
    from ..policy import PolicyScheduler
    return PolicyScheduler(_auto_as_policy(**kw), name="auto")


def _spec_decode_scheduler(**kw):
    # spec_decode is a knob carrier, not a graph scheduler: the serve
    # engine reads its param_space ("draft_k") for SpecConfig(k="auto")
    # candidates, while the op-schedule of the verify step is whatever
    # strategy/policy the engine was compiled with.  Resolving it as a
    # strategy hands back plain sequential scheduling.
    from .sequential import Sequential
    kw.pop("draft_k", None)
    return Sequential(**kw)


def _register_builtins():
    from .comet import Comet
    from .dbo import DualBatchOverlap
    from .flux import Flux
    from .nanoflow import NanoFlow
    from .sbo import SingleBatchOverlap
    from .sequential import Sequential
    from .tokenweave import TokenWeave
    register_strategy("sequential", Sequential)
    register_strategy("nanoflow", NanoFlow,
                      {"min_tokens": (1,), "n_split": (2, 4)})
    register_strategy("dbo", DualBatchOverlap, {"min_tokens": (1,)})
    register_strategy("sbo", SingleBatchOverlap)
    register_strategy("tokenweave", TokenWeave)
    register_strategy("comet", Comet)
    register_strategy("flux", Flux)
    register_strategy("dynamic", _dynamic_scheduler,
                      policy_factory=_dynamic_as_policy, tunable=False)
    register_strategy("auto", _auto_scheduler,
                      policy_factory=_auto_as_policy, tunable=False)
    # draft-k tunable for serve-side speculative decode.  tunable=False
    # keeps it out of the autotuner's *scheduler* sweep (it does not
    # schedule ops); AutoPolicy.spec_draft_k picks from this param_space
    # using acceptance rates fed through AutoPolicy.observe.
    register_strategy("spec_decode", _spec_decode_scheduler,
                      {"draft_k": (2, 4, 8)}, tunable=False)


_register_builtins()
