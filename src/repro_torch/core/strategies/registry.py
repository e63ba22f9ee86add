"""Strategy registry — every schedulable strategy, addressable by name.

  * ``register_strategy(name, factory)`` — one call adds a strategy to
    every consumer: ``get_strategy(name)`` and ``as_policy("name")`` /
    ``api.compile(policy="name")``;
  * entries may also carry a ``policy_factory`` — ``"dynamic"`` denotes a
    *policy* (context-dependent selection), which ``as_policy`` resolves
    to the policy itself while ``get_strategy`` still hands back a
    scheduler adapter;
  * unknown names raise :class:`UnknownStrategyError` (a ``KeyError``)
    whose message lists every registered choice.

The port registers the strategies it has ported; ``flux``, ``auto``
and ``spec_decode`` — and the autotuner's ``param_space`` — wait for the
slices that port them, the autotuner and speculative decode.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


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
    """One registered strategy: ``factory(**params)`` builds a scheduler;
    ``policy_factory`` (optional) builds the ``StrategyPolicy`` form of
    policy-kind entries."""

    name: str
    factory: Callable
    policy_factory: Optional[Callable] = None


_REGISTRY: dict = {}


def register_strategy(name: str, factory: Callable, *,
                      policy_factory: Optional[Callable] = None,
                      overwrite: bool = False) -> StrategyEntry:
    """Register (or with ``overwrite=True`` replace) a strategy."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(
            f"strategy {name!r} is already registered; pass overwrite=True "
            "to replace it")
    entry = StrategyEntry(name, factory, policy_factory)
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


# -- built-in registrations --------------------------------------------------


def _dynamic_scheduler(**kw):
    from .dynamic import _DynamicAdapter
    return _DynamicAdapter(**kw)


def _dynamic_as_policy(**kw):
    from .dynamic import dynamic_policy
    return dynamic_policy(**kw)


def _register_builtins():
    from .comet import Comet
    from .dbo import DualBatchOverlap
    from .nanoflow import NanoFlow
    from .sbo import SingleBatchOverlap
    from .sequential import Sequential
    from .tokenweave import TokenWeave
    register_strategy("sequential", Sequential)
    register_strategy("nanoflow", NanoFlow)
    register_strategy("dbo", DualBatchOverlap)
    register_strategy("sbo", SingleBatchOverlap)
    register_strategy("tokenweave", TokenWeave)
    register_strategy("comet", Comet)
    register_strategy("dynamic", _dynamic_scheduler,
                      policy_factory=_dynamic_as_policy)


_register_builtins()
