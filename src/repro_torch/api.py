"""``repro_torch.api`` — one entry point from model to scheduled execution.

    program = repro_torch.api.compile("chatglm3-6b", policy="dynamic")
    params  = program.init_params(0)                  # on the GPU
    step    = program.prefill(2, 2048)                # step(params, batch)
    engine  = program.serve(params, ServeConfig(max_batch=4))

The :class:`Program` resolves the ``ScheduleContext`` from shapes, so
callers never build one by hand, and accepts a ``StrategyPolicy``, a bare
scheduler or a strategy name.  Entry points run on ``"cuda"`` unless the
caller asks for another device (the CPU tests pass ``device="cpu"``); on
a machine without a GPU they raise instead of silently running on the
CPU.  There is no PlanStore yet: every step builder records its plans
anew.  There is no plan verifier yet either (``core/verify.py`` is
ROADMAP queue 1 item 8): ``verify="strict"`` raises
``NotImplementedError`` rather than promise a check it cannot make;
``"warn"`` and ``"off"`` build, unchecked; any other value raises
``ValueError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from .core.policy import as_policy
from .core.scheduler import ScheduleContext
from .device import resolve_device


@dataclasses.dataclass
class CompiledStep:
    """A built step function plus the input specs to feed it."""

    fn: Callable
    segments: Any = None
    batch_inputs: Any = None

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)

    @property
    def strategies(self) -> dict:
        """Segment key -> the scheduler the policy resolved to."""
        return dict(self.fn.strategies)


def compile(model, policy=None, smoke: bool = False, device=None,
            verify: str = "warn") -> "Program":
    """Build a :class:`Program`.

    ``model``  — an arch name (``"chatglm3-6b"``), an ``ArchConfig``, or a
                 built LM.
    ``policy`` — a ``StrategyPolicy``, a bare ``OpSchedulerBase``, or a
                 registry name; default: the built-in dynamic policy.
    ``smoke``  — with an arch name: the reduced same-family config.
    ``device`` — default device of ``init_params`` and ``serve``
                 (``None``: the GPU).
    ``verify`` — ``"warn"`` or ``"off"``: plans are not verified (no
                 verifier is ported); ``"strict"`` raises
                 ``NotImplementedError``.
    """
    from .models.layers import MeshInfo
    if verify == "strict":
        raise NotImplementedError(
            "verify='strict' needs the plan verifier (core/verify.py), "
            "which is not ported yet (ROADMAP queue 1 item 8); use 'warn' "
            "or 'off'")
    if verify not in ("warn", "off"):
        raise ValueError(f"verify must be 'strict', 'warn' or 'off', "
                         f"got {verify!r}")
    if policy is None:
        from .core.strategies.dynamic import dynamic_policy
        policy = dynamic_policy()
    policy = as_policy(policy)
    if isinstance(model, str):
        from .configs import get_config, get_smoke_config
        model = get_smoke_config(model) if smoke else get_config(model)
    if not hasattr(model, "build_segments"):       # ArchConfig -> LM
        from .models.registry import build_model
        model = build_model(model, MeshInfo(tp=1, dp=1))
    return Program(model, policy, device=device)


class Program:
    """A model bound to a strategy policy."""

    def __init__(self, model, policy, device=None):
        self.model = model
        self.policy = policy
        self.device = device
        self._serve_steps: dict = {}    # shared by every engine it creates

    def _context(self, phase: str, B: int, S: int) -> ScheduleContext:
        return ScheduleContext(local_batch=B, global_batch=B, seq_len=S,
                               phase=phase, arch=self.model.cfg.name)

    def init_params(self, seed: int = 0, device=None) -> dict:
        """Random parameter tree from ``seed`` on ``device`` (default: the
        program's device, else the GPU)."""
        dev = resolve_device(device if device is not None else self.device)
        return self.model.init_params(seed, device=dev)

    def prefill(self, global_batch: int, seq_len: int, *,
                s_max: Optional[int] = None) -> CompiledStep:
        """Build the prefill step for a (batch, seq-bucket) shape."""
        from .models.base import build_forward
        segs, binputs = self.model.build_segments(
            "prefill", global_batch, seq_len, s_max=s_max or seq_len)
        fwd = build_forward(segs, self.policy,
                            self._context("prefill", global_batch, seq_len))
        return CompiledStep(fn=fwd, segments=segs, batch_inputs=binputs)

    def decode_tiers(self, max_batch: int, s_max: int,
                     tiers=None) -> dict:
        """Decode steps at every batch tier: ``{tier: CompiledStep}``."""
        from .models.base import build_forward
        from .serve.engine import pow2_tiers
        out = {}
        for tier in tuple(tiers or pow2_tiers(max_batch)):
            segs, binputs = self.model.build_segments(
                "decode", tier, 1, s_max=s_max)
            fwd = build_forward(segs, self.policy,
                                self._context("decode", tier, s_max))
            out[tier] = CompiledStep(fn=fwd, segments=segs,
                                     batch_inputs=binputs)
        return out

    def serve(self, params, cfg=None, *, device=None, **overrides):
        """A :class:`~repro_torch.serve.ServeEngine` over the program's
        model and policy, on ``device`` (default: the program's device,
        else the GPU), where ``params`` must live."""
        from .serve.engine import ServeConfig, ServeEngine
        if cfg is None:
            cfg = ServeConfig(**overrides)
        elif overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        dev = resolve_device(device if device is not None else self.device)
        return ServeEngine(self.model, params, self.policy, cfg, device=dev,
                           step_cache=self._serve_steps)
