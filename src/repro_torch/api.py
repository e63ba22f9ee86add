"""``repro_torch.api`` — one entry point from model to scheduled execution.

    program = repro_torch.api.compile("chatglm3-6b", policy="dynamic",
                                      plan_store_path="plans.dfps")
    params  = program.init_params(0)                  # on the GPU
    step    = program.prefill(2, 2048)                # step(params, batch)
    engine  = program.serve(params, ServeConfig(max_batch=4))

The :class:`Program` resolves the ``ScheduleContext`` from shapes, so
callers never build one by hand, and accepts a ``StrategyPolicy``, a bare
scheduler or a strategy name.  It owns one ``PlanStore``
(``core/plan_store.py``) that every step it builds lowers through —
prefill buckets, decode tiers, serve engines — so a known structure is
specialized or restored, not re-lowered; a ``plan_store_path``
warm-starts the store at compile time and the program checkpoints it
after every build.  ``Program.save`` / ``Program.load`` bundle the model
config, the policy and the store in one file.  Entry points run on
``"cuda"`` unless the caller asks for another device (the CPU tests pass
``device="cpu"``); on a machine without a GPU they raise instead of
silently running on the CPU.  Every plan a step builder records is
verified and linted (``core/verify.py``) under the program's ``verify``
mode: ``"warn"`` (the default) warns on error diagnostics, ``"strict"``
raises ``PlanVerificationError``, ``"off"`` skips the check; the reports
collect in ``Program.verify()``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import weakref
from typing import Any, Callable, Optional

import torch

from .core.plan import FINGERPRINT_VERSION, strategy_salt
from .core.plan_serde import FORMAT_VERSION
from .core.plan_store import (PlanStore, checkpoint_plan_store,
                              resolve_plan_store)
from .core.policy import as_policy
from .core.scheduler import ScheduleContext
from .device import resolve_device

PROGRAM_MAGIC = "dynaflow-program"
PROGRAM_FORMAT_VERSION = 1


class ProgramBundleError(ValueError):
    """A ``Program.save`` bundle that cannot be loaded: wrong magic,
    incompatible format/fingerprint versions, or a saved policy that
    cannot be rebuilt without the caller's help."""


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
            verify: str = "warn", plan_store: Optional[PlanStore] = None,
            plan_store_path: Optional[str] = None) -> "Program":
    """Build a :class:`Program`.

    ``model``  — an arch name (``"chatglm3-6b"``), an ``ArchConfig``, or a
                 built LM.
    ``policy`` — a ``StrategyPolicy``, a bare ``OpSchedulerBase``, or a
                 registry name; default: the built-in dynamic policy.
    ``smoke``  — with an arch name: the reduced same-family config.
    ``device`` — default device of ``init_params`` and ``serve``
                 (``None``: the GPU).
    ``verify`` — static plan verification (``core.verify``) of every
                 plan a step builder records, lowered IR included:
                 ``"warn"`` warns on error diagnostics, ``"strict"``
                 raises ``PlanVerificationError``, ``"off"`` skips it.
                 Every mode but ``"off"`` feeds ``Program.verify()``.
    ``plan_store`` / ``plan_store_path`` — share and persist lowered
                 plans: a path warm-starts the store now and the program
                 checkpoints it after every build.
    """
    from .models.layers import MeshInfo
    if verify not in ("strict", "warn", "off"):
        raise ValueError(f"verify must be 'strict', 'warn' or 'off', "
                         f"got {verify!r}")
    # remember how the policy was spelled: Program.save can persist a
    # name or "the default", not an opaque object
    policy_spec = ("<default>" if policy is None
                   else policy if isinstance(policy, str) else None)
    if policy is None:
        from .core.strategies.dynamic import dynamic_policy
        policy = dynamic_policy()
    policy = as_policy(policy)
    store = resolve_plan_store(plan_store, plan_store_path)
    if store is None:
        store = PlanStore()
    if isinstance(model, str):
        from .configs import get_config, get_smoke_config
        model = get_smoke_config(model) if smoke else get_config(model)
    if not hasattr(model, "build_segments"):       # ArchConfig -> LM
        from .models.registry import build_model
        model = build_model(model, MeshInfo(tp=1, dp=1))
    return Program(model, policy, device=device, store=store,
                   policy_spec=policy_spec, verify=verify)


class Program:
    """A model bound to a strategy policy and a PlanStore."""

    def __init__(self, model, policy, device=None,
                 store: Optional[PlanStore] = None,
                 policy_spec: Optional[str] = None, verify: str = "warn"):
        self.model = model
        self.policy = policy
        self.device = device
        self.store = store if store is not None else PlanStore()
        self.policy_spec = policy_spec  # "<default>" | name | None (opaque)
        self._serve_steps: dict = {}    # shared by every engine it creates
        self._engines = weakref.WeakSet()
        self.verify_mode = verify
        self._verify_reports: list = []   # (label, VerifyReport)

    # -- lifecycle ---------------------------------------------------------
    def checkpoint(self) -> int:
        """Persist the PlanStore if it is path-bound (else no-op)."""
        return checkpoint_plan_store(self.store)

    def close(self) -> int:
        """Shut down every live engine this program created (their
        graphs leave the store), checkpoint the store, and forget the
        engines; the program stays usable."""
        for engine in list(self._engines):
            engine.shutdown()
        self._engines.clear()
        return self.checkpoint()

    def __enter__(self) -> "Program":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def stats(self) -> dict:
        """The store's ``snapshot()``."""
        return self.store.snapshot()

    def verify(self):
        """Aggregated :class:`~repro_torch.core.verify.VerifyReport` over
        every plan this program's step builders recorded so far (one
        verification per segment per build, run at build time under the
        program's ``verify`` mode).  An empty report means every plan was
        clean, or ``verify="off"`` suppressed collection."""
        from .core.verify import VerifyReport
        out = VerifyReport()
        for _label, report in self._verify_reports:
            out = out.merged(report)
        return out

    def verify_reports(self) -> list:
        """The ``(label, VerifyReport)`` pairs behind :meth:`verify`, one
        per (phase, segment) built."""
        return list(self._verify_reports)

    def _verify_args(self) -> dict:
        """``build_forward`` keywords for the program's verify mode and
        report sink (``"off"`` disables both)."""
        if self.verify_mode == "off":
            return {"verify": "off", "verify_sink": None}
        return {"verify": self.verify_mode,
                "verify_sink": self._verify_reports}

    # -- one-file deployment -----------------------------------------------
    def save(self, path: str) -> int:
        """Write a one-file bundle: a versioned JSON header (model config,
        policy spec and salt, cache backend) followed by the PlanStore
        artifact, atomically.  Returns the number of persisted plan
        entries."""
        header = {
            "magic": PROGRAM_MAGIC,
            "format_version": PROGRAM_FORMAT_VERSION,
            "fingerprint_version": FINGERPRINT_VERSION,
            "plan_format_version": FORMAT_VERSION,
            "arch": dataclasses.asdict(self.model.cfg),
            "mesh_info": dataclasses.asdict(self.model.mesh),
            "policy_spec": self.policy_spec,
            "policy_salt": strategy_salt(self.policy),
            # the port has one KV cache backend, the dense one
            "cache_backend": ["dense"],
        }
        path = os.path.abspath(path)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   prefix=".program-", suffix=".tmp")
        store_tmp = tmp + ".store"
        try:
            n = self.store.save(store_tmp)
            with os.fdopen(fd, "w") as f:
                f.write(json.dumps(header, sort_keys=True) + "\n")
                with open(store_tmp) as sf:
                    f.write(sf.read())
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        finally:
            if os.path.exists(store_tmp):
                os.unlink(store_tmp)
        return n

    @staticmethod
    def load(path: str, policy=None, device=None) -> "Program":
        """Rebuild a :class:`Program` from a :meth:`save` bundle: the model
        from its config, the policy from its saved spec, and the PlanStore
        warm-started from the embedded artifact, so every plan it held
        restores with zero ``lower`` calls.  ``policy=`` overrides, and is
        required when the bundle was saved with an opaque policy object;
        a reconstructed policy whose salt differs from the saved one is
        refused rather than silently missing every cached plan."""
        from .configs.base import ArchConfig, MoEConfig, SSMConfig
        from .core.plan_serde import deep_tuple
        from .models.layers import MeshInfo
        with open(path) as f:
            head_line = f.readline()
            payload = f.read()
        try:
            header = json.loads(head_line)
            if not isinstance(header, dict):
                raise ValueError("header is not an object")
        except ValueError as e:
            raise ProgramBundleError(
                f"{path!r} is not a program bundle: {e}") from None
        if header.get("magic") != PROGRAM_MAGIC:
            raise ProgramBundleError(
                f"{path!r} is not a program bundle "
                f"(magic {header.get('magic')!r})")
        for field, want in (("format_version", PROGRAM_FORMAT_VERSION),
                            ("fingerprint_version", FINGERPRINT_VERSION),
                            ("plan_format_version", FORMAT_VERSION)):
            if header.get(field) != want:
                raise ProgramBundleError(
                    f"bundle {field} {header.get(field)} != {want}; "
                    "re-save the bundle with this version")
        if header.get("cache_backend") != ["dense"]:
            raise ProgramBundleError(
                f"bundle cache backend {header.get('cache_backend')!r}: "
                "the port has only the dense one")
        arch = dict(header["arch"])
        if arch.get("moe"):
            arch["moe"] = MoEConfig(**arch["moe"])
        if arch.get("ssm"):
            arch["ssm"] = SSMConfig(**arch["ssm"])
        arch = ArchConfig(**{k: deep_tuple(v) if isinstance(v, list) else v
                             for k, v in arch.items()})
        spec = header.get("policy_spec")
        explicit = policy is not None
        if policy is None:
            if spec == "<default>":
                policy = None
            elif isinstance(spec, str):
                policy = spec
            else:
                raise ProgramBundleError(
                    "bundle was saved with an opaque policy (salt "
                    f"{header.get('policy_salt')}); pass policy= to "
                    "Program.load")
        store = PlanStore()
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(os.path.abspath(path)),
            prefix=".program-", suffix=".store")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(payload)
            store.load(tmp)
        finally:
            os.unlink(tmp)
        from .models.registry import build_model
        model = build_model(arch, MeshInfo(**header["mesh_info"]))
        program = compile(model, policy=policy, device=device,
                          plan_store=store)
        program.policy_spec = spec
        if not explicit \
                and strategy_salt(program.policy) != header["policy_salt"]:
            raise ProgramBundleError(
                f"rebuilt policy {spec!r} hashes to "
                f"{strategy_salt(program.policy)} but the bundle was "
                f"saved under {header['policy_salt']}: the policy "
                "definition drifted; pass policy= explicitly")
        return program

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
                            self._context("prefill", global_batch, seq_len),
                            plan_cache=self.store,
                            op_config=self.model.op_closure_config(),
                            **self._verify_args())
        self.checkpoint()
        return CompiledStep(fn=fwd, segments=segs, batch_inputs=binputs)

    def decode_tiers(self, max_batch: int, s_max: int,
                     tiers=None) -> dict:
        """Decode steps at every batch tier against the program's store:
        the first tier lowers, the rest specialize.  Returns
        ``{tier: CompiledStep}``."""
        from .models.base import build_forward
        from .serve.engine import pow2_tiers
        out = {}
        for tier in tuple(tiers or pow2_tiers(max_batch)):
            segs, binputs = self.model.build_segments(
                "decode", tier, 1, s_max=s_max)
            fwd = build_forward(segs, self.policy,
                                self._context("decode", tier, s_max),
                                plan_cache=self.store,
                                op_config=self.model.op_closure_config(),
                                **self._verify_args())
            out[tier] = CompiledStep(fn=fwd, segments=segs,
                                     batch_inputs=binputs)
        self.checkpoint()
        return out

    def serve(self, params, cfg=None, *, device=None, **overrides):
        """A :class:`~repro_torch.serve.ServeEngine` over the program's
        model, policy and (shared, already warm-started) PlanStore, on
        ``device`` (default: the program's device, else the GPU), where
        ``params`` must live.  Pass a ``ServeConfig`` or its fields as
        keyword overrides — ``chunked_prefill``, ``admission=``,
        ``preemption``, ``faults=`` (the request lifecycle) included."""
        from .serve.engine import ServeConfig, ServeEngine
        if cfg is None:
            cfg = ServeConfig(**overrides)
        elif overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        dev = resolve_device(device if device is not None else self.device)
        engine = ServeEngine(self.model, params, self.policy, cfg,
                             device=dev, step_cache=self._serve_steps,
                             plan_store=self.store)
        self._engines.add(engine)
        return engine
