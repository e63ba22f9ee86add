"""``repro_torch.api`` — one entry point from model to scheduled execution.

    program = repro_torch.api.compile("chatglm3-6b", policy="dynamic",
                                      plan_store_path="plans.dfps")
    params  = program.init_params(0)                  # on the GPU
    step    = program.prefill(2, 2048)                # step(params, batch)
    engine  = program.serve(params, ServeConfig(max_batch=4))
    train   = program.train_step(8, 2048)             # training
    opt     = train.init_opt(params)
    params, opt, metrics = train(params, opt, batch, 0)   # in place

The :class:`Program` resolves the ``ScheduleContext`` from shapes, so
callers never build one by hand, and accepts a ``StrategyPolicy``, a bare
scheduler or a strategy name.  It owns one ``PlanStore``
(``core/plan_store.py``) that every step it builds lowers through —
prefill buckets, decode tiers, serve engines — so a known structure is
specialized or restored, not re-lowered; a ``plan_store_path``
warm-starts the store at compile time and the program checkpoints it
after every build.  ``Program.save`` / ``Program.load`` bundle the model
config, the policy, the KV cache backend and the store in one file.
``compile`` also takes an untraced ``core.Module`` with
``example_inputs`` (name -> ``TensorSpec``) or a traced ``OpGraph``, the
quickstart path: that program records, lowers and realizes one plan per
shape bucket through the same store (``Program.plan``,
``Program.__call__``).
``policy="auto"`` is the cost-model autotuner (``core/autotune.py``): its
verdicts persist in the store, so a loaded program re-tunes nothing, and
``Program.explain()`` shows them.  Entry points run on
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

from .core.backend import Realizer
from .core.graph import OpGraph
from .core.module import Module, trace
from .core.plan import FINGERPRINT_VERSION, strategy_salt
from .core.plan_serde import FORMAT_VERSION
from .core.plan_store import (PlanStore, checkpoint_plan_store,
                              resolve_plan_store)
from .core.policy import as_policy, resolve_strategy
from .core.scheduler import ScheduleContext, record_plan
from .device import resolve_device

PROGRAM_MAGIC = "dynaflow-program"
PROGRAM_FORMAT_VERSION = 1


class ProgramBundleError(ValueError):
    """A ``Program.save`` bundle that cannot be loaded: wrong magic,
    incompatible format/fingerprint versions, or a saved policy that
    cannot be rebuilt without the caller's help."""


@dataclasses.dataclass
class CompiledStep:
    """A built step function plus the input specs to feed it.  Steps of a
    program compiled with ``mesh=`` are rank-local (``launch/steps.py``)
    and also carry the global ``in_specs`` and the ``in_placements`` /
    ``out_placements`` of their arguments and results
    (``launch/sharding.py``)."""

    fn: Callable
    segments: Any = None
    batch_inputs: Any = None
    init_opt: Optional[Callable] = None    # train steps: the optimizer state
    in_specs: Any = None
    in_placements: Any = None
    out_placements: Any = None

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)

    @property
    def strategies(self) -> dict:
        """Segment key -> the scheduler the policy resolved to."""
        return dict(self.fn.strategies)


def compile(model, policy=None, smoke: bool = False, device=None,
            verify: str = "warn", plan_store: Optional[PlanStore] = None,
            plan_store_path: Optional[str] = None,
            cache=None, example_inputs=None, mesh=None,
            mesh_info=None) -> "Program":
    """Build a :class:`Program`.

    ``model``  — an arch name (``"chatglm3-6b"``), an ``ArchConfig``, a
                 built LM, or (the prototyping path) an untraced
                 ``core.Module`` or a traced ``OpGraph``.
    ``policy`` — a ``StrategyPolicy``, a bare ``OpSchedulerBase``, or a
                 registry name (``"auto"`` for the cost-model autotuner,
                 whose verdicts persist in the plan store); default: the
                 built-in dynamic policy.
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
    ``cache``  — KV cache backend of ``serve()``: a
                 ``serve.CacheBackend`` (``DenseCache`` / ``PagedCache``),
                 the names ``"dense"`` / ``"paged"``, or ``None`` to leave
                 the choice to ``ServeConfig``.  Its identity salts the
                 serve steps' PlanStore keys and is saved in
                 ``Program.save`` bundles.
    ``example_inputs`` — name -> ``TensorSpec``, required when ``model``
                 is an untraced ``Module``.
    ``mesh``   — ``None`` (one device), a ``models.layers.MeshInfo`` (one
                 device, explicit tp/dp for model construction), or a
                 ``DeviceMesh`` from ``launch.mesh.make_mesh``: the
                 program's steps are then rank-local over its groups
                 (``launch/steps.py``), ``init_params`` gives this rank's
                 shard, and ``serve`` / ``save`` refuse; or a
                 ``launch.dryrun.ShapeMesh``, a mesh's shape alone (the
                 dry run's: steps of rank 0's local shapes, built with
                 no process group, run on ``meta``).
    ``mesh_info`` — the ``MeshInfo`` to build the model with under a
                 ``DeviceMesh`` when ``launch.mesh.make_mesh_info``'s
                 default (no FSDP) is not wanted, e.g. ``fsdp=True``.
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
    if policy_spec is None and _is_default_auto(policy):
        # an AutoPolicy that differs from policy="auto" only in its
        # measurement knobs shares its identity: the bundle can name it
        policy_spec = "auto"
    store = resolve_plan_store(plan_store, plan_store_path)
    if store is None:
        store = PlanStore()
    # store-aware policies (AutoPolicy) persist tuning verdicts beside
    # the plans they decided: bind before any step builds
    bind = getattr(policy, "bind_store", None)
    if callable(bind):
        bind(store)
    if isinstance(model, Module):
        if example_inputs is None:
            raise ValueError(
                "compile(Module, ...) needs example_inputs= "
                "(name -> TensorSpec) to trace the graph")
        model = trace(model, dict(example_inputs))
    if isinstance(model, OpGraph):
        return Program(graph=model, policy=policy, store=store,
                       verify=verify, device=device)
    device_mesh = None if mesh is None or isinstance(mesh, MeshInfo) \
        else mesh
    if mesh_info is None:
        mesh_info = mesh if isinstance(mesh, MeshInfo) else None
    if mesh_info is None:
        if device_mesh is not None:
            from .launch.mesh import make_mesh_info
            mesh_info = make_mesh_info(device_mesh)
        else:
            mesh_info = MeshInfo(tp=1, dp=1)
    if isinstance(model, str):
        from .configs import get_config, get_smoke_config
        model = get_smoke_config(model) if smoke else get_config(model)
    if not hasattr(model, "build_segments"):       # ArchConfig -> LM
        from .models.registry import build_model
        model = build_model(model, mesh_info)
    return Program(model, policy, device=device, store=store,
                   policy_spec=policy_spec, verify=verify, cache=cache,
                   mesh=device_mesh)


def _is_default_auto(policy) -> bool:
    from .core.autotune import AutoPolicy
    return isinstance(policy, AutoPolicy) \
        and strategy_salt(policy) == strategy_salt(AutoPolicy())


class Program:
    """A model bound to a strategy policy and a PlanStore: an LM (the
    step builders below) or a raw ``OpGraph`` (``plan`` and
    ``__call__``)."""

    def __init__(self, model=None, policy=None, device=None,
                 store: Optional[PlanStore] = None,
                 policy_spec: Optional[str] = None, verify: str = "warn",
                 cache=None, graph: Optional[OpGraph] = None, mesh=None):
        self.model = model
        self.graph = graph
        self.mesh = mesh                # a DeviceMesh, or None
        self.policy = policy
        self.device = device
        self.store = store if store is not None else PlanStore()
        self.policy_spec = policy_spec  # "<default>" | name | None (opaque)
        self._serve_steps: dict = {}    # shared by every engine it creates
        self._engines = weakref.WeakSet()
        self.verify_mode = verify
        self._verify_reports: list = []   # (label, VerifyReport)
        if cache is not None:
            from .serve.kv_cache import resolve_cache_backend
            cache = resolve_cache_backend(cache)
        self.cache_backend = cache      # None: ServeConfig decides
        self._graph_cache: dict = {}    # (local_batch, phase) -> (g, rz, plan)

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

    def explain(self) -> list:
        """The policy's decision table: one dict per scheduling decision.

        Policies that keep per-context verdicts (``policy="auto"``)
        report them in full — winner, parameters, modeled against
        sequential time, memory, measurement provenance; every other
        policy reports one identity row (what it is and the salt its
        plans persist under)."""
        table = getattr(self.policy, "explain", None)
        if callable(table):
            return table()
        return [{"policy": self.policy_spec or self.policy.name,
                 "salt": strategy_salt(self.policy)}]

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

    def _require_lm(self, what: str):
        if self.model is None:
            raise TypeError(
                f"Program.{what} needs an LM program; this program wraps "
                "a raw Module/OpGraph — call it directly instead")

    # -- one-file deployment -----------------------------------------------
    def save(self, path: str) -> int:
        """Write a one-file bundle: a versioned JSON header (model config,
        policy spec and salt, cache backend) followed by the PlanStore
        artifact, atomically.  Returns the number of persisted plan
        entries."""
        self._require_lm("save")
        if self.mesh is not None:
            raise ProgramBundleError(
                "Program.save is single-host: a DeviceMesh is "
                "process-local; load() the bundle and recompile with "
                "mesh= instead")
        header = {
            "magic": PROGRAM_MAGIC,
            "format_version": PROGRAM_FORMAT_VERSION,
            "fingerprint_version": FINGERPRINT_VERSION,
            "plan_format_version": FORMAT_VERSION,
            "arch": dataclasses.asdict(self.model.cfg),
            "mesh_info": dataclasses.asdict(self.model.mesh),
            "policy_spec": self.policy_spec,
            "policy_salt": strategy_salt(self.policy),
            "cache_backend": (list(self.cache_backend.identity())
                              if self.cache_backend is not None else None),
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
    def load(path: str, policy=None, device=None, cache=None) -> "Program":
        """Rebuild a :class:`Program` from a :meth:`save` bundle: the model
        from its config, the policy from its saved spec, the cache
        backend from its identity, and the PlanStore warm-started from
        the embedded artifact, so every plan it held restores with zero
        ``lower`` calls.  ``policy=`` overrides, and is required when the
        bundle was saved with an opaque policy object; a reconstructed
        policy whose salt differs from the saved one is refused rather
        than silently missing every cached plan.  ``cache=`` overrides
        the saved backend; an identity no backend has is refused."""
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
        if cache is None and header.get("cache_backend") is not None:
            from .serve.kv_cache import backend_from_identity
            try:
                cache = backend_from_identity(
                    deep_tuple(header["cache_backend"]))
            except (TypeError, ValueError) as e:
                raise ProgramBundleError(
                    f"bundle cache backend: {e}") from None
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
                          plan_store=store, cache=cache)
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

    def init_params(self, seed: int = 0, device=None,
                    phase: str = "prefill") -> dict:
        """Random parameter tree from ``seed`` on ``device`` (default: the
        program's device, else the GPU), drawn for ``phase``'s segments.
        Without FSDP every phase's tree has the same layout; with it the
        gathered layout (prefill, train) keys its weights apart from the
        resident decode layout (``launch.sharding.fsdp_gathered_tree``
        carries one tree over to the other).  Under a mesh: this rank's
        shard of the global tree drawn from ``seed``, whose values do not
        depend on the mesh; each layer is drawn whole and cut at once, so
        the peak is one global layer beside the local shards."""
        self._require_lm("init_params")
        dev = resolve_device(device if device is not None else self.device)
        shard = None
        if self.mesh is not None:
            from .launch.sharding import shard_tree, spec_to_placements
            from .tree import tree_map

            def shard(tree, pspecs):
                return shard_tree(tree, tree_map(spec_to_placements, pspecs),
                                  self.mesh)
        return self.model.init_params(seed, device=dev, phase=phase,
                                      shard=shard)

    def _step_args(self) -> dict:
        return {"plan_store": self.store, **self._verify_args()}

    def train_step(self, global_batch: int, seq_len: int, *, cfg=None,
                   remat_policy: str = "full") -> CompiledStep:
        """Build the train step for a (batch, seq) bucket.

        Returns a :class:`CompiledStep` whose ``fn(params, opt, batch,
        step) -> (params, opt, metrics)`` updates ``params`` and ``opt``
        in place (``train/step.py``), with ``init_opt``, ``segments`` and
        ``batch_inputs``.  On CUDA tensors ``fn`` replays the whole step
        as one CUDA Graph, captured at its first call for each set of
        param and optimizer storages (``fn.stats``); its metrics are then
        the graph's outputs, rewritten by the next call.  ``fn.eager`` is
        the same step run op by op, the path the CPU takes.  Its plans
        lower through the program's PlanStore and are verified under the
        program's ``verify`` mode, like ``prefill``'s.  ``cfg``: a
        ``TrainStepConfig`` (default: remat under ``remat_policy``).
        Under a mesh the step is rank-local (``launch/steps.py``)."""
        self._require_lm("train_step")
        from .launch.steps import build_train_step
        from .train.step import TrainStepConfig
        tcfg = cfg or TrainStepConfig(remat=True, remat_policy=remat_policy)
        step = build_train_step(self.model, self.policy, global_batch,
                                seq_len, self.mesh, tcfg, **self._step_args())
        self.checkpoint()
        return step

    def prefill(self, global_batch: int, seq_len: int, *,
                s_max: Optional[int] = None) -> CompiledStep:
        """Build the prefill step for a (batch, seq-bucket) shape (under a
        mesh: rank-local, ``launch/steps.py``)."""
        self._require_lm("prefill")
        from .launch.steps import build_prefill_step
        step = build_prefill_step(self.model, self.policy, global_batch,
                                  seq_len, self.mesh, s_max or seq_len,
                                  **self._step_args())
        self.checkpoint()
        return step

    def decode_tiers(self, max_batch: int, s_max: int,
                     tiers=None) -> dict:
        """Decode steps at every batch tier against the program's store:
        the first tier lowers, the rest specialize (under a mesh:
        rank-local, ``launch/steps.py``).  Returns ``{tier:
        CompiledStep}``."""
        self._require_lm("decode_tiers")
        from .launch.steps import build_decode_tiers
        out = build_decode_tiers(self.model, self.policy, max_batch, s_max,
                                 self.mesh, tiers, **self._step_args())
        self.checkpoint()
        return out

    def serve(self, params, cfg=None, *, device=None, **overrides):
        """A :class:`~repro_torch.serve.ServeEngine` over the program's
        model, policy and (shared, already warm-started) PlanStore, on
        ``device`` (default: the program's device, else the GPU), where
        ``params`` must live.  Pass a ``ServeConfig`` or its fields as
        keyword overrides — ``chunked_prefill``, ``admission=``,
        ``preemption``, ``faults=`` (the request lifecycle), ``cache=``,
        ``sampling=``, ``seed`` and ``async_host`` included.  The
        program's cache backend is the default; ``ServeConfig.cache``
        wins over it."""
        self._require_lm("serve")
        if self.mesh is not None:
            raise NotImplementedError(
                "Program.serve is single-host (the engine's host loop); "
                "use decode_tiers()/prefill() for mesh-global serving "
                "steps")
        from .serve.engine import ServeConfig, ServeEngine
        if cfg is None:
            cfg = ServeConfig(**overrides)
        elif overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        if cfg.cache is None and self.cache_backend is not None:
            cfg = dataclasses.replace(cfg, cache=self.cache_backend)
        dev = resolve_device(device if device is not None else self.device)
        engine = ServeEngine(self.model, params, self.policy, cfg,
                             device=dev, step_cache=self._serve_steps,
                             plan_store=self.store)
        self._engines.add(engine)
        return engine

    # -- raw-graph path (prototyping / quickstart) -------------------------
    def plan(self, local_batch: Optional[int] = None, phase: str = "train",
             **ctx_overrides):
        """Record (and cache) the execution plan the policy chooses for a
        context — introspection for the Fig. 6/7 workflow."""
        if self.graph is None:
            raise TypeError("Program.plan is the raw-graph path; LM "
                            "programs plan per step builder")
        if local_batch is None:
            local_batch = self._graph_batch()
        info = ScheduleContext(local_batch=local_batch,
                               global_batch=local_batch, phase=phase,
                               **ctx_overrides)
        _, _, plan = self._graph_program(info)
        return plan

    def __call__(self, params, inputs: dict) -> dict:
        """Raw-graph execution: resolve the context from the concrete
        inputs, record and lower the plan once per shape bucket (through
        the program's PlanStore), and run it.

        The run goes through ``LoweredPlan.__call__`` as every lowered
        plan does: on CUDA tensors over the per-resource streams of
        ``core/streams.py`` with the kernels, on the CPU in order with
        their plain versions; a kernel that fails on a CUDA input raises.
        It is not captured as a CUDA Graph: the caller owns ``params``
        and ``inputs``, whose storages change from call to call."""
        if self.graph is None:
            raise TypeError("this Program wraps an LM; build a step with "
                            "train_step()/prefill()/decode_tiers()")
        b = self._graph_batch(inputs)
        info = ScheduleContext(local_batch=b, global_batch=b, phase="train")
        _, realizer, _ = self._graph_program(info)
        return realizer(params, inputs)

    def _graph_batch(self, inputs: Optional[dict] = None) -> int:
        g = self.graph
        for name, tid in sorted(g.inputs.items()):
            ref = g.tensors[tid]
            if ref.batch_dim is None:
                continue
            shape = (inputs[name].shape if inputs is not None
                     else ref.shape)
            return int(shape[ref.batch_dim])
        return 0

    def _graph_program(self, info: ScheduleContext):
        from .core.partition import partition
        key = (info.local_batch, info.phase)
        hit = self._graph_cache.get(key)
        if hit is not None:
            return hit
        sched = resolve_strategy(self.policy, info, graph=self.graph)
        g = self.graph
        # the policy's rule union, not the branch's rules (as
        # build_forward): every bucket of one program sees one graph
        rules = self.policy.partition_rules()
        if rules:
            g = partition(g, rules, default_depth=2)
        plan = record_plan(g, sched, info)
        salt = f"graph|{info.phase}|{strategy_salt(self.policy)}"
        realizer = Realizer(g, plan, plan_cache=self.store, plan_salt=salt)
        if self.verify_mode != "off":
            from .core.verify import enforce, verify as run_verify
            report = run_verify(g, plan, lowered=realizer.lowered,
                                lint=True)
            self._verify_reports.append(
                (f"graph/{info.phase}/b{info.local_batch}", report))
            enforce(report, self.verify_mode, what="graph plan")
        self._graph_cache[key] = (g, realizer, plan)
        self.checkpoint()
        return self._graph_cache[key]
