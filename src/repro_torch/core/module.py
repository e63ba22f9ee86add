"""Module system + symbolic tracer — DynaFlow's graph-capture frontend.

PyTorch DynaFlow captures the operator graph with TorchDynamo.  This port
keeps the JAX package's explicit tracer instead: a symbolic trace over a
``Module`` tree.  Composite modules keep the familiar sequential
``forward``; leaf ``Op`` modules are the *logical operators* (attention,
norm, matmul, collective) that become schedulable ``OpNode``s.  Model code
stays a plain sequential program — the physical execution order is
decided later by the scheduler, which is the paper's core decoupling.

Two execution modes share the same model code:
  * trace mode  — ``trace(model, ...)`` records an ``OpGraph``; output
    shapes come from running each op's kernel on tensors on the ``meta``
    device, so nothing is allocated or computed.
  * direct mode — ``model.apply(params, *xs)`` runs eagerly (reference
    semantics for tests).

Parameters are plain nested dicts of tensors; ``Module.init`` draws them
from ``torch.Generator``s seeded per parameter path, on an explicit
device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import zlib
from typing import Callable, Optional, Sequence

import torch

from ..device import resolve_device
from .graph import OpGraph, TensorRef


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a tensor that is not materialized (the
    counterpart of ``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype

    def meta(self) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def fold_seed(seed: int, name: str) -> int:
    """Derive a child seed from ``seed`` and a name (stable across runs)."""
    return zlib.crc32(name.encode(), seed & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _normal_init(gen, shape, dtype, device):
    fan_in = shape[0] if shape else 1
    scale = 1.0 / max(1.0, float(fan_in)) ** 0.5
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (w * scale).to(dtype)


@dataclasses.dataclass
class Param:
    """Declared parameter of an Op: shape/dtype/init + sharding metadata.

    ``pspec`` names mesh axes per dimension (shapes declared here are the
    *per-shard local* shapes; ``global_shape`` is the unsharded view).
    ``init(gen, shape, dtype, device)`` draws the tensor from ``gen``.
    """

    shape: tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: Optional[Callable] = None
    pspec: tuple = ()
    global_shape: Optional[tuple[int, ...]] = None

    def initializer(self):
        return self.init if self.init is not None else _normal_init


# ---------------------------------------------------------------------------
# trace context
# ---------------------------------------------------------------------------


class _TraceCtx:
    def __init__(self, graph: OpGraph):
        self.graph = graph
        self.scope: list[str] = []
        self.scope_cls: list[type] = []

    def scoped_name(self, leaf: str) -> str:
        return "/".join(self.scope + [leaf])


_TRACE: list[_TraceCtx] = []
_PARAMS: list[dict] = []


def _cur_trace() -> Optional[_TraceCtx]:
    return _TRACE[-1] if _TRACE else None


@contextlib.contextmanager
def mark(tag: str):
    """Paper Fig. 5 ``dynaflow.mark``: wrap a code block as a partition
    boundary.  During trace, ops recorded inside get scope entry ``#tag``
    which partition rules can target; in direct mode it is a no-op."""
    tc = _cur_trace()
    if tc is None:
        yield
        return
    tc.scope.append("#" + tag)
    tc.scope_cls.append(type(None))
    try:
        yield
    finally:
        tc.scope.pop()
        tc.scope_cls.pop()


def _leaves(out) -> list:
    """Flatten an op's output (tensor, spec, tuple/list, dict by sorted
    key) into its leaves, in the order the JAX package's pytrees use."""
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    if isinstance(out, dict):
        return [leaf for k in sorted(out) for leaf in _leaves(out[k])]
    return [out]


def _rebuild(out, leaves: list):
    """Inverse of ``_leaves``: the structure of ``out`` over ``leaves``."""
    it = iter(leaves)

    def go(o):
        if isinstance(o, (tuple, list)):
            return type(o)(go(x) for x in o)
        if isinstance(o, dict):
            return {k: go(o[k]) for k in sorted(o)}
        return next(it)

    return go(out)


def _spec_of(t) -> TensorSpec:
    return TensorSpec(tuple(int(d) for d in t.shape), t.dtype)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class Module:
    """Composite module: ``forward`` composes child modules / Ops."""

    def __init__(self):
        object.__setattr__(self, "_children", {})
        object.__setattr__(self, "_params", {})

    def __setattr__(self, k, v):
        if isinstance(v, Module):
            self._children[k] = v
        elif isinstance(v, Param):
            self._params[k] = v
        object.__setattr__(self, k, v)

    # -- params -----------------------------------------------------------
    def init(self, seed: int, device=None, global_: bool = False) -> dict:
        """Build the nested param dict mirroring the module tree, on
        ``device`` (default: the GPU).

        Seeds are folded in from the child *name* (stable across phases:
        prefill/decode variants of a layer that share param names get
        identical weights).  ``global_=True`` draws the *global*
        (unsharded) tensors declared by ``Param.global_shape``.
        """
        device = resolve_device(device)
        out = {}
        items = list(self._params.items()) + list(self._children.items())
        for name, item in items:
            s = fold_seed(seed, name)
            if isinstance(item, Param):
                shape = (item.global_shape if global_ and item.global_shape
                         else item.shape)
                gen = torch.Generator(device=device).manual_seed(s)
                out[name] = item.initializer()(gen, tuple(shape),
                                               item.dtype, device)
            else:
                sub = item.init(s, device=device, global_=global_)
                if sub:
                    out[name] = sub
        return out

    def global_param_shapes(self) -> dict:
        """TensorSpecs of the global param tensors (dry-run stand-ins)."""
        out = {}
        for name, p in self._params.items():
            out[name] = TensorSpec(tuple(p.global_shape or p.shape), p.dtype)
        for name, c in self._children.items():
            sub = c.global_param_shapes()
            if sub:
                out[name] = sub
        return out

    def param_shapes(self) -> dict:
        out = {}
        for name, p in self._params.items():
            out[name] = TensorSpec(tuple(p.shape), p.dtype)
        for name, c in self._children.items():
            sub = c.param_shapes()
            if sub:
                out[name] = sub
        return out

    def param_pspecs(self) -> dict:
        """Nested dict of partition-spec tuples (the mesh axes each param
        is sharded over)."""
        out = {}
        for name, p in self._params.items():
            out[name] = p.pspec
        for name, c in self._children.items():
            sub = c.param_pspecs()
            if sub:
                out[name] = sub
        return out

    # -- execution ----------------------------------------------------------
    def forward(self, *args, **kw):
        raise NotImplementedError(type(self).__name__)

    def __call__(self, *args, **kw):
        tc = _cur_trace()
        if tc is None:
            return self.forward(*args, **kw)
        tc.scope.append(getattr(self, "_scope_name", type(self).__name__))
        tc.scope_cls.append(type(self))
        try:
            return self.forward(*args, **kw)
        finally:
            tc.scope.pop()
            tc.scope_cls.pop()

    def named(self, name: str):
        object.__setattr__(self, "_scope_name", name)
        return self

    def apply(self, params, *args, **kw):
        """Direct (eager) execution with a bound param tree."""
        _assign_paths(self)
        _PARAMS.append(params if params is not None else {})
        try:
            return self(*args, **kw)
        finally:
            _PARAMS.pop()


class Op(Module):
    """Leaf logical operator; becomes one ``OpNode`` when traced.

    Subclasses implement ``kernel(p, *inputs)`` in PyTorch against the
    *local shard*.  ``p`` is a dict of this op's own params (or ``{}``).
    """

    resource = "compute"
    out_batch_dim: Optional[int] = 0   # batch dim of outputs (None = not batched)

    def kernel(self, p: dict, *inputs):
        raise NotImplementedError(type(self).__name__)

    def share_params(self, path: tuple[str, ...]):
        """Use the params living at absolute ``path`` (weight tying)."""
        object.__setattr__(self, "_shared_path", tuple(path))
        return self

    def infer_out(self, in_shapes: Sequence[TensorSpec]):
        """Output specs, by running ``kernel`` on ``meta`` tensors.  Ops
        whose kernel cannot run on shapes alone override this."""
        p = {n: torch.empty(pp.shape, dtype=pp.dtype, device="meta")
             for n, pp in self._params.items()}
        out = self.kernel(p, *[s.meta() for s in in_shapes])
        return _rebuild(out, [_spec_of(t) for t in _leaves(out)])

    def flops_estimate(self, in_shapes) -> float:
        return 0.0

    def bytes_estimate(self, in_shapes, out_shapes) -> float:
        tot = 0
        for s in list(in_shapes) + list(out_shapes):
            size = 1
            for d in s.shape:
                size *= d
            tot += size * s.dtype.itemsize
        for p in self._params.values():
            size = 1
            for d in p.shape:
                size *= d
            tot += size * p.dtype.itemsize
        return float(tot)

    def __call__(self, *args, **kw):
        tc = _cur_trace()
        if tc is None:
            # Direct mode: resolve params by path captured at init-walk time.
            path = getattr(self, "_shared_path", None) or self._abs_path()
            p = _resolve_params(_PARAMS[-1] if _PARAMS else {}, path) or {}
            return self.kernel(p, *args)
        # ---- traced path: record an OpNode ----
        name = tc.scoped_name(getattr(self, "_scope_name", type(self).__name__))
        in_refs = []
        for a in args:
            if not isinstance(a, TensorRef):
                raise TypeError(
                    f"Op {name} received non-TensorRef input {type(a)}; wrap "
                    "constants as graph inputs or params")
            in_refs.append(a)
        in_shapes = [TensorSpec(r.shape, r.dtype) for r in in_refs]
        out = self.infer_out(in_shapes)
        flat = _leaves(out)
        obds = getattr(self, "out_batch_dims", None)  # per-output override
        out_refs = [tc.graph.new_tensor(
                        o.shape, o.dtype,
                        obds[i] if obds is not None else self.out_batch_dim,
                        name=f"{name}:o{i}")
                    for i, o in enumerate(flat)]
        path = getattr(self, "_shared_path", None) or self._abs_path()
        op_self = self

        def fn(params, *inputs):
            return tuple(_leaves(op_self.kernel(params or {}, *inputs)))

        has_params = bool(self._params or self._children
                          or getattr(self, "_shared_path", None))
        cls_tags = tuple(f"cls:{i}:{c.__name__}"
                         for i, c in enumerate(tc.scope_cls))
        pbytes = 0
        for pp in self._params.values():
            size = 1
            for d in pp.shape:
                size *= d
            pbytes += size * pp.dtype.itemsize
        tc.graph.add_node(
            name, fn, in_refs, out_refs,
            param_paths=(path,) if has_params else (),
            resource=self.resource, scope=tuple(tc.scope) + (name.split("/")[-1],),
            tags=cls_tags + (f"cls:{len(tc.scope)}:{type(self).__name__}",),
            flops=self.flops_estimate(in_shapes),
            bytes_moved=self.bytes_estimate(in_shapes, flat),
            param_bytes=float(pbytes))
        return _rebuild(out, out_refs)

    def _abs_path(self) -> tuple[str, ...]:
        return getattr(self, "_abs_path_", ())


def _resolve_params(tree, path):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree


def _assign_paths(mod: Module, prefix: tuple[str, ...] = ()):
    """Record each submodule's absolute path into the param tree."""
    object.__setattr__(mod, "_abs_path_", prefix)
    for name, child in mod._children.items():
        _assign_paths(child, prefix + (name,))


# ---------------------------------------------------------------------------
# tracing entry point
# ---------------------------------------------------------------------------


def trace(model: Module, inputs: dict[str, TensorSpec],
          batch_dims: Optional[dict[str, Optional[int]]] = None,
          out_names: Optional[Sequence[str]] = None) -> OpGraph:
    """Symbolically run ``model`` on named inputs, recording the OpGraph.

    ``inputs``: name -> TensorSpec of the *local shard*.
    ``batch_dims``: name -> batch dim (default 0; None = unsplittable).
    """
    _assign_paths(model)
    g = OpGraph()
    tc = _TraceCtx(g)
    refs = {}
    for name, spec in inputs.items():
        bd = (batch_dims or {}).get(name, 0)
        refs[name] = g.add_input(name, spec.shape, spec.dtype, batch_dim=bd)
    _TRACE.append(tc)
    try:
        out = model(**refs) if _wants_kwargs(model) else model(*refs.values())
    finally:
        _TRACE.pop()
    if isinstance(out, TensorRef):
        out = {"out": out}
    elif isinstance(out, (tuple, list)):
        out = {(out_names[i] if out_names else f"out{i}"): o
               for i, o in enumerate(out)}
    for name, ref in out.items():
        g.mark_output(name, ref)
    g.validate()
    return g


def _wants_kwargs(model) -> bool:
    import inspect
    try:
        sig = inspect.signature(model.forward)
        return any(p.kind == p.KEYWORD_ONLY for p in sig.parameters.values())
    except (TypeError, ValueError):
        return False


# ---------------------------------------------------------------------------
# convenience leaf op: wrap a pure function
# ---------------------------------------------------------------------------


class FnOp(Op):
    """Wrap a pure ``fn(*inputs)`` (no params) as a schedulable Op."""

    def __init__(self, fn: Callable, name: str, resource: str = "compute",
                 out_batch_dim: Optional[int] = 0, flops_fn=None):
        super().__init__()
        self._fn = fn
        self.resource = resource
        self.out_batch_dim = out_batch_dim
        self._flops_fn = flops_fn
        self.named(name)

    def kernel(self, p, *inputs):
        return self._fn(*inputs)

    def flops_estimate(self, in_shapes):
        return self._flops_fn(in_shapes) if self._flops_fn else 0.0
