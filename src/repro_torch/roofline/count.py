"""Count a step's FLOPs, HBM bytes, collective payloads and live memory by
running it once on the ``meta`` device: the port's counterpart of
``src/repro/roofline/hlo.py``, which reads them from XLA's compiled HLO.
The port has no HLO, so the counter is a ``TorchDispatchMode`` that sees
every aten op the step dispatches; ``meta`` tensors carry shapes and
dtypes, so nothing is allocated and nothing computed.

  * FLOPs: every matmul-family op (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``, ``mv``, ``dot``; ``einsum``, ``matmul`` and ``linear``
    reach the dispatcher as these) counts 2 · result elements ·
    contraction, ``hlo.py``'s rule for ``dot``.  Elementwise ops count
    none, as there.
  * HBM bytes: every op that is not a view (``view``, ``reshape``,
    ``expand``, ``as_strided``, ``alias``, ``detach``, ``_unsafe_view``,
    ...) is charged its operand bytes plus its result bytes.  Eager
    PyTorch runs each op as its own kernel, so that is what the card
    moves; XLA fuses, and ``hlo.py`` charges only at a fusion's boundary.
    An in-place update that writes without reading its destination
    (``copy_`` into a narrow view, ``index_copy_``, ``index_put_``,
    ``scatter_``) is charged twice the update, not the whole buffer
    (``hlo.py``'s rule for a dynamic-update-slice); ``empty`` and its kin
    allocate and move nothing.
  * Hand-written kernels: on ``meta`` each wrapper takes its meta route
    (``kernels.meta_route``) and is charged its kernel's count
    (``kernels/cost.py``): ``dot_flops`` and the bytes at its boundary,
    the ops it dispatches to make its results uncounted.  Their plain
    versions never run: at ``prefill_32k`` they would make (S, S) score
    tensors that the card never holds.
  * Collectives: over an axis bound to a ``dist.collectives.Recorder``,
    each records its result's bytes on this rank under its kind and adds
    one to ``n_collectives``; its backward records the same way.
  * Loops: the port's layers run as Python loops, so each layer's ops are
    counted as they run; ``hlo.py``'s trip-count machinery for
    ``while`` bodies has no counterpart.
  * Live memory: the peak bytes of the storages the run creates, alive at
    once (``peak_bytes``); views add nothing, the inputs are not counted.

``substitute_scopes``: the JAX package's ``--attn-sub`` picks between
XLA's einsum traffic and the Pallas kernel's for the scopes it names.
The port always runs its attention kernels, so they are always charged at
their boundary; with the scopes named (``flashable_attention``,
``flashable_decode``), ``substituted_bytes`` reports under each the
boundary bytes of the kernels it stands for, and it is empty without.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

# matmul-family op -> the index of its left operand, whose last dim is
# the contraction
_MATMULS = {aten.mm: 0, aten.bmm: 0, aten.mv: 0, aten.dot: 0,
            aten.addmm: 1, aten.baddbmm: 1}
# ops whose result aliases their input without the schema saying so
_VIEWS = {aten._unsafe_view, aten.lift_fresh, aten.alias, aten.detach}
# allocate, move nothing
_ALLOCS = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
           aten.new_empty_strided}
# in-place updates of some rows of a buffer, charged twice the update
# (``hlo.py``'s rule for a dynamic-update-slice): op -> the index of the
# update operand (a scalar ``scatter_`` value: the index's elements)
_UPDATES = {aten.copy_: 1, aten.index_copy_: 3, aten.index_put_: 2,
            aten._index_put_impl_: 2, aten.scatter_: 3, aten.scatter_add_: 3,
            aten.index_add_: 3}
# the kernels the JAX package's named scopes stand for
SCOPE_KERNELS = {"flashable_attention": ("flash_attention",
                                         "flash_attention_bwd"),
                 "flashable_decode": ("decode_attention",)}


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def storages(tree) -> dict:
    """id -> bytes of the distinct storages of the tensors in ``tree``."""
    return {id(t.untyped_storage()): t.untyped_storage().nbytes()
            for t in _tensors(tree)}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _matmul_flops(func, args, out) -> float:
    return 2.0 * out.numel() * args[_MATMULS[func]].shape[-1]


def _update_bytes(func, args, kwargs) -> float:
    """Twice the update an in-place write carries (``copy_``: the source
    read and the destination written, in their own dtypes)."""
    i = _UPDATES[func]
    dst = args[0]
    if func is aten.copy_:                 # the destination is the update
        return float(_nbytes(args[1]) + _nbytes(dst))
    upd = args[i] if i < len(args) else kwargs.get("src", kwargs.get(
        "source", kwargs.get("values")))
    if isinstance(upd, torch.Tensor):
        n = upd.numel()
        if func in (aten.index_put_, aten._index_put_impl_):
            idx = [t for t in args[1] if t is not None]
            if idx:
                n = max(n, torch.broadcast_shapes(
                    *(t.shape for t in idx)).numel())
    else:                                  # scatter_(dim, index, value)
        n = args[2].numel()
    return 2.0 * n * dst.element_size()


class Counter(TorchDispatchMode):
    """The dispatch mode that counts (see the module docstring).  Use it
    as a context around one run of a step; ``result()`` gives ``analyze``'s
    dict.  While it is active it is ``Counter.current``, which the
    kernels' meta routes and the collectives' recorders charge; counters
    do not nest.
    """

    current: "Counter | None" = None

    def __init__(self, substitute_scopes=()):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collectives: dict = {}
        self.n_collectives = 0
        self.kernels: dict = {}           # name -> [launches, flops, bytes]
        # products the JAX package's dots count and the kernels skip (the
        # masked half of causal attention, an SSD chunk's upper triangle),
        # inside ``flops``
        self.masked_flops = 0.0
        self.scopes = tuple(substitute_scopes)
        self.live = 0
        self.peak = 0
        self._known: set = set()          # ids of storages already seen
        self._refs: dict = {}             # id -> weakref of a new storage
        self._in_kernel = 0

    # -- the meters' interface (kernels.meta_route, collectives.Recorder) --
    def kernel(self, name: str, cost):
        self.flops += cost.dot_flops
        self.hbm_bytes += cost.nbytes
        self.masked_flops += max(0.0, cost.dot_flops - cost.flops)
        k = self.kernels.setdefault(name, [0, 0.0, 0.0])
        k[0] += 1
        k[1] += cost.dot_flops
        k[2] += cost.nbytes
        return _Uncounted(self)

    def collective(self, kind: str, nbytes: int):
        self.collectives[kind] = self.collectives.get(kind, 0) + nbytes
        self.n_collectives += 1

    # -- live storages ------------------------------------------------------
    def mark_inputs(self, *trees):
        """Storages that exist before the run: never counted as new."""
        for t in _tensors(trees):
            self._known.add(id(t.untyped_storage()))

    def _freed(self, key, nbytes):
        self._refs.pop(key, None)
        self._known.discard(key)
        self.live -= nbytes

    def _track(self, out):
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._known:
                continue
            n = st.nbytes()
            self._known.add(key)
            self._refs[key] = weakref.ref(
                st, lambda _r, key=key, n=n: self._freed(key, n))
            self.live += n
            self.peak = max(self.peak, self.live)

    # -- dispatch -------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        aliased = func.is_view or packet in _VIEWS
        if not aliased:
            self._track(out)
        if self._in_kernel or aliased or packet in _ALLOCS:
            return out
        if packet in _MATMULS:
            self.flops += _matmul_flops(packet, args, out)
        if packet in _UPDATES:
            self.hbm_bytes += _update_bytes(packet, args, kwargs)
            return out
        outs = list(_tensors(out))
        if not outs and not func._schema.is_mutable:
            return out                      # metadata: moves nothing
        self.hbm_bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        if func._schema.is_mutable:
            # an in-place op returns its destination: charged as written
            # (its read is among the operands)
            mutated = [a for a, s in zip(args, func._schema.arguments)
                       if isinstance(a, torch.Tensor) and s.alias_info
                       and s.alias_info.is_write]
            self.hbm_bytes += sum(_nbytes(t) for t in mutated)
        else:
            self.hbm_bytes += sum(_nbytes(t) for t in outs)
        return out

    def __enter__(self):
        if Counter.current is not None:
            raise RuntimeError("a Counter is already counting")
        Counter.current = self
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            Counter.current = None

    def result(self) -> dict:
        coll = dict(self.collectives)
        coll["total"] = sum(coll.values())
        sub = {sc: sum(self.kernels.get(k, (0, 0.0, 0.0))[2]
                       for k in SCOPE_KERNELS.get(sc, ()))
               for sc in self.scopes}
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collectives": coll, "n_collectives": self.n_collectives,
                "substituted_bytes": sub, "peak_bytes": self.peak}


class _Uncounted:
    """Inside a kernel's meta route: its ops make its results, which are
    tracked as live storages, and are not counted as work."""

    def __init__(self, counter: Counter):
        self.counter = counter

    def __enter__(self):
        self.counter._in_kernel += 1

    def __exit__(self, *exc):
        self.counter._in_kernel -= 1


def analyze(fn, *args, substitute_scopes: tuple = ()) -> dict:
    """``fn(*args)`` once under a :class:`Counter`: {'flops', 'hbm_bytes',
    'collectives': {kind: bytes, 'total'}, 'n_collectives',
    'substituted_bytes', 'peak_bytes'}, this rank's.  ``args`` are the
    run's inputs (their storages are not counted as live memory it
    creates); give it ``meta`` tensors, or it computes what it counts."""
    counter = Counter(substitute_scopes)
    counter.mark_inputs(args)
    with counter:
        fn(*args)
    return counter.result()
