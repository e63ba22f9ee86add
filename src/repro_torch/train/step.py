"""Train-step builder: DynaFlow forward -> loss -> grads -> AdamW (the port
of ``src/repro/train/step.py``).

The forward is the port's lowered forward (``build_forward``: every
segment's plan realized through the slot IR, the kernels on a CUDA
tensor), and the reference's ``jax.value_and_grad`` becomes
``torch.autograd.grad`` over it: the params are the leaves of autograd.
Each call takes fresh leaves that share the params' storage
(``detach().requires_grad_()``), so the caller's tensors never carry a
graph.

Where the JAX package's step is pure, the port's updates in place: the
params, AdamW's m and v (or their int8 codes and scales), its count and
the error-feedback residuals are written into the tensors passed in, and
``train_step`` returns the same objects.  A caller that needs the old
values keeps a copy.

The reference compiles its whole step as one program (``jax.jit`` with
donation); the port's form of that on the card is one CUDA Graph
(``TrainStep``): forward, loss, backward, grad reduction, grad norm and
AdamW, captured once per set of param and optimizer storages and
replayed every later step.  On the CPU, and under
``TrainStepConfig(lowered=False)``, the step runs eagerly.

Gradient reduction rules, as the reference's (collectives through
``repro_torch.dist.collectives``, the identity without a bound axis):

  * grads are partial over the data axes (different samples) -> psum over
    ('pod','data') — optionally int8-compressed with error feedback
    (``compressed_psum`` quantizes even unbound, so ``compress_grads``
    changes the gradients on one GPU too);
  * under sequence-parallel training, grads of params *replicated* over
    'model' are partial over the sequence shards -> psum over 'model';
  * params sharded over 'data' (FSDP) skip the data psum.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..core.capture import GraphStep, Staged
from ..core.plan_store import checkpoint_plan_store, resolve_plan_store
from ..core.scheduler import ScheduleContext
from ..dist import collectives as col
from ..models.base import build_forward
from ..optim import AdamWConfig, adamw_init, adamw_update
from ..optim.schedules import cosine_schedule
from ..tree import leaves, leaves_with_paths, tree_map, unflatten


@dataclasses.dataclass
class TrainStepConfig:
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    remat: bool = True
    remat_policy: str = "full"     # full | dots
    grad_accum: int = 1
    compress_grads: bool = False     # int8 DP all-reduce + error feedback
    warmup: int = 100
    total_steps: int = 10000
    lowered: bool = True             # slot-based lowered plan replay


def _flat_axes(pspec) -> set:
    out = set()
    for entry in pspec:
        if isinstance(entry, str):
            out.add(entry)
        elif entry:
            out.update(entry)
    return out


def _spec_leaves(pspecs, grads) -> list:
    """The partition spec of each grad leaf, in leaf order (a leaf the
    spec tree lacks is replicated)."""
    out = []
    for path, _ in leaves_with_paths(grads):
        spec = pspecs
        for k in path:
            spec = spec.get(k, ()) if isinstance(spec, dict) else ()
        out.append(spec if isinstance(spec, tuple) else ())
    return out


def reduce_grads(grads, pspecs, mesh_info, sp_train: bool,
                 compress: bool = False, errors=None):
    """Apply the reduction rules above.  Returns (grads, new_errors);
    ``new_errors`` (the residuals ``compressed_psum`` leaves, in each
    grad's dtype) is None unless ``compress``."""
    flat_g = leaves(grads)
    flat_s = _spec_leaves(pspecs, grads)
    flat_e = leaves(errors) if errors is not None else [None] * len(flat_g)
    outs, new_errs = [], []
    for g, spec, err in zip(flat_g, flat_s, flat_e):
        axes = _flat_axes(spec)
        red, new_err = g, err
        for ax in mesh_info.dp_axes:
            if ax in axes:
                continue  # FSDP leaf: already reduce-scattered on this axis
            if compress and ax == "data":
                red, new_err = col.compressed_psum(red, ax, err)
            else:
                red = col.psum(red, ax)
        if sp_train and "model" not in axes:
            red = col.psum(red, "model")
        outs.append(red)
        if compress:
            new_errs.append(new_err if new_err is not None
                            else torch.zeros_like(g))
    return (unflatten(grads, outs),
            unflatten(grads, new_errs) if compress else None)


def global_grad_norm(grads, pspecs, mesh_info):
    """Global ||g|| under SPMD: per-leaf local sum of squares, psum'd over
    the axes the leaf is *sharded* on (replicated leaves count once), so
    every rank gets the same norm and clips alike."""
    by_axes: dict = {}
    for g, spec in zip(leaves(grads), _spec_leaves(pspecs, grads)):
        axes = tuple(sorted(_flat_axes(spec) & {"data", "model"}))
        by_axes[axes] = by_axes.get(axes, 0.0) + torch.sum(g.float() ** 2)
    total = 0.0
    for axes, sq in by_axes.items():
        for ax in axes:
            sq = col.psum(sq, ax)
        total = total + sq
    return torch.sqrt(torch.as_tensor(total))


def _host_step(step):
    """The step counter on the CPU, where the lr is computed (a CUDA
    ``cos`` differs from the CPU's in the last bit)."""
    return step.detach().cpu() if isinstance(step, torch.Tensor) else step


def _storage_key(params, opt_state) -> tuple:
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                 for t in leaves(params) + leaves(opt_state))


class TrainStep:
    """``step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``: the train step ``_build_train_step`` returns.

    On CUDA tensors (and ``cfg.lowered``) the whole step is one CUDA
    Graph.  The first call for a set of param and optimizer storages runs
    the real step eagerly on the capture stream and then captures it
    (``GraphStep(warm_runs_step=True)``: no copy of the state is made);
    every later call copies the batch into static input buffers, stages
    the lr (computed on the host by ``cosine_schedule`` in f32, as the
    eager step does) into a static device buffer from pinned memory
    (``Staged``), and replays.  Graphs are keyed by every param and optimizer leaf's
    address, shape and dtype, and share one memory pool; a call whose
    tensors live elsewhere captures anew.  ``stats``:
    ``graph_captures``, ``capture_s`` (warm-up and capture),
    ``graph_replays``, ``graph_nbytes`` (the pool's growth across the
    captures).  A replay's metrics are the graph's output tensors (its
    ``lr`` the staged buffer), rewritten by the next call: read or clone
    them first.

    ``eager``: the same step, run op by op (what the graph captures and
    what the CPU runs); ``grads(params, batch)``: one batch's gradients,
    eager, nothing updated; ``forward``, ``strategies``: the ``Forward``
    and the scheduler each segment resolved to."""

    def __init__(self, body: Callable, cfg: "TrainStepConfig", forward,
                 grads: Callable):
        self._body = body
        self.cfg = cfg
        self.forward = forward
        self.strategies = forward.strategies
        self.grads = grads
        self.stats = {"graph_captures": 0, "capture_s": 0.0,
                      "graph_replays": 0, "graph_nbytes": 0}
        self._graphs: dict = {}
        self._batch = self._lr = self._stream = self._pool = None

    def _lr_of(self, step) -> torch.Tensor:
        return cosine_schedule(_host_step(step), self.cfg.warmup,
                               self.cfg.total_steps, self.cfg.optimizer.lr)

    def eager(self, params, opt_state, batch, step):
        dev = leaves(params)[0].device
        return self._body(params, opt_state, batch,
                          self._lr_of(step).to(dev))

    def _graphed(self, dev: torch.device) -> bool:
        return dev.type == "cuda" and self.cfg.lowered

    def __call__(self, params, opt_state, batch, step):
        dev = leaves(params)[0].device
        if not self._graphed(dev):
            return self.eager(params, opt_state, batch, step)
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
            self._pool = torch.cuda.graph_pool_handle()
            self._batch = {k: torch.empty_like(v, device=dev)
                           for k, v in batch.items()}
            self._lr = Staged(1, dev, torch.float32)
        if set(batch) != set(self._batch):
            raise ValueError(f"train step: batch keys {sorted(batch)}, the "
                             f"graph takes {sorted(self._batch)}")
        for k, buf in self._batch.items():
            if batch[k].shape != buf.shape or batch[k].dtype != buf.dtype:
                raise ValueError(
                    f"train step: batch[{k!r}] is {tuple(batch[k].shape)} "
                    f"{batch[k].dtype}, the graph takes {tuple(buf.shape)} "
                    f"{buf.dtype}")
            buf.copy_(batch[k], non_blocking=True)
        lr = self._lr_of(step)
        self._lr.put(lambda a: a.fill(lr.item()), 1)
        key = _storage_key(params, opt_state)
        g = self._graphs.get(key)
        if g is not None:
            self.stats["graph_replays"] += 1
            return params, opt_state, g.replay()

        def run():
            return self._body(params, opt_state, self._batch,
                              self._lr.dev[0])[2]

        first = {}
        g = GraphStep(run, lambda: first.update(run()), stream=self._stream,
                      pool=self._pool, warm_runs_step=True)
        if _storage_key(params, opt_state) != key:
            raise ValueError(
                "train step: the step rebound a param or optimizer leaf, "
                "so its graph would replay into storage nothing writes; "
                "make opt_state with the step's init_opt")
        self._graphs[key] = g
        self.stats["graph_captures"] += 1
        self.stats["capture_s"] += g.capture_s
        self.stats["graph_nbytes"] += g.nbytes
        return params, opt_state, first


def _build_train_step(model, scheduler, B_loc: int, S: int,
                      cfg: TrainStepConfig,
                      info: Optional[ScheduleContext] = None,
                      plan_store=None,
                      plan_store_path: Optional[str] = None,
                      verify: str = "off",
                      verify_sink: Optional[list] = None):
    """Returns (train_step, segments, binputs, init_opt).

    ``train_step`` is a :class:`TrainStep`: ``train_step(params,
    opt_state, batch, step) -> (params, opt_state, metrics)``,
    ``metrics`` 0-d tensors: ``loss``, ``grad_norm`` (before clipping),
    ``lr`` and ``tokens``; one CUDA Graph on the card.  With
    ``grad_accum > 1`` every batch tensor carries a leading micro-batch
    dim; each micro-batch's gradient (of its own mean loss) is summed in
    f32, as the reference's scan does.  ``train_step.grads(params, batch)
    -> (grads, (loss_sum, token_count))``: one batch's gradients, nothing
    updated.
    """
    plan_store = resolve_plan_store(plan_store, plan_store_path)
    segs, binputs = model.build_segments("train", B_loc, S)
    info = info or ScheduleContext(
        local_batch=B_loc, global_batch=B_loc, seq_len=S, phase="train",
        arch=model.cfg.name)
    fwd = build_forward(segs, scheduler, info, lowered=cfg.lowered,
                        verify=verify, plan_cache=plan_store,
                        op_config=model.op_closure_config(),
                        verify_sink=verify_sink, remat=cfg.remat,
                        remat_policy=cfg.remat_policy)
    checkpoint_plan_store(plan_store)
    pspecs = model.param_pspecs(segs)
    sp_train = bool(getattr(model.cfg, "seq_parallel", False))
    mesh_info = model.mesh
    dp_axes = mesh_info.dp_axes

    def one_batch_grads(params, batch):
        """(grads of the batch's mean loss, (loss_sum, token_count))."""
        flat = leaves(params)
        leaf = [p.detach().requires_grad_() for p in flat]
        with torch.enable_grad():
            out = fwd(unflatten(params, leaf), batch)
            local_sum = torch.sum(out["loss_sum"])
            local_cnt = torch.sum(out["token_count"])
            total_cnt = local_cnt.detach()
            for ax in dp_axes:
                total_cnt = col.psum(total_cnt, ax)
            loss = local_sum / torch.clamp_min(total_cnt, 1.0)
            grads = torch.autograd.grad(loss, leaf, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        return (unflatten(params, grads),
                (local_sum.detach(), local_cnt.detach()))

    def body(params, opt_state, batch, lr):
        """The step at a device lr: nothing here copies from the host or
        waits for the device, so a CUDA Graph can capture it."""
        if cfg.grad_accum > 1:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss_sum = cnt = 0.0
            for i in range(cfg.grad_accum):
                g, (ls, c) = one_batch_grads(
                    params, {k: v[i] for k, v in batch.items()})
                grads = tree_map(torch.add, grads, g)
                loss_sum, cnt = loss_sum + ls, cnt + c
        else:
            grads, (loss_sum, cnt) = one_batch_grads(params, batch)
        errors = opt_state.get("grad_errors") if cfg.compress_grads else None
        grads, new_errors = reduce_grads(
            grads, pspecs, mesh_info, sp_train,
            compress=cfg.compress_grads, errors=errors)
        gnorm = global_grad_norm(grads, pspecs, mesh_info)
        params, opt_state, gnorm = adamw_update(
            params, grads, opt_state, cfg.optimizer, lr=lr, gnorm=gnorm)
        if cfg.compress_grads:
            # the residuals take the grads' dtype, as the reference's do;
            # into the state's own tensors where those have it (a graph
            # replays over them: ``init_opt`` makes them so)
            old = opt_state.get("grad_errors")
            if old is not None and all(
                    o.dtype == e.dtype and o.shape == e.shape
                    for o, e in zip(leaves(old), leaves(new_errors))):
                for o, e in zip(leaves(old), leaves(new_errors)):
                    o.copy_(e)
            else:
                opt_state["grad_errors"] = new_errors
        for ax in dp_axes:
            loss_sum = col.psum(loss_sum, ax)
            cnt = col.psum(cnt, ax)
        metrics = {"loss": loss_sum / torch.clamp_min(cnt, 1.0),
                   "grad_norm": gnorm, "lr": lr, "tokens": cnt}
        return params, opt_state, metrics

    def init_opt(params):
        opt = adamw_init(params, cfg.optimizer)
        if cfg.compress_grads:
            # zeros in the grads' dtype (f32 once micro-batches are summed;
            # the reference starts from f32 zeros, and g + 0 rounds to the
            # same value either way), so the residuals stay in place
            opt["grad_errors"] = tree_map(lambda p: torch.zeros(
                p.shape, device=p.device, dtype=torch.float32
                if cfg.grad_accum > 1 else p.dtype), params)
        return opt

    return (TrainStep(body, cfg, fwd, one_batch_grads), segs, binputs,
            init_opt)
