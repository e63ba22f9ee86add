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
from typing import Optional

import torch

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


def _dp_axes(mesh_info) -> tuple:
    return ("pod", "data") if mesh_info.pods > 1 else ("data",)


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
        for ax in _dp_axes(mesh_info):
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


def _build_train_step(model, scheduler, B_loc: int, S: int,
                      cfg: TrainStepConfig,
                      info: Optional[ScheduleContext] = None,
                      plan_store=None,
                      plan_store_path: Optional[str] = None,
                      verify: str = "off",
                      verify_sink: Optional[list] = None):
    """Returns (train_step, segments, binputs, init_opt).

    ``train_step(params, opt_state, batch, step) ->
        (params, opt_state, metrics)``, ``metrics`` 0-d tensors: ``loss``,
    ``grad_norm`` (before clipping), ``lr`` and ``tokens``.  With
    ``grad_accum > 1`` every batch tensor carries a leading micro-batch
    dim; each micro-batch's gradient (of its own mean loss) is summed in
    f32, as the reference's scan does.  ``train_step.strategies``: the
    scheduler each segment resolved to; ``train_step.forward``: the
    ``Forward``; ``train_step.grads(params, batch) -> (grads, (loss_sum,
    token_count))``: one batch's gradients, nothing updated.
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
    dp_axes = _dp_axes(mesh_info)

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

    def train_step(params, opt_state, batch, step):
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
        dev = leaves(params)[0].device
        lr = cosine_schedule(step, cfg.warmup, cfg.total_steps,
                             cfg.optimizer.lr).to(dev)
        gnorm = global_grad_norm(grads, pspecs, mesh_info)
        params, opt_state, gnorm = adamw_update(
            params, grads, opt_state, cfg.optimizer, lr=lr, gnorm=gnorm)
        if cfg.compress_grads:
            # the residuals take the grads' dtype, as the reference's do
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
            opt["grad_errors"] = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
        return opt

    train_step.strategies = fwd.strategies
    train_step.forward = fwd
    train_step.grads = one_batch_grads
    return train_step, segs, binputs, init_opt
