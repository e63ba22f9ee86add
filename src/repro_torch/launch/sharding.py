"""Global input/param shardings for a mesh, by plain slicing.

The port of ``src/repro/launch/sharding.py``.  Everything the model
knows locally (per-shard shapes from ``MeshInfo``) is lifted here to
global ``TensorSpec``s and *placements*: a placement is a tuple with one
entry per tensor dim, the mesh axes that dim is split over, major first
(the JAX package's ``PartitionSpec``).  A rank's shard of a dim split
over axes ``(a, b)`` is chunk ``i_a * n_b + i_b`` of ``n_a * n_b``
equal chunks, where ``i_x`` is the rank's coordinate on axis ``x`` — the
addressable shard JAX's ``NamedSharding`` gives the device at the same
mesh coordinate.

  * params: ``model.param_pspecs(segs)`` tuples -> placements
  * batch inputs: batch dim split over ('pod','data'); sequence dim of
    SP-sharded inputs ('vis') over 'model'
  * decode caches: batch dim over the data axes, head/channel dim over
    'model' per ``model.decode_cache_layout()``
  * when global_batch < dp_total the batch is replicated over the data
    axes (the long_500k single-request case) — each data row redundantly
    computes the same step.
"""
from __future__ import annotations

from ..core.module import TensorSpec
from ..dist import collectives as col
from ..tree import tree_map
from .mesh import mesh_coordinate, mesh_shape_dict


def _entry(e) -> tuple:
    if e is None or e == ():
        return ()
    if isinstance(e, str):
        return (e,)
    return tuple(e)


def spec_to_placements(spec) -> tuple:
    """A param's partition-spec tuple -> its placement (one tuple of axis
    names per dim; ``()`` replicated)."""
    if spec is None:
        return ()
    return tuple(_entry(e) for e in spec)


def param_placements(model, segs) -> dict:
    """Tree of placements matching the (stacked) param tree."""
    return tree_map(spec_to_placements, model.param_pspecs(segs))


def global_param_specs(model, segs, mesh):
    """(global ``TensorSpec`` tree, placement tree) of the params.
    ``Param.global_shape`` (declared at construction from the MeshInfo)
    is the global view; ``mesh`` is only checked against the model's."""
    sizes = mesh_shape_dict(mesh)
    m = model.mesh
    want = {"model": m.tp, "data": m.dp, "pod": m.pods}
    for axis, n in sizes.items():
        if want.get(axis, 1) != n:
            raise ValueError(f"mesh axis {axis!r} has {n} ranks; the model "
                             f"was built for {want.get(axis, 1)}")
    return model.param_shapes(segs, global_=True), \
        param_placements(model, segs)


def _chunk(placement, dim: int, sizes: dict, coord: dict):
    """(index, count) of this rank's chunk of ``dim``."""
    axes = placement[dim] if dim < len(placement) else ()
    idx, count = 0, 1
    for a in axes:
        n = sizes.get(a, 1)
        idx, count = idx * n + coord.get(a, 0), count * n
    return idx, count


def shard(tensor, placement, mesh, coord=None):
    """This rank's shard of a global ``tensor``: a contiguous copy (the
    tensor itself where nothing is split).  ``mesh`` is a ``DeviceMesh``
    or an axis -> size dict; ``coord`` (axis -> index) defaults to this
    rank's coordinate on a ``DeviceMesh``."""
    sizes = mesh_shape_dict(mesh)
    if coord is None:
        coord = mesh_coordinate(mesh)
    out = tensor
    for dim in range(tensor.ndim):
        idx, count = _chunk(placement, dim, sizes, coord)
        if count == 1:
            continue
        n = tensor.shape[dim]
        if n % count:
            raise ValueError(f"dim {dim} of {tuple(tensor.shape)} does not "
                             f"split into {count} shards")
        out = out.narrow(dim, idx * (n // count), n // count)
    return out if out is tensor else out.contiguous()


def shard_tree(global_tree, placements, mesh, coord=None):
    """This rank's local tensors of a global tree (see ``shard``)."""
    return tree_map(lambda t, p: shard(t, p, mesh, coord), global_tree,
                    _match(placements, global_tree))


def _match(placements, tree):
    """``placements`` restricted to ``tree``'s keys (a leaf the
    placement tree lacks is replicated)."""
    if isinstance(tree, dict):
        sub = placements if isinstance(placements, dict) else {}
        return {k: _match(sub.get(k, ()), v) for k, v in tree.items()}
    return placements if isinstance(placements, tuple) else ()


def unshard(local, placement):
    """The global tensor from every rank's ``local`` shard: all-gathers
    over the bound axes of each split dim, minor axis first."""
    out = local
    for dim, axes in enumerate(placement):
        for a in reversed(axes):
            out = col.all_gather(out, a, dim=dim)
    return out


def unshard_tree(local_tree, placements):
    """Inverse of ``shard_tree`` (a collective: every rank calls it)."""
    return tree_map(unshard, local_tree, _match(placements, local_tree))


def fsdp_gathered_tree(tree, model, phase: str = "prefill") -> dict:
    """A global param tree of the no-FSDP or resident decode layout under
    the keys of ``model``'s gathered FSDP layout (``MeshInfo(fsdp=True)``):
    a gathered ``ShardedLinear``'s weight moves from ``lin`` to ``gather``,
    a zero3 ``ExpertFFN``'s ``gemm`` weights to ``g1`` / ``g3`` / ``g2``.
    The two layouts key their weights apart, so their ``init_params``
    draw different values; this carries one tree to the other, sharing
    its tensors, for ``shard_tree`` to cut with the gathered model's
    placements (on one rank the tree is its own shard)."""
    from ..models.layers import ShardedLinear
    from ..models.moe import ExpertFFN

    def go(t, mod):
        if isinstance(mod, ShardedLinear) and mod.mode == "gather":
            return {"gather": t["lin"]}
        if isinstance(mod, ExpertFFN) and mod.mode == "zero3":
            g = t["gemm"]
            return {"g1": {"w": g["w1"]}, "g3": {"w": g["w3"]},
                    "g2": {"w": g["w2"]}}
        kids = mod._children
        return {k: go(v, kids[k]) if k in kids else v for k, v in t.items()}

    segs, _ = model.build_segments(phase, 2, 2 * model.mesh.tp
                                   if model.cfg.seq_parallel else 2,
                                   s_max=4)
    mods = {seg.name: seg.module for seg in segs}
    return {k: go(v, mods[k]) if k in mods else v for k, v in tree.items()}


# special per-input extra sharding: name -> (dim, axis)
EXTRA_INPUT_SHARD = {"vis": (1, "model")}


def global_batch_specs(model, phase: str, seq_len: int, global_batch: int,
                       mesh, s_max: int = 0):
    """Global ``TensorSpec`` and placement dicts for the step's batch
    inputs (+ decode caches).  Returns (specs, placements, B_loc,
    replicated)."""
    axis = mesh_shape_dict(mesh)
    dp_total = axis.get("data", 1) * axis.get("pod", 1)
    tp = axis.get("model", 1)
    dp = model.mesh.dp_axes
    replicated = global_batch < dp_total
    B_loc = max(1, global_batch // dp_total)

    # decode steps are single-token here (``seq_len`` is the cache depth
    # s_max, not the step width — chunked decode is a serve-engine path)
    step_len = 1 if phase == "decode" else seq_len
    binputs = model.batch_inputs(phase, B_loc, step_len, s_max=s_max)
    specs, places = {}, {}
    for name, (spec, bd) in binputs.items():
        gshape = list(spec.shape)
        dims = [()] * len(gshape)
        if bd is not None and not replicated:
            gshape[bd] *= dp_total
            dims[bd] = dp
        if name in EXTRA_INPUT_SHARD:
            d, ax = EXTRA_INPUT_SHARD[name]
            gshape[d] *= axis.get(ax, 1)
            dims[d] = (ax,)
        specs[name] = TensorSpec(tuple(gshape), spec.dtype)
        places[name] = tuple(dims)
    if phase == "decode":
        layout = model.decode_cache_layout()
        for name, spec in model.decode_cache_env(B_loc, s_max).items():
            bd, md = layout[name]
            md %= len(spec.shape)
            gshape = list(spec.shape)
            dims = [()] * len(gshape)
            if not replicated:
                gshape[bd] *= dp_total
                dims[bd] = dp
            gshape[md] *= tp
            dims[md] = ("model",)
            specs[name] = TensorSpec(tuple(gshape), spec.dtype)
            places[name] = tuple(dims)
    return specs, places, B_loc, replicated

