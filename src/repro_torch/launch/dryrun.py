"""Dry run: count every (arch × shape × mesh) cell's step on the ``meta``
device, with no card and no process group (the port of
``src/repro/launch/dryrun.py``).

For each cell the program is compiled at the production mesh's shape —
a :class:`ShapeMesh` of (16, 16) or (2, 16, 16) ranks, rank 0's
coordinate — and its step (``Program.train_step`` / ``prefill`` /
``decode_tiers``, per the shape's kind) runs once on ``meta`` tensors of
rank 0's local shapes under ``roofline.count.Counter``, with each mesh
axis bound to a recording stand-in (``dist.collectives.Recorder``).  The
counter takes the place of XLA's compiled HLO: no memory is allocated and
no kernel launched.  On ``meta`` the train step runs eagerly and the
plans' per-resource streams run in one stream in plan order, as on the
CPU.  The record (the JAX package's keys) goes to
``results/dryrun_torch/<arch>__<shape>__<mesh>[__pallas].json``:

  build_s    building the step: tracing, recording, verifying and
             lowering its plans
  compile_s  the plan lowering inside that build (the PlanStore's lower
             and specialize seconds)
  lower_s    the counted run on ``meta``
  memory     rank 0's ``argument_bytes`` (params, optimizer state, batch
             and caches), ``output_bytes``, ``temp_bytes`` (the peak of
             the storages the run creates, less its new outputs),
             ``alias_bytes`` (outputs that are inputs updated in place:
             the caches, the train step's params and moments) and
             ``peak_per_device`` = argument + output + temp - alias; the
             lowered plans hold what the card's side streams hold until
             each call returns (``core/lowering.py``)
  cost       ``flops`` and ``bytes accessed`` counted
  roofline   ``roofline.model.roofline_terms`` at the ``model`` axis

``flops`` counts every product in full, as the JAX package's dots do:
the masked half of causal attention (and an SSD chunk's upper triangle),
which the kernels skip, is in it, so the compute term and ``t_bound``
charge work the card never does.  ``count_step`` also returns that
skipped work (``masked_flops``); ``chip_smoke.py`` prints the steps'
share of their roofline at both counts.

Usage:
  python -m repro_torch.launch.dryrun --arch chatglm3-6b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--attn-sub]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

from .. import api
from ..configs import get_config, list_archs
from ..configs.base import SHAPES
from ..core.strategies import get_strategy
from ..dist import collectives as col
from ..roofline.count import Counter, storages
from ..roofline.model import roofline_terms
from ..tree import tree_map
from .mesh import make_mesh_info, mesh_coordinate, mesh_shape_dict
from .sharding import shard_tree

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


class ShapeMesh:
    """A mesh's shape alone: its axis names and sizes and rank 0's
    coordinate, all that ``launch/mesh.py`` and ``launch/sharding.py``
    read of a ``DeviceMesh`` to cut rank 0's shards, with no process
    group behind it."""

    def __init__(self, shape, axes):
        self.shape = tuple(int(n) for n in shape)
        self.mesh_dim_names = tuple(axes)
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.mesh_dim_names} differ in length")

    def get_coordinate(self) -> list:
        return [0] * len(self.shape)

    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


def production_mesh(multi_pod: bool = False) -> ShapeMesh:
    """The JAX package's production mesh: (16, 16) over ('data', 'model'),
    or (2, 16, 16) over ('pod', 'data', 'model')."""
    if multi_pod:
        return ShapeMesh((2, 16, 16), ("pod", "data", "model"))
    return ShapeMesh((16, 16), ("data", "model"))


@contextlib.contextmanager
def recording(mesh):
    """Each axis of ``mesh`` bound to a ``Recorder`` at rank 0's index for
    the duration (every collective over it records instead of running);
    what the axes were bound to before is bound again after."""
    coord = mesh_coordinate(mesh)
    sizes = mesh_shape_dict(mesh)
    before = {axis: col.group_of(axis) for axis in sizes}
    for axis, n in sizes.items():
        col.bind_axis(axis, col.Recorder(n, coord[axis]))
    try:
        yield
    finally:
        for axis, group in before.items():
            col.bind_axis(axis, group)


def skip_reason(cfg, shape_name: str):
    if shape_name == "long_500k" and not cfg.subquadratic:
        return ("full-attention arch: 512k dense-KV decode is not "
                "sub-quadratic-capable (DESIGN.md §Arch-applicability)")
    return None


def _meta_local(specs, places, mesh):
    """Rank 0's local ``meta`` tensors of a global spec tree, each in a
    storage of its own (a shard cut along its first dim is a view of the
    global tensor)."""
    local = shard_tree(tree_map(lambda s: s.meta(), specs), places, mesh,
                       mesh_coordinate(mesh))
    return tree_map(lambda t: t.clone() if t.untyped_storage().nbytes()
                    != t.numel() * t.element_size() else t, local)


def step_inputs(step, mesh, train: bool) -> tuple:
    """The step's arguments as rank 0 holds them, on ``meta``: its params
    and batch (caches included) cut from the global specs, AdamW's state
    and the step index for a train step."""
    params = _meta_local(step.in_specs[0], step.in_placements[0], mesh)
    if not train:
        return params, _meta_local(step.in_specs[1], step.in_placements[1],
                                   mesh)
    batch = _meta_local(step.in_specs[2], step.in_placements[2], mesh)
    return params, step.init_opt(params), batch, 0


def count_step(cfg, shape, mesh, *, strategy: str = "dynamic",
               attn_sub: bool = False, remat_policy: str = "full",
               verify: str = "warn") -> dict:
    """Build ``cfg``'s (an ``ArchConfig``) step at ``shape`` (a
    ``ShapeConfig``) on ``mesh`` (a :class:`ShapeMesh`) and run it once on
    ``meta`` under a ``Counter``: ``{"counts": analyze's dict, "memory":
    the record's, "build_s", "compile_s", "lower_s"}``."""
    train = shape.kind == "train"
    fsdp = cfg.fsdp_train if train else cfg.fsdp_serve
    minfo = make_mesh_info(mesh, fsdp=fsdp,
                           fsdp_resident=(shape.kind == "decode"))
    with recording(mesh):
        program = api.compile(cfg, policy=get_strategy(strategy), mesh=mesh,
                              mesh_info=minfo, verify=verify)
        stats = program.store.stats
        lowered0 = stats["lower_s"] + stats["specialize_s"]
        t0 = time.perf_counter()
        if train:
            step = program.train_step(shape.global_batch, shape.seq_len,
                                      remat_policy=remat_policy)
        elif shape.kind == "prefill":
            step = program.prefill(shape.global_batch, shape.seq_len)
        else:
            step = program.decode_tiers(
                shape.global_batch, shape.seq_len,
                tiers=(shape.global_batch,))[shape.global_batch]
        t_build = time.perf_counter() - t0
        t_compile = stats["lower_s"] + stats["specialize_s"] - lowered0
        args = step_inputs(step, mesh, train)
        scopes = (("flashable_attention", "flashable_decode")
                  if attn_sub else ())
        counter = Counter(scopes)
        counter.mark_inputs(args)
        t0 = time.perf_counter()
        with counter:
            out = step.fn(*args)
        t_lower = time.perf_counter() - t0
    counts = counter.result()
    ins, outs = storages(args), storages(out)
    out_bytes = sum(outs.values())
    alias = sum(n for k, n in outs.items() if k in ins)
    arg_bytes = sum(ins.values())
    temp = max(0, counts["peak_bytes"] - (out_bytes - alias))
    return {"counts": counts, "masked_flops": counter.masked_flops,
            "build_s": t_build, "compile_s": t_compile,
            "lower_s": t_lower, "memory": {
                "argument_bytes": arg_bytes, "output_bytes": out_bytes,
                "temp_bytes": temp, "alias_bytes": alias,
                "peak_per_device": arg_bytes + out_bytes + temp - alias}}


def dry_run(cfg, shape, mesh, *, mesh_name: str, strategy: str = "dynamic",
            attn_sub: bool = False, remat_policy: str = "full",
            verify: str = "warn") -> dict:
    """One cell's record: ``cfg`` (an ``ArchConfig``) at ``shape`` (a
    ``ShapeConfig``) on ``mesh`` (a :class:`ShapeMesh`), named
    ``mesh_name``."""
    run = count_step(cfg, shape, mesh, strategy=strategy, attn_sub=attn_sub,
                     remat_policy=remat_policy, verify=verify)
    return record(cfg, shape, mesh, run, mesh_name=mesh_name,
                  strategy=strategy, attn_sub=attn_sub)


def record(cfg, shape, mesh, run: dict, *, mesh_name: str,
           strategy: str = "dynamic", attn_sub: bool = False) -> dict:
    """The record of ``count_step``'s ``run`` of ``cfg`` at ``shape`` on
    ``mesh``."""
    counts = run["counts"]
    coll = counts["collectives"]
    sizes = mesh_shape_dict(mesh)
    chips = mesh.size()
    n_total, n_active = cfg.param_count()
    rl = roofline_terms(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_flops=counts["flops"], hlo_bytes=counts["hbm_bytes"],
        coll_payload=coll, n_params=n_total, n_active=n_active,
        tokens=shape.tokens_per_step, train=shape.kind == "train",
        axis_size=sizes.get("model", 16))
    return {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
        "status": "ok", "strategy": strategy, "chips": chips,
        "attn_sub": attn_sub,
        "substituted_bytes": counts["substituted_bytes"],
        "phase": shape.kind,
        "build_s": round(run["build_s"], 2),
        "lower_s": round(run["lower_s"], 2),
        "compile_s": round(run["compile_s"], 2),
        "memory": run["memory"],
        "cost": {"flops": float(counts["flops"]),
                 "bytes accessed": float(counts["hbm_bytes"])},
        "collective_payload_bytes": coll,
        "roofline": rl.to_json(),
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             strategy: str = "dynamic", verbose: bool = True,
             attn_sub: bool = False, remat_policy: str = "full",
             verify: str = "warn") -> dict:
    cfg = get_config(arch)
    reason = skip_reason(cfg, shape_name)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    if reason:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}
    rec = dry_run(cfg, SHAPES[shape_name], production_mesh(multi_pod),
                  mesh_name=mesh_name, strategy=strategy, attn_sub=attn_sub,
                  remat_policy=remat_policy, verify=verify)
    if verbose:
        rl = rec["roofline"]
        print(f"[{arch} × {shape_name} × {mesh_name}] OK  "
              f"build={rec['build_s']:.1f}s  "
              f"peak/dev={rec['memory']['peak_per_device']/2**30:.2f}GiB  "
              f"flops={rec['cost']['flops']:.3e}  "
              f"coll={rec['collective_payload_bytes']['total']:.3e}B  "
              f"bottleneck={rl['bottleneck']}")
    return rec


def save_record(rec: dict, results_dir=None):
    results_dir = results_dir or RESULTS_DIR
    os.makedirs(results_dir, exist_ok=True)
    suffix = "__pallas" if rec.get("attn_sub") else ""
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{suffix}.json"
    with open(os.path.join(results_dir, name), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--strategy", default="dynamic")
    ap.add_argument("--attn-sub", action="store_true",
                    help="report the attention kernels' boundary bytes "
                         "under the JAX package's substituted scopes")
    ap.add_argument("--remat-policy", default="full",
                    choices=("full", "dots"))
    ap.add_argument("--verify", default="warn",
                    choices=("off", "warn", "strict"),
                    help="static plan verification mode for every cell "
                         "(core.verify; strict fails the cell on "
                         "error-severity diagnostics)")
    args = ap.parse_args(argv)

    archs = list_archs() if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    rec = run_cell(arch, shape, multi_pod=mp,
                                   strategy=args.strategy,
                                   attn_sub=args.attn_sub,
                                   remat_policy=args.remat_policy,
                                   verify=args.verify)
                    save_record(rec)
                    if rec["status"] == "skipped":
                        print(f"[{arch} × {shape} × "
                              f"{'pod2x16x16' if mp else 'pod16x16'}] "
                              f"SKIP: {rec['reason']}")
                except Exception as e:
                    traceback.print_exc()
                    failures.append((arch, shape, mp, str(e)[:200]))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nall dry-run cells OK")


if __name__ == "__main__":
    main()
