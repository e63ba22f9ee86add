"""Mesh construction over a torch ``DeviceMesh``.

The port of ``src/repro/launch/mesh.py``.  ``make_mesh`` builds a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
current process group and binds each named axis's group for
``dist.collectives`` (``bind_axis``), so model code's collectives over
'pod' / 'data' / 'model' run over those groups.  Rank ``r`` sits at the
mesh coordinate ``unravel(r, shape)``, row-major, as a JAX mesh lists its
devices.

Axes:
  pod    — data parallelism across pods (pure DP; also hosts the optional
           pipeline driver in dist/pipeline.py)
  data   — data parallelism within a pod (+ FSDP param sharding)
  model  — tensor/sequence/expert parallelism within a pod row
"""
from __future__ import annotations

import torch

from ..dist import collectives as col


def _start_one_rank_group(device_type: str) -> None:
    """A one-rank process group in this process, from an in-memory store:
    no environment variables, address or port."""
    import torch.distributed as dist
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_mesh(shape, axes, device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the current
    process group (started here, one rank, when this single process has
    none), each axis's group bound for the collectives.  ``device``: the
    device type of the mesh (default: the GPU)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..device import resolve_device
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    dev = resolve_device(device)
    if not dist.is_initialized():
        _start_one_rank_group(dev.type)
    n = 1
    for d in shape:
        n *= d
    if dist.get_world_size() != n:
        raise ValueError(f"a mesh of shape {shape} needs {n} ranks; the "
                         f"process group has {dist.get_world_size()}")
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    mesh = init_device_mesh(dev.type, shape, mesh_dim_names=axes)
    for axis in axes:
        col.bind_axis(axis, mesh.get_group(axis))
    return mesh


def unbind_mesh(mesh) -> None:
    """Forget the collectives' groups of ``mesh``'s axes."""
    for axis in mesh.mesh_dim_names:
        col.bind_axis(axis, None)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The JAX package's production mesh: (16, 16) over ('data',
    'model'), or (2, 16, 16) over ('pod', 'data', 'model')."""
    import torch.distributed as dist
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for d in shape:
        n *= d
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"the production mesh {shape} needs {n} ranks; "
                         f"the world has {world}")
    return make_mesh(shape, axes, device=device)


def mesh_shape_dict(mesh) -> dict:
    """axis name -> size, of a ``DeviceMesh`` or of such a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def mesh_coordinate(mesh) -> dict:
    """axis name -> this rank's index along it."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def make_mesh_info(mesh, *, fsdp: bool = False, fsdp_resident: bool = False):
    from ..models.layers import MeshInfo
    d = mesh_shape_dict(mesh)
    return MeshInfo(tp=d.get("model", 1), dp=d.get("data", 1),
                    pods=d.get("pod", 1), fsdp=fsdp,
                    fsdp_resident=fsdp_resident)
