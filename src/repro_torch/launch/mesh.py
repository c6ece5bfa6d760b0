"""Meshes: the counterpart of ``repro/launch/mesh.py``.

Two kinds of mesh reach the planner, which reads only their axis names and
sizes:

* a real ``torch.distributed.device_mesh.DeviceMesh`` over the devices
  present (:func:`make_debug_mesh`), dims ``("data", "model")``: on one
  card a ``(1, 1)`` mesh over a world-size-1 process group started in this
  process from a local ``HashStore`` (no launcher, no network);
* :class:`AbstractMesh`, names and sizes without devices, as
  ``jax.sharding.AbstractMesh`` is (:func:`make_production_mesh`: JAX's
  ``(16, 16)`` and ``(2, 16, 16)`` production shapes), which the dry run
  plans and traces against.

The port plans any mesh but executes on one device only: an entry point
given a real mesh of more than one device raises ``NotImplementedError``
(:func:`mesh_device`), it never replicates quietly.  Sharded execution is
``ROADMAP.md`` queue 1's next item.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device

SHARDED_EXECUTION = ("sharded execution over more than one device is not yet "
                     "ported (ROADMAP.md queue 1): the port plans any mesh but "
                     "executes on a mesh of one device")


class AbstractMesh:
    """A mesh of names and sizes with no devices (``jax.sharding.AbstractMesh``):
    ``shape`` maps each axis name to its size, in order."""

    def __init__(self, shape: tuple, axis_names: tuple):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} against axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"

    def __eq__(self, other) -> bool:
        return isinstance(other, AbstractMesh) and self.shape == other.shape \
            and self.axis_names == other.axis_names

    def __hash__(self) -> int:
        return hash((self.axis_names, tuple(self.shape.values())))


def is_abstract(mesh) -> bool:
    return isinstance(mesh, AbstractMesh)


def is_mesh(x) -> bool:
    """True for either kind of mesh (a device or None is not one)."""
    return is_abstract(x) or hasattr(x, "mesh_dim_names")


def axis_names(mesh) -> tuple:
    """The mesh's axis names, outermost first (either kind)."""
    return mesh.axis_names if is_abstract(mesh) else tuple(mesh.mesh_dim_names)


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` in axis order: JAX's ``dict(mesh.shape)``, the
    value a checkpoint manifest records as ``mesh_shape``."""
    if is_abstract(mesh):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def mesh_device_count(mesh) -> int:
    n = 1
    for v in axis_sizes(mesh).values():
        n *= v
    return n


def mesh_device(mesh, what: str = "this entry point") -> torch.device:
    """The one device a real mesh of one device executes on.  Raises
    ``NotImplementedError`` on a mesh of more than one device (no quiet
    replication) and ``TypeError`` on an abstract mesh, which has none."""
    if is_abstract(mesh):
        raise TypeError(f"{what}: {mesh!r} has no devices to execute on; "
                        "it is for planning and the dry run")
    if mesh_device_count(mesh) > 1:
        raise NotImplementedError(f"{what} on a mesh of {axis_sizes(mesh)}: "
                                  f"{SHARDED_EXECUTION}")
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """Single pod: 16x16 = 256 devices, axes (data, model).  Multi-pod: 2
    pods x 256 = 512 devices, axes (pod, data, model).  Abstract: JAX's
    production shapes for planning and the dry run."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def _world() -> int:
    """The world size of the default process group, started in this process
    over a local ``HashStore`` (world size 1) when there is none."""
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    return dist.get_world_size()


# (device type, dp, tp) -> the mesh: one DeviceMesh a shape per process
_MESHES: dict = {}


def make_debug_mesh(n_devices: Optional[int] = None, *, tp: int = 2, device=None):
    """A ``DeviceMesh`` of dims ``("data", "model")`` over the devices present
    (JAX: ``make_debug_mesh``): ``n_devices`` (default: the process group's
    world size, 1 unless a launcher started more processes) as ``(n // tp,
    tp)`` with ``tp`` capped at ``n``.  ``device``: CUDA unless told
    otherwise (raises without it).  On one card it is ``(1, 1)``.  A mesh of
    more than one device can be built under a launcher, but the port's
    entry points refuse to execute on it (:func:`mesh_device`)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    world = _world()
    n = n_devices or world
    if n > world:
        raise ValueError(f"make_debug_mesh({n}): the process group holds {world} "
                         "device(s)")
    tp = max(1, min(tp, n))
    dp = n // tp
    key = (dev.type, dp, tp)
    mesh = _MESHES.get(key)
    if mesh is None:
        from torch.distributed.device_mesh import DeviceMesh

        mesh = _MESHES[key] = DeviceMesh(dev.type, torch.arange(dp * tp).reshape(dp, tp),
                                         mesh_dim_names=("data", "model"))
    return mesh


def mesh_for(mesh, device, what: str):
    """The mesh an entry point runs on: ``mesh``, else the ``(1, 1)`` mesh
    of ``device``; a ``device`` that is not the mesh's raises."""
    if mesh is None:
        return make_debug_mesh(1, tp=1, device=device)
    if device is not None and resolve_device(device) != mesh_device(mesh, what):
        raise ValueError(f"{what}: device {device} is not the mesh's device")
    return mesh
