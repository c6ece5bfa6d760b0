"""Meshes: the counterpart of ``repro/launch/mesh.py``.

Two kinds of mesh reach the planner, which reads only their axis names and
sizes:

* a real ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of a
  process group (:func:`make_debug_mesh`), dims ``("data", "model")``: the
  ``(n // tp, tp)`` mesh over the first ``n`` ranks.  With no process group
  it starts a world-size-1 group in this process from a local ``HashStore``
  (no launcher, no network), and the mesh is ``(1, 1)``;
* :class:`AbstractMesh`, names and sizes without devices, as
  ``jax.sharding.AbstractMesh`` is (:func:`make_production_mesh`: JAX's
  ``(16, 16)`` and ``(2, 16, 16)`` production shapes), which the dry run
  plans and traces against.

A process group of ``n`` ranks starts one of two ways: from the environment
under ``torchrun`` (:func:`init_from_env`, the CLI path), or by
:func:`spawn`, which starts ``n`` processes itself over a ``FileStore`` in
a temp directory (no network) and hands each rank's result back to the
caller (the tests and ``chip_smoke.py``).  The backend is a rule, never a
fallback (:func:`backend_for`): NCCL where each rank has a card of its own,
gloo for CPU tensors and for ranks that share a card.

The dense family (``models/dense.py`` without experts) executes sharded on
a mesh of more than one rank: FSDP over ``data``, tensor parallelism over
``model`` (``models/common.py``, ``core/collectives.py``).  Every other
family, and every option not yet sharded, raises on such a mesh naming
itself and ``ROADMAP.md`` (:func:`refuse`); nothing is replicated quietly.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch

from repro_torch import resolve_device

SHARDED_EXECUTION = ("sharded execution of this path over more than one rank is "
                     "not yet ported (ROADMAP.md queue 1): the port executes the "
                     "dense family sharded, and everything else on a mesh of one "
                     "device")


# a collective that waits longer than this raises (a rank that died, or one
# that left the lockstep) rather than hanging the others
DEFAULT_TIMEOUT_S = 300.0


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


def is_sharded(mesh) -> bool:
    """True for a real mesh of more than one rank: the one whose entry
    points execute sharded."""
    return mesh is not None and not is_abstract(mesh) and mesh_device_count(mesh) > 1


def refuse(what: str, mesh) -> None:
    """Raise ``NotImplementedError`` naming ``what`` and ``ROADMAP.md`` when
    ``mesh`` is a real mesh of more than one rank: a path the port does not
    yet execute sharded never replicates quietly."""
    if is_sharded(mesh):
        raise NotImplementedError(f"{what} on a mesh of {axis_sizes(mesh)}: "
                                  f"{SHARDED_EXECUTION}")


def mesh_device(mesh, what: str = "this entry point") -> torch.device:
    """The device this rank executes on: the current CUDA device of a
    ``cuda`` mesh, else the mesh's device type.  Raises ``TypeError`` on an
    abstract mesh, which has none, and ``ValueError`` on a mesh this process
    cannot execute: one larger than its process group, or one this rank is
    not in."""
    if is_abstract(mesh):
        raise TypeError(f"{what}: {mesh!r} has no devices to execute on; "
                        "it is for planning and the dry run")
    if mesh_device_count(mesh) > 1:
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_initialized() else 1
        if mesh_device_count(mesh) > world or mesh.get_coordinate() is None:
            raise ValueError(f"{what} on a mesh of {axis_sizes(mesh)}: this process "
                             f"(rank {dist.get_rank() if dist.is_initialized() else 0} of "
                             f"{world}) is not one of its ranks")
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


def backend_for(device_type: str, n_ranks: int, backend: Optional[str] = None) -> str:
    """The process group's backend: ``backend`` where given, else NCCL when
    each of ``n_ranks`` CUDA ranks has a card of its own, and gloo for CPU
    tensors and for ranks that share a card (NCCL refuses two ranks on one
    GPU).  A rule of the arguments and the card count, never a fallback."""
    if backend is not None:
        return backend
    if device_type == "cuda" and n_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device_type: str, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda:<rank mod cards>`` (ranks past the
    card count share cards), else the device type."""
    if device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(device_type)


def _world() -> int:
    """The world size of the default process group, started in this process
    over a local ``HashStore`` (world size 1) when there is none."""
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    return dist.get_world_size()


def init_from_env(device=None, *, backend: Optional[str] = None,
                  timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Start the process group from the environment ``torchrun`` sets
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``), on this
    rank's device, with :func:`backend_for`'s backend; a no-op outside a
    launcher or when a group is already up."""
    import torch.distributed as dist

    global _group_timeout_s
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    dev = resolve_device(device)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device("cuda", int(os.environ.get("LOCAL_RANK", rank))))
    dist.init_process_group(backend_for(dev.type, world, backend), rank=rank,
                            world_size=world, timeout=timedelta(seconds=timeout_s))
    _group_timeout_s = timeout_s


# (device type, dp, tp) -> the mesh: one DeviceMesh a shape per process
_MESHES: dict = {}
# the timeout the process group started with (spawn, init_from_env), which
# make_debug_mesh carries to its subgroups
_group_timeout_s = DEFAULT_TIMEOUT_S


def _group_options(backend: str, timeout_s: float):
    """Options that carry the group's timeout to each of a mesh's
    subgroups (``DeviceMesh`` otherwise gives them the library default)."""
    from torch._C._distributed_c10d import ProcessGroupGloo

    if backend == "gloo":
        opts = ProcessGroupGloo._Options()
    else:
        from torch._C._distributed_c10d import ProcessGroupNCCL

        opts = ProcessGroupNCCL.Options()
    opts._timeout = timedelta(seconds=timeout_s)
    return opts


def make_debug_mesh(n_devices: Optional[int] = None, *, tp: int = 2, device=None):
    """A ``DeviceMesh`` of dims ``("data", "model")`` over the first
    ``n_devices`` ranks of the process group (JAX: ``make_debug_mesh`` over
    the first ``n`` devices; default: the whole world, 1 without a
    launcher), as ``(n // tp, tp)`` with ``tp`` capped at ``n``.  Every rank
    of the group must call it (the subgroups are made collectively); a rank
    past ``n`` holds a mesh it is not in (``get_coordinate()`` is None).
    ``device``: CUDA unless told otherwise (raises without it)."""
    import torch.distributed as dist

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

        override = None
        if world > 1:
            backend = dist.get_backend()
            override = ((backend, _group_options(backend, _group_timeout_s)),) * 2
        mesh = _MESHES[key] = DeviceMesh(dev.type, torch.arange(dp * tp).reshape(dp, tp),
                                         mesh_dim_names=("data", "model"),
                                         backend_override=override)
    return mesh


def mesh_for(mesh, device, what: str):
    """The mesh an entry point runs on: ``mesh``, else the ``(1, 1)`` mesh
    of ``device``; a ``device`` that is not this rank's device on the mesh
    raises."""
    if mesh is None:
        return make_debug_mesh(1, tp=1, device=device)
    if device is not None and resolve_device(device) != mesh_device(mesh, what):
        raise ValueError(f"{what}: device {device} is not the mesh's device")
    return mesh


# -- the spawn helper ------------------------------------------------------------------

def _rank_main(rank: int, n: int, tmp: str, device_type: str, backend: str,
               timeout_s: float, fn, args) -> None:
    import torch.distributed as dist

    if device_type == "cpu":
        torch.set_num_threads(1)  # n ranks share the host's cores
    else:
        torch.cuda.set_device(rank_device(device_type, rank))
    global _group_timeout_s
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), n),
                            rank=rank, world_size=n, timeout=timedelta(seconds=timeout_s))
    _group_timeout_s = timeout_s
    try:
        out = fn(*args)
        torch.save(out, os.path.join(tmp, f"result_{rank}.pt"))
    finally:
        dist.destroy_process_group()
        _MESHES.clear()


def spawn(fn, n: int, *args, device="cpu", backend: Optional[str] = None,
          timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(*args)`` on ``n`` new processes, ranks ``0..n-1`` of one
    process group, and return each rank's result in rank order.

    The group meets over a ``FileStore`` in a temp directory (no network),
    on :func:`backend_for`'s backend, with ``timeout_s`` on every
    collective of it and of its meshes' subgroups.  On CUDA the kernels are
    built once here, before the ranks start (``kernels/_build.py``); each
    rank only loads them.  ``fn`` must be importable by name (the
    ``spawn`` start method pickles it); its result is handed back through
    ``torch.save``.  A rank that raises fails the call: the others are
    stopped and the error is raised here."""
    import tempfile

    import torch.multiprocessing as mp

    dev = resolve_device(device)
    backend = backend_for(dev.type, n, backend)
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.build()
    with tempfile.TemporaryDirectory(prefix="repro_torch_spawn_") as tmp:
        mp.spawn(_rank_main, args=(n, tmp, dev.type, backend, timeout_s, fn, args),
                 nprocs=n, join=True)
        return [torch.load(os.path.join(tmp, f"result_{r}.pt"), weights_only=False)
                for r in range(n)]
