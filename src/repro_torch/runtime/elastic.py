"""Elastic scaling and restarts: the port of ``repro/runtime/elastic.py``.

The PWS planner is a deterministic function of the mesh (paper Obs. 4.3:
the steal schedule is determined by p), so bringing a state up on a
changed mesh is: rebuild the mesh, re-run ``plan_params`` / ``plan_cache``
(:func:`replan_for_mesh`, :func:`replan_params_for_mesh`), and place the
checkpointed leaves under the new plan.  On a mesh of one device every
leaf goes whole to that device; on a mesh of more than one rank each rank
allocates its blocks under the new plan and reads each whole leaf into its
block (``checkpoint._place_leaf``), so a checkpoint written on ``(2, 2)``
restores onto ``(1, 2)`` or one device, and the reverse (the dense family;
``launch/mesh.py``).

Two restart paths share the machinery: :func:`elastic_restore` rebuilds a
TRAIN state (params and optimizer) and :func:`serving_restore` a SERVING
replica (params only: decode caches are rebuilt empty and refilled by
request replay, so a restarted replica serves logits identical to the
original's; :meth:`repro_torch.launch.engine.Engine.restart` is the
engine-level wrapper).  Both read the JAX package's on-disk format through
:class:`repro_torch.checkpoint.CheckpointManager`, every leaf's checksum
checked.  The structure to restore into is given as a "like": the port's
state dict (a model built on the ``meta`` device gives one without
memory, as ``jax.eval_shape`` gives the JAX package its abstract params);
only names, shapes and dtypes are read from it.  Where JAX takes a mesh,
they take a mesh, a device, or None (each like's own device).

:func:`respawn_mesh` is the mesh a replacement replica spins up on, as in
JAX; :func:`respawn_device` its one-device form.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.core import planner
from repro_torch.launch.mesh import (is_mesh, is_sharded, make_debug_mesh, mesh_device,
                                     mesh_device_count)


def _fresh(like: Any, device) -> Any:
    """``like``'s structure with an empty tensor of each leaf's shape and
    dtype on ``device`` (default: the leaf's own device)."""
    if isinstance(like, dict):
        return {k: _fresh(v, device) for k, v in like.items()}
    return torch.empty(like.shape, dtype=like.dtype,
                       device=like.device if device is None else device)


def respawn_device(prev_device=None) -> torch.device:
    """The device a replacement replica spins up on after its predecessor
    died: the fleet's own device (one card, or the CPU), checked to be there
    still: CUDA that went away raises rather than moving the fleet to the
    CPU.  The restored replica's logits match the original's bit for bit,
    since every replica holds the checkpointed params on the same kind of
    device."""
    return resolve_device(prev_device)


def replan_for_mesh(state_like: Any, new_mesh) -> dict:
    """Shardings for a train state ``{"params", "opt_state"}`` on a new mesh
    (either kind)."""
    return {"params": planner.named(planner.plan_params(state_like["params"], new_mesh),
                                    new_mesh),
            "opt_state": planner.named(planner.plan_opt_state(state_like["opt_state"],
                                                              new_mesh), new_mesh)}


def replan_params_for_mesh(params_like: Any, new_mesh):
    """Shardings for a params-only (serving) state on a new mesh."""
    return planner.named(planner.plan_params(params_like, new_mesh), new_mesh)


def respawn_mesh(prev_mesh, lost_devices: int = 0):
    """The mesh a replacement replica spins up on after its predecessor
    died: the same device count minus ``lost_devices``, through the debug
    mesh factory so tensor-parallel stays as wide as the survivors allow
    (JAX's rule), on the previous mesh's device type."""
    n = max(mesh_device_count(prev_mesh) - int(lost_devices), 1)
    return make_debug_mesh(n, tp=min(2, n), device=mesh_device(prev_mesh, "respawn_mesh").type)


def _restore(ckpt_manager, like: Any, where, plan) -> tuple[int, Any]:
    """The latest checkpoint into fresh tensors: on ``where``'s device when
    it is a mesh (the leaves placed by ``plan(like, mesh)``), on ``where``
    when it is a device, else on each like's own device."""
    if is_mesh(where):
        dev = mesh_device(where, "restoring onto a mesh")
        if is_sharded(where):
            blank = _fresh(like, "meta")
            blocks = planner.place(blank, plan(blank, where), where)
            return ckpt_manager.restore_latest(blocks, in_place=True)
        step, state = ckpt_manager.restore_latest(_fresh(like, dev), in_place=True)
        return step, planner.place(state, plan(state, where), where)
    device = None if where is None else resolve_device(where)
    return ckpt_manager.restore_latest(_fresh(like, device), in_place=True)


def serving_restore(ckpt_manager, params_like: dict, mesh=None):
    """Restore the latest params checkpoint for a serving restart: no
    optimizer state, no cache (decode caches rebuild empty; in-flight
    requests replay through admission).  Reads checkpoints saved as
    ``{"params": ...}`` (the trainer's layout, and the router's).
    ``params_like``: the port's state dict whose names, shapes and dtypes
    the leaves are held to; ``mesh``: a mesh (the leaves placed by
    ``plan_params`` on it), a device, or None (each like's own device).
    Returns ``(step, params)`` of fresh tensors."""
    step, state = _restore(ckpt_manager, {"params": params_like}, mesh,
                           lambda st, m: {"params": planner.plan_params(st["params"], m)})
    return step, state["params"]


def elastic_restore(ckpt_manager, state_like: Any, mesh=None):
    """Restore the latest train-state checkpoint (``{"params", "opt_state"}``
    in the trainer's layout) resharded onto ``mesh`` (a mesh: the leaves
    placed by :func:`replan_for_mesh`'s plan; a device; or None, each like's
    own device).  Returns ``(step, state)`` of fresh tensors."""
    return _restore(ckpt_manager, state_like, mesh,
                    lambda st, m: {"params": planner.plan_params(st["params"], m),
                                   "opt_state": planner.plan_opt_state(st["opt_state"], m)})
