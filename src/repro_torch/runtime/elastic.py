"""Elastic restarts: a serving replica or a train state brought back from
the latest checkpoint onto a device.  The port of
``repro/runtime/elastic.py``.

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
only names, shapes and dtypes are read from it.

:func:`respawn_device` is the counterpart of JAX's ``respawn_mesh``: the
device a replacement replica spins up on.  A replica of the port is one
device, so there is no mesh to shrink.  JAX's ``replan_for_mesh`` and
``replan_params_for_mesh`` (shardings for a changed mesh) have no
counterpart until sharding is ported (ROADMAP queue 1, multi-device planning).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import resolve_device


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


def serving_restore(ckpt_manager, params_like: dict, device=None):
    """Restore the latest params checkpoint for a serving restart: no
    optimizer state, no cache (decode caches rebuild empty; in-flight
    requests replay through admission).  Reads checkpoints saved as
    ``{"params": ...}`` (the trainer's layout, and the router's).
    ``params_like``: the port's state dict whose names, shapes and dtypes
    the leaves are held to.  Returns ``(step, params)``: fresh tensors on
    ``device`` (default: each like's own device)."""
    step, state = ckpt_manager.restore_latest({"params": _fresh(params_like, device)},
                                              in_place=True)
    return step, state["params"]


def elastic_restore(ckpt_manager, state_like: Any, device=None):
    """Restore the latest train-state checkpoint (``{"params", "opt_state"}``
    in the trainer's layout) onto ``device`` (default: each like's own).
    Returns ``(step, state)`` of fresh tensors."""
    return ckpt_manager.restore_latest(_fresh(state_like, device), in_place=True)
