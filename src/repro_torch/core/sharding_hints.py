"""Logical-axis sharding hints: the counterpart of
``repro/core/sharding_hints.py``.

Models stay resource-oblivious (the paper's contract: algorithms never
mention p, M, B).  They may annotate tensors with *logical* axis names
("batch", "heads", "ffn", "experts", "vocab", "seq"); the launcher binds
logical names to mesh axes (:func:`axis_rules`).  Outside a binding, or on a
mesh of one device, the hints are no-ops.

:func:`resolve` gives the spec a hint resolves to, JAX's resolution exactly:
a logical name maps to its mesh axis (or tuple of axes), an axis whose size
does not divide the dimension becomes :data:`UNCONSTRAINED` (the paper's
balance condition: only balanced forks are stolen), and a hint whose every
entry is unconstrained is no constraint at all (None).  :func:`constrain`
returns its input object untouched when there is no constraint, and on a
``meta`` tensor (the dry run's trace); on a real tensor under a mesh of
more than one device it raises ``NotImplementedError``: sharded execution
is not yet ported, and nothing replicates quietly.  The models' call sites
come with sharded execution (``ROADMAP.md`` queue 1).

This is the activation-side half of the PWS planner: the weight-side half
lives in ``repro_torch.core.planner``.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Union

import torch

from repro_torch.core.planner import PartitionSpec as P
from repro_torch.launch.mesh import SHARDED_EXECUTION, axis_names, axis_sizes

# logical name -> mesh axis (str or tuple) binding
_RULES: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "repro_torch_sharding_rules", default=None)


class _Unconstrained:
    """JAX's ``PartitionSpec.UNCONSTRAINED``: the dimension is left to the
    partitioner."""

    def __repr__(self) -> str:
        return "UNCONSTRAINED"


UNCONSTRAINED = _Unconstrained()


@contextlib.contextmanager
def axis_rules(rules: dict[str, Union[str, tuple, None]], mesh=None):
    """Bind logical axis names to mesh axes.  Example:
    ``axis_rules({"batch": ("pod", "data"), "heads": "model", ...}, mesh)``.
    ``mesh`` (either kind) gives the axis sizes."""
    sizes = axis_sizes(mesh) if mesh is not None else {}
    token = _RULES.set({"rules": dict(rules), "sizes": sizes})
    try:
        yield
    finally:
        _RULES.reset(token)


def default_rules(mesh) -> dict:
    dp = ("pod", "data") if "pod" in axis_names(mesh) else ("data",)
    return {
        "batch": dp,
        "heads": "model",
        "kv_heads": "model",
        "ffn": "model",
        "experts": "model",
        "vocab": "model",
        # Megatron-style sequence parallelism on the residual stream; decode
        # (s=1) demotes to unconstrained through the divisibility rule
        "seq": "model",
    }


def resolve(shape, *logical_axes) -> Optional[P]:
    """The spec :func:`constrain` applies to a tensor of ``shape`` under the
    bound rules, or None where it applies none.  Entries: logical name
    (str), ``"*"`` (unconstrained), or None (replicated)."""
    ctx = _RULES.get()
    if ctx is None:
        return None
    rules, sizes = ctx["rules"], ctx["sizes"]
    if not sizes:
        return None
    entries = []
    for dim, name in zip(shape, logical_axes):
        if name == "*":
            entries.append(UNCONSTRAINED)
            continue
        if name is None:
            entries.append(None)
            continue
        axis = rules.get(name, "*")
        if axis == "*" or axis is None:
            entries.append(UNCONSTRAINED if axis == "*" else None)
            continue
        ax_tuple = axis if isinstance(axis, tuple) else (axis,)
        size = 1
        for a in ax_tuple:
            size *= sizes.get(a, 1)
        if size > 1 and dim % size == 0:
            entries.append(axis)
        else:
            entries.append(UNCONSTRAINED)
    if all(e is UNCONSTRAINED for e in entries):
        return None
    return P(*entries)


def constrain(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """``x`` itself where the hint resolves to no constraint (no binding, a
    mesh of one device, nothing divides) or ``x`` is a ``meta`` tensor;
    raises ``NotImplementedError`` where it would shard a real tensor."""
    spec = resolve(x.shape, *logical_axes)
    if spec is None or x.device.type == "meta":
        return x
    if not any(e is not None and e is not UNCONSTRAINED for e in spec):
        return x  # replicated and unconstrained entries only: nothing to move
    raise NotImplementedError(f"constrain{tuple(logical_axes)} -> {spec}: "
                              f"{SHARDED_EXECUTION}")
