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
entry is unconstrained is no constraint at all (None).

Where JAX's ``with_sharding_constraint`` moves data, the port's
:func:`constrain` moves none: the blocks in ``models/common.py`` insert the
collectives, and ``constrain`` checks what they produced.  On a real mesh
of more than one rank it holds the tensor's LOCAL shape to the spec: each
dimension whose logical name has a global extent bound
(``axis_rules(..., extents=...)``, the entry point's batch and the
config's heads, ffn width and vocabulary) must be that extent cut by the
mesh axes the spec gives it, or whole where it gives none; a mismatch
raises ``ValueError``.  It returns its input object in every case, and
does nothing outside a binding, on a mesh of one device, or on a ``meta``
tensor (the dry run's trace).  The entry points bind
:func:`execution_rules`: JAX's rules with the residual stream's ``seq``
left whole (``ROADMAP.md`` queue 3: an all-reduce of the residual where
JAX's rule gives a sequence-parallel reduce-scatter and all-gather pair).

This is the activation-side half of the PWS planner: the weight-side half
lives in ``repro_torch.core.planner``.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Union

import torch

from repro_torch.core.planner import PartitionSpec as P
from repro_torch.launch.mesh import axis_names, axis_sizes, is_sharded

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
def axis_rules(rules: dict[str, Union[str, tuple, None]], mesh=None,
               extents: Optional[dict[str, int]] = None):
    """Bind logical axis names to mesh axes.  Example:
    ``axis_rules({"batch": ("pod", "data"), "heads": "model", ...}, mesh)``.
    ``mesh`` (either kind) gives the axis sizes; ``extents`` the global
    size of logical dims (``{"batch": 8, "heads": 16, ...}``), which
    :func:`constrain` holds local shapes to on a real mesh."""
    sizes = axis_sizes(mesh) if mesh is not None else {}
    token = _RULES.set({"rules": dict(rules), "sizes": sizes, "mesh": mesh,
                        "extents": dict(extents or {})})
    try:
        yield
    finally:
        _RULES.reset(token)


def current() -> Optional[dict]:
    """The binding in force (None outside one): what a recomputation in
    the backward re-enters (``models/base.maybe_remat``)."""
    return _RULES.get()


@contextlib.contextmanager
def restore(binding: Optional[dict]):
    """Re-enter a binding :func:`current` returned (None: no binding)."""
    token = _RULES.set(binding)
    try:
        yield
    finally:
        _RULES.reset(token)


def split_axes(name: str):
    """The mesh axes the bound rules split logical dim ``name`` over, given
    its bound extent (None where it is whole or unbound): e.g. the data
    axes for ``"batch"`` when the entry point's batch divides them."""
    ctx = _RULES.get()
    if ctx is None or name not in ctx["extents"]:
        return None
    spec = resolve((ctx["extents"][name],), name)
    if spec is None or spec[0] is UNCONSTRAINED or spec[0] is None:
        return None
    return spec[0]


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


def execution_rules(mesh) -> dict:
    """The rules the port's entry points bind: :func:`default_rules` with
    ``seq`` whole (the residual stream stays replicated over ``model``;
    ``ROADMAP.md`` queue 3)."""
    return {**default_rules(mesh), "seq": None}


def extents(cfg, batch: int) -> dict[str, int]:
    """The global extents :func:`constrain` checks a model config's
    activations against: the entry point's ``batch`` rows, and the
    config's heads, KV heads, FFN width and vocabulary."""
    return {"batch": batch, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
            "ffn": cfg.d_ff, "vocab": cfg.vocab_size}


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
    """``x`` itself, checked on a real mesh of more than one rank: each dim
    with a bound extent must be that extent cut by the mesh axes the hint
    resolves to (whole where it resolves to none); raises ``ValueError``
    on a mismatch.  Moves no data (see the module docstring)."""
    ctx = _RULES.get()
    if ctx is None or x.device.type == "meta" or not is_sharded(ctx["mesh"]):
        return x
    ext = ctx["extents"]
    full = tuple(ext.get(name, dim) if isinstance(name, str) else dim
                 for dim, name in zip(x.shape, logical_axes))
    spec = resolve(full, *logical_axes)
    sizes = ctx["sizes"]
    for i, (dim, name) in enumerate(zip(x.shape, logical_axes)):
        if not isinstance(name, str) or name not in ext:
            continue
        e = None if spec is None else spec[i]
        if e is UNCONSTRAINED:
            continue
        n = 1
        for a in (() if e is None else e if isinstance(e, tuple) else (e,)):
            n *= sizes[a]
        if dim * n != ext[name]:
            raise ValueError(f"constrain{tuple(logical_axes)}: dim {i} ({name!r}) holds "
                             f"{dim} of {ext[name]} under {spec}; expected "
                             f"{ext[name] // n}")
    return x
