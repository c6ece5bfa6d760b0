"""Collectives over one named mesh axis: what sharded execution inserts
around the registry's kernels (``models/common.py``), where JAX's GSPMD
inserts them for its sharding annotations.

Each op works over ``mesh.get_group(axis)`` for a real ``DeviceMesh``
and is the identity when the axis has size 1, so a model on a mesh of one
device runs exactly the code it ran before.

* The conjugate pairs, as ``torch.autograd.Function``s:
  :func:`all_gather` (backward: reduce-scatter) and :func:`reduce_scatter`
  (backward: all-gather), the FSDP weight gather whose gradient comes out
  reduce-scattered (JAX's single-writer rule); :func:`copy_to` (identity
  forward, all-reduce backward) and :func:`reduce_from` (all-reduce forward,
  identity backward), Megatron's f and g around a tensor-parallel region.
* The reductions a vocabulary split over ``model`` needs, without a
  gradient: :func:`all_max`, :func:`all_sum` and :func:`argmax` (the
  lowest global index wins a tie, as ``jnp.argmax``); the pick of a target
  column is a masked local gather summed by :func:`reduce_from`.
* :func:`broadcast_object` for host state one rank holds (an engine row's
  snapshot), :func:`barrier`.

Every call adds one to its kind's count and its bytes to the kind's bytes
(:func:`counts`): an all-gather the bytes of its full output, a
reduce-scatter those of its full input, an all-reduce those of the tensor.
``chip_smoke.py`` reads them around a step.

Every collective takes the tensor form (``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_reduce``) on either backend: gloo takes
CUDA tensors in each of them, ranks sharing one card included
(``tools/gloo_cuda_probe.py`` with torch 2.11 on an H100; ``PERF.md`` §6).
Nothing here moves a tensor to another device to get round a backend.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

KINDS = ("all_gather", "reduce_scatter", "all_reduce", "broadcast")
_COUNTS = {k: {"calls": 0, "bytes": 0} for k in KINDS}


def reset_counts() -> None:
    for c in _COUNTS.values():
        c["calls"] = c["bytes"] = 0


def counts() -> dict:
    """``{kind: {"calls", "bytes"}}`` since the last :func:`reset_counts`."""
    return {k: dict(c) for k, c in _COUNTS.items()}


def _count(kind: str, t: torch.Tensor) -> None:
    _COUNTS[kind]["calls"] += 1
    _COUNTS[kind]["bytes"] += t.numel() * t.element_size()


def axis_size(mesh, axis) -> int:
    """The size of ``axis`` (a name or a tuple of names) on ``mesh``."""
    n = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        n *= int(mesh.size(mesh.mesh_dim_names.index(a)))
    return n


def _group(mesh, axis: str):
    return mesh.get_group(axis)


# -- the raw collectives (no autograd) ------------------------------------------------

def _all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = axis_size(mesh, axis)
    group = _group(mesh, axis)
    xm = x.movedim(dim, 0).contiguous()
    flat = torch.empty((n * xm.shape[0],) + tuple(xm.shape[1:]), dtype=x.dtype,
                       device=x.device)
    dist.all_gather_into_tensor(flat, xm, group=group)
    out = flat.movedim(0, dim)
    _count("all_gather", out)
    return out.contiguous()


def _reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = axis_size(mesh, axis)
    group = _group(mesh, axis)
    _count("reduce_scatter", x)
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((xm.shape[0] // n,) + tuple(xm.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, xm, group=group)
    return out.movedim(0, dim).contiguous()


def _all_reduce(x: torch.Tensor, mesh, axis, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.contiguous().clone()
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        if axis_size(mesh, a) > 1:
            _count("all_reduce", out)
            dist.all_reduce(out, op=op, group=_group(mesh, a))
    return out


# -- the conjugate pairs ---------------------------------------------------------------

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, *ctx.args), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _reduce_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, *ctx.args), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _trivial(mesh, axis) -> bool:
    return mesh is None or axis_size(mesh, axis) == 1


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The shards of ``x`` along ``dim`` over ``axis``, concatenated in
    coordinate order; the gradient comes back reduce-scattered."""
    return x if _trivial(mesh, axis) else _AllGather.apply(x, mesh, axis, dim)


def reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, this rank's part of it along
    ``dim``; the gradient comes back all-gathered."""
    return x if _trivial(mesh, axis) else _ReduceScatter.apply(x, mesh, axis, dim)


def copy_to(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """Megatron's f: ``x`` unchanged, its gradient all-reduced over ``axis``
    (a name or a tuple): the entry of a region whose work is split over
    ``axis``."""
    return x if _trivial(mesh, axis) else _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """Megatron's g: ``x`` all-reduced (summed) over ``axis``, its gradient
    passed through: the exit of a region whose partial sums are split over
    ``axis``."""
    return x if _trivial(mesh, axis) else _ReduceFrom.apply(x, mesh, axis)


@torch.no_grad()
def all_max(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The elementwise maximum over ``axis`` (no gradient)."""
    return x if _trivial(mesh, axis) else _all_reduce(x, mesh, axis, dist.ReduceOp.MAX)


@torch.no_grad()
def all_sum(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The elementwise sum over ``axis`` (no gradient)."""
    return x if _trivial(mesh, axis) else _all_reduce(x, mesh, axis)


@torch.no_grad()
def all_gather_rows(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The rows of ``x`` of every rank of ``axis`` (a name, or a tuple of
    names major to minor), in coordinate order (no gradient): a data
    rank's sampled tokens gathered for every host."""
    for a in reversed(axis if isinstance(axis, tuple) else (axis,)):
        if not _trivial(mesh, a):
            x = _all_gather(x, mesh, a, 0)
    return x


@torch.no_grad()
def argmax(logits: torch.Tensor, mesh, axis, offset: int) -> torch.Tensor:
    """The global argmax of ``logits`` (..., V_local), this rank's columns
    ``offset .. offset + V_local`` of a vocabulary split over ``axis``: each
    rank's first maximum, then the largest value over ranks, the lowest
    global index among equal values (``jnp.argmax``'s first maximum).  A NaN
    row gives some index on every rank alike.  Returns int64 (...,)."""
    local = torch.argmax(logits, dim=-1)
    if _trivial(mesh, axis):
        return local + offset
    best = logits.gather(-1, local[..., None])[..., 0].double()
    pair = torch.stack([best, (local + offset).double()], dim=-1)  # exact in f64
    every = _all_gather(pair[None], mesh, axis, 0)  # (n, ..., 2)
    vals, idx = every[..., 0], every[..., 1]
    top = vals.amax(dim=0, keepdim=True)
    idx = torch.where(vals == top, idx, float("inf")).amin(dim=0)
    nan = torch.isnan(vals).any(dim=0)
    return torch.where(nan, every[0, ..., 1], idx).long()


def broadcast_object(obj: Any, mesh, axis: str, src: int) -> Any:
    """``obj`` as the rank at coordinate ``src`` of ``axis`` holds it, on
    every rank of ``axis`` (pickled; CPU tensors only)."""
    if _trivial(mesh, axis):
        return obj
    group = _group(mesh, axis)
    box = [obj]
    _COUNTS["broadcast"]["calls"] += 1
    dist.broadcast_object_list(box, group_src=src, group=group)
    return box[0]


def barrier(mesh) -> None:
    """Wait for every rank of ``mesh``."""
    if mesh is not None and axis_size(mesh, tuple(mesh.mesh_dim_names)) > 1:
        for a in mesh.mesh_dim_names:
            if axis_size(mesh, a) > 1:
                dist.barrier(group=_group(mesh, a))
