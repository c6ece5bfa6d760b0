"""K4, the Strassen-schedule matmul over K2, and the registry's ``matmul``
entry.

Replaces ``src/repro/kernels/strassen_matmul.py:strassen_matmul`` and
``:matmul``.  It adds no CUDA source: every product runs on K2
(``hbp_matmul``), as the JAX recursion runs on the Pallas ``hbp_matmul``.

:func:`strassen_matmul` recurses the 7-product quadrant decomposition
(``_STRASSEN_LHS/RHS/OUT`` with the sign tables below) while the edge is
even and above ``cutoff`` (default: ``planner.strassen_cutoff``), down to
leaves on K2 with an f32 output: operand combinations are summed in f32 and
rounded to the input dtype right before their leaf, output combinations
stay in f32, and only the final result is rounded.  A single-quadrant
operand is a row-major view with row stride ``n``, which K2 reads in place;
the combinations are fresh tensors.  Any other shape falls through to one
K2 call.  The elementwise combinations are plain torch, as the JAX package
leaves them to XLA outside any Pallas kernel.

:func:`matmul` is the differentiable entry the registry dispatches: it asks
the planner for the backend (``classical``: one K2 call; ``strassen``: the
recursion) and its backward re-plans each of ``dA = g Bᵀ`` and
``dB = Aᵀ g`` on its own shape, as the JAX custom VJP does.

On the CPU every K2 call takes ``matmul_ref``, so these functions run their
plain versions there; :func:`strassen_matmul_plain` is the same recursion
with ``matmul_ref`` leaves on any device (the card's comparisons).
``strassen_matmul.launches`` counts the calls that recurse on CUDA tensors
(each launches ``7 ** levels`` K2 leaves).
"""
from __future__ import annotations

import importlib
from typing import Optional

import torch

from repro_torch.kernels.hbp_matmul import matmul_ref

# the K2 module, not the function the package exports under its name: the
# leaves look ``hbp_matmul`` up on it at call time
_k2 = importlib.import_module("repro_torch.kernels.hbp_matmul")

# Strassen products (``repro/core/algorithms.py:308-311``), quadrants
# 0..3 = 11, 12, 21, 22:  M1=(A11+A22)(B11+B22), M2=(A21+A22)B11,
# M3=A11(B12-B22), M4=A22(B21-B11), M5=(A11+A12)B22, M6=(A21-A11)(B11+B12),
# M7=(A12-A22)(B21+B22)
_STRASSEN_LHS = [(0, 3), (2, 3), (0,), (3,), (0, 1), (2, 0), (1, 3)]
_STRASSEN_RHS = [(0, 3), (0,), (1, 3), (2, 0), (3,), (0, 1), (2, 3)]
# C11 = M1+M4-M5+M7, C12 = M3+M5, C21 = M2+M4, C22 = M1-M2+M3+M6
_STRASSEN_OUT = [(0, 3, 4, 6), (2, 4), (1, 3), (0, 1, 2, 5)]
_LHS_SIGNS = ((1, 1), (1, 1), (1,), (1,), (1, 1), (1, -1), (1, -1))
_RHS_SIGNS = ((1, 1), (1,), (1, -1), (1, -1), (1,), (1, 1), (1, 1))
_OUT_SIGNS = ((1, 1, -1, 1), (1, 1), (1, 1), (1, -1, 1, 1))


def _combo(parts, idxs, signs, out_dtype):
    """Signed sum of quadrants or products, accumulated in f32 and emitted
    in ``out_dtype``; a single part is passed through (a view)."""
    if len(idxs) == 1:
        r = parts[idxs[0]]
        return r if r.dtype == out_dtype else r.to(out_dtype)
    acc = parts[idxs[0]].float()
    for ix, s in zip(idxs[1:], signs[1:]):
        q = parts[ix].float()
        acc = acc + q if s > 0 else acc - q
    return acc.to(out_dtype)


def _strassen(a, b, cutoff, leaf):
    dtype = a.dtype

    def rec(x, y, edge):
        if edge <= cutoff or edge % 2:
            return leaf(x, y)
        h = edge // 2
        xq = (x[:h, :h], x[:h, h:], x[h:, :h], x[h:, h:])
        yq = (y[:h, :h], y[:h, h:], y[h:, :h], y[h:, h:])
        prods = [rec(_combo(xq, li, ls, dtype), _combo(yq, ri, rs, dtype), h)
                 for li, ls, ri, rs in zip(_STRASSEN_LHS, _LHS_SIGNS,
                                           _STRASSEN_RHS, _RHS_SIGNS)]
        cq = [_combo(prods, oi, os_, torch.float32)
              for oi, os_ in zip(_STRASSEN_OUT, _OUT_SIGNS)]
        return torch.cat([torch.cat([cq[0], cq[1]], dim=1),
                          torch.cat([cq[2], cq[3]], dim=1)], dim=0)

    return rec(a, b, a.shape[0]).to(dtype)


def _eligible(a, b, cutoff) -> bool:
    m, k = a.shape
    n = b.shape[1]
    return m == k == n and n % 2 == 0 and n > cutoff


def _cutoff(a, cutoff) -> int:
    if cutoff is None:
        from repro_torch.kernels import planner

        cutoff = planner.strassen_cutoff(a.dtype, planner.device_params(a.device))
    return max(int(cutoff), 1)


def _check(a, b):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"strassen_matmul: shapes {tuple(a.shape)} @ {tuple(b.shape)}")


def strassen_matmul(a: torch.Tensor, b: torch.Tensor, *,
                    cutoff: Optional[int] = None) -> torch.Tensor:
    """``a @ b`` through the Strassen recursion with K2 leaves; see the
    module docstring."""
    _check(a, b)
    cutoff = _cutoff(a, cutoff)
    if not _eligible(a, b, cutoff):
        return _k2.hbp_matmul(a, b)
    out = _strassen(a, b, cutoff,
                    lambda x, y: _k2.hbp_matmul(x, y, out_dtype=torch.float32))
    if a.device.type == "cuda":
        strassen_matmul.launches += 1
    return out


strassen_matmul.launches = 0


def strassen_matmul_plain(a: torch.Tensor, b: torch.Tensor, *,
                          cutoff: Optional[int] = None) -> torch.Tensor:
    """Plain version: the same recursion with ``matmul_ref`` leaves."""
    _check(a, b)
    cutoff = _cutoff(a, cutoff)
    if not _eligible(a, b, cutoff):
        return matmul_ref(a, b)
    return _strassen(a, b, cutoff, lambda x, y: matmul_ref(x, y, torch.float32))


def _run(a, b, backend, cutoff):
    """Run the backend (None: ask the planner for this shape)."""
    if backend is None:
        from repro_torch.kernels import planner

        plan = planner.plan_matmul_backend(a.shape[0], a.shape[1], b.shape[1], a.dtype,
                                           planner.device_params(a.device))
        backend = plan["backend"]
        if cutoff is None:
            cutoff = plan.get("cutoff")
    if backend == "strassen":
        return strassen_matmul(a, b, cutoff=cutoff)
    return _k2.hbp_matmul(a, b)


class _Matmul(torch.autograd.Function):
    """``a @ b`` on the chosen backend, with the JAX custom VJP's backward
    (``strassen_matmul.py:119-139``): ``dA = g Bᵀ`` and ``dB = Aᵀ g``, each
    re-planned for its own shape (the transposes are views K2 reads in
    place), each cast to its operand's dtype."""

    @staticmethod
    def forward(ctx, a, b, backend, cutoff):
        ctx.save_for_backward(a, b)
        return _run(a, b, backend, cutoff)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _run(g, b.T, None, None).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = _run(a.T, g, None, None).to(b.dtype)
        return da, db, None, None


def matmul(a: torch.Tensor, b: torch.Tensor, *, backend: Optional[str] = None,
           cutoff: Optional[int] = None) -> torch.Tensor:
    """Differentiable ``a (m, k) @ b (k, n)``, output in ``a``'s dtype:
    ``backend`` None asks the planner, ``"classical"`` runs one K2 call,
    ``"strassen"`` the recursion.  Without a gradient to record (serving
    runs under ``no_grad``) it calls the backend directly, past the
    autograd Function."""
    if backend not in (None, "classical", "strassen"):
        raise ValueError(f"unknown matmul backend {backend!r}; expected "
                         "'classical' or 'strassen'")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _Matmul.apply(a, b, backend, cutoff)
    return _run(a, b, backend, cutoff)
