"""K4, the Strassen-schedule matmul, and the registry's ``matmul`` entry.

Replaces ``src/repro/kernels/strassen_matmul.py:strassen_matmul`` and
``:matmul``.  For f32 operands the kernel is ``csrc/strassen_matmul.cu``,
CUDA C++ for ``sm_90a``: up to two levels of the recursion in one launch,
each leaf product forming its operand sums as it loads them and adding its
result into its C targets (its header says what bounds it and how).  bf16
operands keep the composition over K2 (``hbp_matmul``'s tensor-core
instances), as the JAX recursion runs on the Pallas ``hbp_matmul``.

:func:`strassen_matmul` recurses the 7-product quadrant decomposition
(``_STRASSEN_LHS/RHS/OUT`` with the sign tables below) while the edge is
even and above ``cutoff`` (default: ``planner.strassen_cutoff``): operand
combinations are summed in f32 and rounded to the input dtype right before
their leaf, output combinations stay in f32, and only the final result is
rounded.  Any other shape falls through to one K2 call.

* f32 on CUDA: :func:`leaf_plan` lists the ``7 ** levels`` leaves of (at
  most) two levels, each with its signed operand terms and its signed C
  targets as element offsets (memoized per edge, levels and strides), and
  one kernel launch runs them all.  A third level and beyond keep the
  composition's combination step (:func:`_strassen`) for the outer levels,
  each of whose products is one fused launch.  Transposed views (the
  backward's ``g Bᵀ`` and ``Aᵀ g``) are read in place.
* bf16 on CUDA: the recursion with K2 leaves (an f32 output each) and
  plain-torch combinations, as before.

:func:`matmul` is the differentiable entry the registry dispatches: it asks
the planner for the backend (``classical``: one K2 call; ``strassen``: the
recursion) and its backward re-plans each of ``dA = g Bᵀ`` and
``dB = Aᵀ g`` on its own shape, as the JAX custom VJP does.  A batched
``(E, m, k) @ (E, k, n)`` call is one batched K2 launch (Strassen is 2-D
only), and so is each of its two backward products.

On the CPU :func:`strassen_matmul` runs :func:`strassen_matmul_plain`, the
recursion with ``matmul_ref`` leaves (also the card's comparisons);
:func:`leaf_plan_plain` evaluates the kernel's leaf table with
``matmul_ref`` leaves in the kernel's order.  ``strassen_matmul.launches``
counts the fused kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
import importlib
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build

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


# -- the fused kernel's leaf table -------------------------------------------------

FUSED_LEVELS = 2  # levels one launch runs (csrc/strassen_matmul.cu's MAX_LEAVES = 7^2)
_QUAD = ((0, 0), (0, 1), (1, 0), (1, 1))  # quadrants 11, 12, 21, 22 as (row, col)
# csrc/strassen_matmul.cu's Leaf, 160 bytes
_LEAF = np.dtype([("a", "<i8", 4), ("b", "<i8", 4), ("c", "<i8", 4), ("sa", "<f4", 4),
                  ("sb", "<f4", 4), ("sc", "<f4", 4), ("na", "<i4"), ("nb", "<i4"),
                  ("nc", "<i4"), ("first", "<i4")])
_TABLES: dict = {}  # (leaf_plan's key, device) -> the packed table on that device


@functools.lru_cache(maxsize=64)
def leaf_plan(n: int, levels: int, a_stride, b_stride, c_stride):
    """The leaves of ``levels`` Strassen levels of an ``n x n`` product, in
    the kernel's order (products of the outer level slowest): a tuple of
    ``(a_terms, b_terms, c_targets)``.  A term is ``(offset, sign)``, the
    element offset of its ``n >> levels`` sub-block from the operand's
    origin under the operand's strides; terms run level one's pair fastest,
    so adding neighbours pairwise, ``((t0 + t1) + (t2 + t3))``, is the
    plain version's association.  A target is ``(offset, sign, first)``:
    ``first`` where no earlier leaf writes that C sub-block."""
    nodes = [(((0, 0, 1),), ((0, 0, 1),), ((0, 0, 1),))]
    edge = n
    for _ in range(levels):
        edge //= 2
        nxt = []
        for at, bt, ct in nodes:
            for p in range(7):
                def terms(old, idxs, signs):
                    return tuple((r + _QUAD[q][0] * edge, c + _QUAD[q][1] * edge, s * sq)
                                 for q, sq in zip(idxs, signs) for r, c, s in old)
                cn = tuple((r + _QUAD[q][0] * edge, c + _QUAD[q][1] * edge,
                            s * _OUT_SIGNS[q][_STRASSEN_OUT[q].index(p)])
                           for r, c, s in ct for q in range(4) if p in _STRASSEN_OUT[q])
                nxt.append((terms(at, _STRASSEN_LHS[p], _LHS_SIGNS[p]),
                            terms(bt, _STRASSEN_RHS[p], _RHS_SIGNS[p]), cn))
        nodes = nxt
    seen, leaves = set(), []
    for at, bt, ct in nodes:
        def offs(ts, st):
            return tuple((r * st[0] + c * st[1], s) for r, c, s in ts)
        tg = []
        for r, c, s in ct:
            tg.append((r * c_stride[0] + c * c_stride[1], s, (r, c) not in seen))
            seen.add((r, c))
        leaves.append((offs(at, a_stride), offs(bt, b_stride), tuple(tg)))
    return tuple(leaves)


def _sub(x: torch.Tensor, off: int, e: int) -> torch.Tensor:
    return x.as_strided((e, e), x.stride(), x.storage_offset() + off)


def _tree(parts):
    """Neighbours added pairwise, level by level (a power-of-two count)."""
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


def leaf_plan_plain(a: torch.Tensor, b: torch.Tensor, levels: int) -> torch.Tensor:
    """The kernel's leaf table evaluated in torch for f32 operands: each
    leaf's operand sums by :func:`_tree`, its ``matmul_ref`` product, added
    into its targets in the table's order (the first writer stores)."""
    n = a.shape[0]
    e = n >> levels
    c = torch.empty((n, n), dtype=torch.float32, device=a.device)
    for at, bt, ct in leaf_plan(n, levels, a.stride(), b.stride(), c.stride()):
        x = _tree([s * _sub(a, o, e).float() for o, s in at])
        y = _tree([s * _sub(b, o, e).float() for o, s in bt])
        m = matmul_ref(x, y, torch.float32)
        for o, s, first in ct:
            dst = _sub(c, o, e)
            if first:
                dst.copy_(s * m)
            else:
                dst.add_(s * m)
    return c


def _table(plan, device) -> torch.Tensor:
    key = (plan, device)
    hit = _TABLES.get(key)
    if hit is None:
        rec = np.zeros(len(plan), dtype=_LEAF)
        for i, (at, bt, ct) in enumerate(plan):
            for name, terms in (("a", at), ("b", bt)):
                rec[name][i, :len(terms)] = [o for o, _ in terms]
                rec["s" + name][i] = 1.0
                rec["s" + name][i, :len(terms)] = [s for _, s in terms]
            rec["c"][i, :len(ct)] = [o for o, _, _ in ct]
            rec["sc"][i, :len(ct)] = [s for _, s, _ in ct]
            rec["na"][i], rec["nb"][i], rec["nc"][i] = len(at), len(bt), len(ct)
            rec["first"][i] = sum(1 << t for t, (_, _, f) in enumerate(ct) if f)
        hit = torch.from_numpy(rec.view(np.uint8).copy()).to(device)
        _TABLES[key] = hit
    return hit


def _fused_lib():
    lib = _build.load("strassen_matmul")
    fn = lib.strassen_matmul
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, I, I, I, L, L, L, I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def path(a: torch.Tensor, b: torch.Tensor, cutoff: Optional[int] = None) -> str:
    """The fused kernel's instance for these f32 operands: ``"vec"`` (TMA
    boxes of the stored matrices) where both pointers are 16-byte aligned,
    both row strides are multiples of 4 elements and the leaf edge of 16,
    else ``"scalar"``.  The leaf edge is ``n >> levels`` (``levels`` from
    ``cutoff``, the planner's by default); an outer level past the two a
    launch runs hands the launch a fresh combination or a quadrant view,
    whose layout this does not see."""
    n = a.shape[0]
    return _path(a, b, n >> min(_levels(n, _cutoff(a, cutoff)), FUSED_LEVELS))


def _path(a, b, e):
    lds = (_k2._layout(a, "a")[0], _k2._layout(b, "b")[0])
    ok = (a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0 and e % 16 == 0
          and all(ld % 4 == 0 for ld in lds))
    return "vec" if ok else "scalar"


def _fused(a: torch.Tensor, b: torch.Tensor, levels: int) -> torch.Tensor:
    """One launch of ``levels`` (1 or 2) fused Strassen levels: f32 ``a @ b``."""
    n = a.shape[0]
    e = n >> levels
    lda, trans_a = _k2._layout(a, "a")
    ldb, trans_b = _k2._layout(b, "b")
    c = torch.empty((n, n), dtype=torch.float32, device=a.device)
    plan = leaf_plan(n, levels, a.stride(), b.stride(), c.stride())
    table = _table(plan, a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _fused_lib()(a.data_ptr(), b.data_ptr(), c.data_ptr(), table.data_ptr(), len(plan),
                       e, n, lda, ldb, n, trans_a, trans_b, int(_path(a, b, e) == "vec"), stream)
    _build.check(err, "strassen_matmul")
    strassen_matmul.launches += 1
    return c


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


def _levels(n: int, cutoff: int) -> int:
    levels = 0
    while n > cutoff and n % 2 == 0:
        n, levels = n // 2, levels + 1
    return levels


def strassen_matmul(a: torch.Tensor, b: torch.Tensor, *,
                    cutoff: Optional[int] = None) -> torch.Tensor:
    """``a @ b`` through the Strassen recursion; see the module docstring."""
    _check(a, b)
    cutoff = _cutoff(a, cutoff)
    if not _eligible(a, b, cutoff):
        return _k2.hbp_matmul(a, b)
    if a.device.type == "cpu":
        return strassen_matmul_plain(a, b, cutoff=cutoff)
    if a.device.type == "meta":  # the shape alone: the dry run's trace
        return torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype, device="meta")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        return _strassen(a, b, cutoff,
                         lambda x, y: _k2.hbp_matmul(x, y, out_dtype=torch.float32))
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"strassen_matmul: no kernel for devices {a.device}, {b.device}")
    n = a.shape[0]
    levels = _levels(n, cutoff)
    inner = min(levels, FUSED_LEVELS)
    if levels == inner:
        return _fused(a, b, inner)
    # the outer levels as the composition's combination step, each product
    # one fused launch of the inner levels
    return _strassen(a, b, n >> (levels - inner), lambda x, y: _fused(x, y, inner))


strassen_matmul.launches = 0


def strassen_matmul_plain(a: torch.Tensor, b: torch.Tensor, *,
                          cutoff: Optional[int] = None) -> torch.Tensor:
    """Plain version: the same recursion with ``matmul_ref`` leaves."""
    _check(a, b)
    cutoff = _cutoff(a, cutoff)
    if not _eligible(a, b, cutoff):
        return matmul_ref(a, b)
    return _strassen(a, b, cutoff, lambda x, y: matmul_ref(x, y, torch.float32))


def _run(a, b, backend, cutoff, k2_plan=None, out_dtype=None):
    """Run the backend (None: ask the planner for this shape); a batched
    product is one batched K2 call.  ``k2_plan``: an override of the
    classical backend's K2 plan (``hbp_matmul(..., plan=)``).  An
    ``out_dtype`` other than ``a``'s is one classical K2 call writing it
    (its f32 sums unrounded)."""
    if out_dtype is not None and out_dtype != a.dtype:
        if backend == "strassen":
            raise ValueError(f"matmul: out_dtype {out_dtype} on the strassen backend")
        return _k2.hbp_matmul(a, b, plan=k2_plan, out_dtype=out_dtype)
    if a.dim() == 3:
        if backend not in (None, "classical"):
            raise ValueError(f"matmul: backend {backend!r} takes 2-D operands; a "
                             "batched product runs on the classical backend")
        return _k2.hbp_matmul(a, b, plan=k2_plan)
    if backend is None:
        from repro_torch.kernels import planner

        plan = planner.plan_matmul_backend(a.shape[0], a.shape[1], b.shape[1], a.dtype,
                                           planner.device_params(a.device))
        backend = plan["backend"]
        if cutoff is None:
            cutoff = plan.get("cutoff")
    if backend == "strassen":
        if k2_plan:
            raise ValueError(f"matmul: K2 plan {k2_plan} on the strassen backend; "
                             "tile_n and splits set the classical backend's one K2 call")
        return strassen_matmul(a, b, cutoff=cutoff)
    return _k2.hbp_matmul(a, b, plan=k2_plan)


class _Matmul(torch.autograd.Function):
    """``a @ b`` on the chosen backend, with the JAX custom VJP's backward
    (``strassen_matmul.py:119-139``): ``dA = g Bᵀ`` and ``dB = Aᵀ g``, each
    re-planned for its own shape (the transposes are views K2 reads in
    place), each cast to its operand's dtype.  A batched product, ``a (E, m,
    k) @ b (E, k, n)``, transposes each slab (``mT``): each gradient is one
    batched K2 launch over every slab, as the JAX VJP under ``jax.vmap``
    gives one batched Pallas call, accumulated in f32.  ``dB = Aᵀ g``
    contracts over the slab's ``m`` rows (an expert's capacity), which K2
    masks per slab like any ragged K.  ``matmul.batched_backward_launches``
    counts those launches on the card (K2's own counters count them too).
    A K2 plan override reaches the forward product only; the backward's
    products re-plan, as the JAX VJP does (``strassen_matmul.py:132-135``)."""

    @staticmethod
    def forward(ctx, a, b, backend, cutoff, k2_plan, out_dtype):
        ctx.save_for_backward(a, b)
        return _run(a, b, backend, cutoff, k2_plan, out_dtype)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype).contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _run(g, b.mT, None, None).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = _run(a.mT, g, None, None).to(b.dtype)
        if a.dim() == 3 and a.device.type == "cuda":
            matmul.batched_backward_launches += (da is not None) + (db is not None)
        return da, db, None, None, None, None


def matmul(a: torch.Tensor, b: torch.Tensor, *, backend: Optional[str] = None,
           cutoff: Optional[int] = None, tile_n: Optional[int] = None,
           splits: Optional[int] = None, out_dtype=None) -> torch.Tensor:
    """Differentiable ``a (m, k) @ b (k, n)``, or ``a (E, m, k) @ b (E, k,
    n)`` as one batched K2 call, output in ``a``'s dtype (or ``out_dtype``:
    one classical K2 call writing f32 sums, a row-parallel product's
    partials before their all-reduce; the gradient comes back in ``a``'s
    dtype, as from an output in it): ``backend`` None
    asks the planner, ``"classical"`` runs one K2 call, ``"strassen"`` the
    recursion (2-D only).  ``tile_n`` and ``splits`` override the classical
    backend's K2 plan for the forward product (``hbp_matmul``'s ``plan``;
    an override the instance cannot take, or one on the strassen backend,
    raises ``ValueError``).  Without a gradient to record (serving runs
    under ``no_grad``) it calls the backend directly, past the autograd
    Function."""
    if backend not in (None, "classical", "strassen"):
        raise ValueError(f"unknown matmul backend {backend!r}; expected "
                         "'classical' or 'strassen'")
    k2_plan = ({key: v for key, v in (("tile_n", tile_n), ("splits", splits))
                if v is not None} or None)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _Matmul.apply(a, b, backend, cutoff, k2_plan, out_dtype)
    return _run(a, b, backend, cutoff, k2_plan, out_dtype)


matmul.batched_backward_launches = 0  # the batched K2 launches of batched backwards
