"""K2, the tiled matmul: ``C = A @ B`` with an f32 accumulator.

Replaces ``src/repro/kernels/hbp_matmul.py:_mm_kernel`` (entry
``hbp_matmul``).  The kernel is ``csrc/hbp_matmul.cu``, CUDA C++ for
``sm_90a``; its header says what bounds it on the H100 (bytes, at every
serving shape) and what the design does about it (skinny tiles for decode,
deterministic split-K, vector loads, B read in either layout).

``hbp_matmul(a, b, out_dtype=None)`` keeps the JAX entry's contract: ``a``
``(m, k)``, ``b`` ``(k, n)``, bf16 or f32, output in ``a``'s dtype unless
``out_dtype`` says otherwise.  Each operand may be a row-major matrix or the
transposed view of a row-major one (``embed.T`` for the tied logits, ``a.T``
for the backward's ``dB = Aᵀ g``); the kernel reads either through its
strides, so neither is copied.  Ragged shapes are masked inside the kernel,
so the JAX wrapper's divisor snapping and its oracle fallback have no
counterpart.

The differentiable entry is ``strassen_matmul.matmul``, the registry's
``matmul`` op: its classical backend is one call of this kernel, forward
and both backward products.

A tensor on the CPU takes :func:`matmul_ref`, the plain version; a CUDA
tensor launches the kernel or raises.  ``hbp_matmul.launches`` counts the
kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BN, BK = 64, 32  # the kernel's output tile width and K step


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Plain version: the product in f32, cast to ``out_dtype`` (default
    ``a``'s dtype), as ``repro.kernels.ref.matmul_ref``."""
    out_dtype = a.dtype if out_dtype is None else out_dtype
    return (a.float() @ b.float()).to(out_dtype)


def plan(m: int, n: int, k: int, sms: int) -> tuple[int, int, int]:
    """(bm, splits, kchunk) for one launch: a 16-row tile when ``a`` has at
    most 16 rows, and split-K when the output tiles alone give fewer than
    four blocks per SM.  Each split keeps at least four K steps; ``kchunk``
    is a multiple of the K step, so no tile straddles two splits."""
    bm = 16 if m <= 16 else 64
    tiles = math.ceil(m / bm) * math.ceil(n / BN)
    k_steps = math.ceil(k / BK)
    splits = max(1, min(math.ceil(4 * sms / tiles), k_steps // 4))
    kchunk = max(1, math.ceil(k_steps / splits)) * BK
    splits = max(1, math.ceil(k / kchunk))
    return bm, splits, kchunk


def _lib():
    lib = _build.load("hbp_matmul")
    fn = lib.hbp_matmul
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, I, I, I, L, L, L, I, I, I, I, I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def _row_stride(x: torch.Tensor):
    """Row stride when ``x`` is row-major (unit column stride), else None."""
    return x.stride(0) if (x.stride(1) == 1 or x.shape[1] == 1) else None


def _layout(x: torch.Tensor, name: str) -> tuple[int, int]:
    """(row stride of the stored matrix, 1 if ``x`` is the transposed view
    of a row-major matrix else 0)."""
    ld = _row_stride(x)
    if ld is not None:
        return ld, 0
    if x.stride(0) != 1 and x.shape[0] != 1:
        raise ValueError(f"hbp_matmul: {name} is neither row-major nor a transposed "
                         f"row-major matrix, strides {x.stride()}")
    return x.stride(1), 1


def hbp_matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """``a (m, k) @ b (k, n)`` with an f32 accumulator; see the module
    docstring."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"hbp_matmul: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODES:
        raise TypeError(f"hbp_matmul: dtypes {a.dtype}, {b.dtype}; "
                        "expected both float32 or both bfloat16")
    out_dtype = a.dtype if out_dtype is None else out_dtype
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"hbp_matmul: out_dtype {out_dtype}")
    if a.device != b.device:
        raise ValueError(f"hbp_matmul: operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return matmul_ref(a, b, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"hbp_matmul: no kernel for device {a.device}")

    m, k = a.shape
    n = b.shape[1]
    lda, trans_a = _layout(a, "a")
    ldb, trans_b = _layout(b, "b")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    bm, splits, kchunk = plan(m, n, k, sms)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
          if splits > 1 else None)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _lib()(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 None if ws is None else ws.data_ptr(), m, n, k, lda, ldb, n,
                 trans_a, trans_b, _DTYPE_CODES[a.dtype], _DTYPE_CODES[out_dtype], bm,
                 splits, kchunk, stream)
    _build.check(err, "hbp_matmul")
    hbp_matmul.launches += 1
    return out


hbp_matmul.launches = 0
