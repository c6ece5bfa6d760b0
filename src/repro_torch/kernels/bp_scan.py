"""K5, the blocked prefix scan: inclusive prefix sum along the last axis.

Replaces ``src/repro/kernels/bp_scan.py:_scan_block_kernel`` and
``:_add_offset_kernel`` (entry ``bp_scan``).  The kernel is
``csrc/bp_scan.cu``, CUDA C++ for ``sm_90a``; its header says what bounds
it on the H100 (bytes) and how a planner leaf that spans many CUDA blocks
is scanned (three launches).

``bp_scan(x, block=None)`` keeps the TPU kernel's leaf structure: ``x``
``(rows, n)`` f32 or bf16 is cut into leaves of ``block`` elements
(default: ``planner.plan_scan``); inside a leaf the prefix runs in f32 and
is rounded to ``x``'s dtype, then the exclusive f32 sum of the earlier
leaves' f32 totals is added and the result rounded again.  At bf16 that is
two roundings where the oracle :func:`bp_scan_ref` makes one, so the two
differ by up to an ulp.  ``block`` must divide ``n`` (``ValueError``, as
the JAX ``assert``).

A tensor on the CPU takes :func:`bp_scan_plain`, the same leaf-structured
function in plain torch; a CUDA tensor launches the kernel or raises.
``bp_scan.launches`` counts the wrapper's kernel calls (three launches
each).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 4096  # elements per CUDA block, csrc/bp_scan.cu's TILE


def bp_scan_ref(x: torch.Tensor) -> torch.Tensor:
    """The oracle (``repro.kernels.ref.bp_scan_ref``): one f32 cumsum, one
    rounding to ``x``'s dtype."""
    return torch.cumsum(x.float(), dim=-1).to(x.dtype)


def bp_scan_plain(x: torch.Tensor, block: int) -> torch.Tensor:
    """Plain version of the kernel: the leaf-structured scan in plain torch,
    step for step as the TPU kernel (``bp_scan.py:26-35, 66``)."""
    rows, n = x.shape
    c = torch.cumsum(x.float().reshape(rows, n // block, block), dim=-1)
    local = c.to(x.dtype)
    totals = c[..., -1]
    offsets = torch.cumsum(totals, dim=-1) - totals
    return (local.float() + offsets[..., None]).to(x.dtype).reshape(rows, n)


def _lib():
    lib = _build.load("bp_scan")
    fn = lib.bp_scan
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, L, I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def bp_scan(x: torch.Tensor, *, block=None) -> torch.Tensor:
    """Inclusive prefix sum of ``x`` ``(rows, n)`` along its last axis; see
    the module docstring."""
    if x.dim() != 2:
        raise ValueError(f"bp_scan: x must be (rows, n), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"bp_scan: dtype {x.dtype}; expected float32 or bfloat16")
    rows, n = x.shape
    if x.numel() == 0:
        return x.clone()
    if block is None:
        from repro_torch.kernels import planner

        block = planner.plan_scan(x.shape, x.dtype, planner.device_params(x.device))["block"]
    block = min(int(block), n)
    if block <= 0 or n % block != 0:
        raise ValueError(f"bp_scan: leaf size {block} does not divide n = {n}")
    if x.device.type == "cpu":
        return bp_scan_plain(x, block)
    if x.device.type != "cuda":
        raise ValueError(f"bp_scan: no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"bp_scan: x must be contiguous, strides {x.stride()}")
    nleaves = n // block
    pieces = rows * nleaves * (-(-block // TILE))
    if pieces >= 2 ** 31:
        raise ValueError(f"bp_scan: {pieces} CUDA blocks exceed the grid limit")
    out = torch.empty_like(x)
    ws = torch.empty(2 * pieces + rows * nleaves, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib()(x.data_ptr(), out.data_ptr(), ws.data_ptr(), rows, n, block,
                 _DTYPE_CODES[x.dtype], stream)
    _build.check(err, "bp_scan")
    bp_scan.launches += 1
    return out


bp_scan.launches = 0
