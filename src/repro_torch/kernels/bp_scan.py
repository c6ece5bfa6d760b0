"""K5, the blocked prefix scan: inclusive prefix sum along the last axis.

Replaces ``src/repro/kernels/bp_scan.py:_scan_block_kernel`` and
``:_add_offset_kernel`` (entry ``bp_scan``).  The kernel is
``csrc/bp_scan.cu``, CUDA C++ for ``sm_90a``: a single-pass chained scan
(tiles handed out in order by a counter, each tile's inclusive prefix its
predecessor's plus its own aggregate, so the association is fixed); its
header says what bounds it on the H100 (bytes) and how.

``bp_scan(x, block=None)`` keeps the TPU kernel's leaf structure: ``x``
``(rows, n)`` f32 or bf16 is cut into leaves of ``block`` elements
(default: ``planner.plan_scan``); inside a leaf the prefix runs in f32 and
is rounded to ``x``'s dtype, then the exclusive f32 sum of the earlier
leaves' f32 totals is added and the result rounded again.  At bf16 that is
two roundings where the oracle :func:`bp_scan_ref` makes one, so the two
differ by up to an ulp.  ``block`` must divide ``n`` (``ValueError``, as
the JAX ``assert``).  ``x`` may be a view with rows ``x.stride(0)`` apart
(unit column stride); the output is contiguous.

:func:`path` names the instance a CUDA call takes: ``"vec"`` (16-byte
loads and stores) where the pointer, the row pitch and the leaf edge are
whole 16-byte steps, ``"scalar"`` for the rest (same chunks and
association, so the same bits).  A row of one leaf is one launch; several
leaves a row add a second, which adds each leaf's offset.

A tensor on the CPU takes :func:`bp_scan_plain`, the same leaf-structured
function in plain torch; a CUDA tensor launches the kernel or raises.
``bp_scan.launches`` counts the wrapper's calls of the C entry.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
INSTANCES = ("scalar", "vec")
THREADS = 256  # csrc/bp_scan.cu's block
# 16-byte chunks a thread holds (csrc/bp_scan.cu's R: 4, 8 or 16), read at
# call time: 64 KB tiles in f32, 32 KB in bf16 (tools/k4_k5.py timed both
# dtypes at 4, 8 and 16 on the H100)
ROUNDS = {torch.float32: 16, torch.bfloat16: 8}


def tile(dtype) -> int:
    """Elements in one CUDA block's tile at ``dtype``: 256 threads x
    ``ROUNDS[dtype]`` chunks of 16 bytes."""
    return THREADS * ROUNDS[dtype] * (16 // dtype.itemsize)


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
        fn.argtypes = [P, P, P, L, I, I, L, I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def _leaf(x: torch.Tensor, block) -> int:
    """The leaf edge a call runs: ``block`` (default the planner's), clamped
    to ``n``; raises where it does not divide ``n``."""
    n = x.shape[1]
    if block is None:
        from repro_torch.kernels import planner

        block = planner.plan_scan(x.shape, x.dtype, planner.device_params(x.device))["block"]
    block = min(int(block), n)
    if block <= 0 or n % block != 0:
        raise ValueError(f"bp_scan: leaf size {block} does not divide n = {n}")
    return block


def _pitch(x: torch.Tensor) -> int:
    if x.stride(1) != 1 and x.shape[1] != 1:
        raise ValueError(f"bp_scan: x must have unit column stride, strides {x.stride()}")
    return x.stride(0) if x.shape[0] > 1 else x.shape[1]


def path(x: torch.Tensor, block=None) -> str:
    """The instance a CUDA call on ``x`` with leaf ``block`` runs: ``"vec"``
    where the pointer, the row pitch and the leaf edge are whole 16-byte
    steps, else ``"scalar"``."""
    return _path(x, _leaf(x, block))


def _path(x, block):
    step = 16 // x.element_size()
    aligned = x.data_ptr() % 16 == 0 and _pitch(x) % step == 0 and block % step == 0
    return "vec" if aligned else "scalar"


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
    block = _leaf(x, block)
    if x.device.type == "cpu":
        return bp_scan_plain(x, block)
    if x.device.type != "cuda":
        raise ValueError(f"bp_scan: no kernel for device {x.device}")
    pitch = _pitch(x)
    segs = rows * (n // block)
    tiles = segs * (-(-block // tile(x.dtype)))
    if tiles >= 2 ** 31:
        raise ValueError(f"bp_scan: {tiles} CUDA blocks exceed the grid limit")
    out = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    ws = torch.empty(8 + 8 * (tiles + segs) + 4 * segs, dtype=torch.uint8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib()(x.data_ptr(), out.data_ptr(), ws.data_ptr(), rows, n, block, pitch,
                 _DTYPE_CODES[x.dtype], INSTANCES.index(_path(x, block)), ROUNDS[x.dtype],
                 stream)
    _build.check(err, "bp_scan")
    bp_scan.launches += 1
    return out


bp_scan.launches = 0
