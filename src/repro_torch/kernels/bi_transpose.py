"""K6, the tiled transpose: ``(m, n) -> (n, m)``, exact, for any dtype.

Replaces ``src/repro/kernels/bi_transpose.py:_transpose_kernel`` (entry
``bi_transpose``).  The kernel is ``csrc/bi_transpose.cu``, CUDA C++ for
``sm_90a``; its header says what bounds it on the H100 (bytes) and how the
TPU kernel's Morton-ordered grid of ``bt`` tiles maps onto CUDA blocks.

``bi_transpose(x, bt=None, morton=True)``: ``bt`` (default:
``planner.plan_transpose``) is clamped to each side and must divide both
(``ValueError``, as the JAX ``assert``); the ``bt`` tiles are visited in
Morton order when their grid is square and a power of two and ``morton``
is set (``morton.grid_decode``), else row-major.  The order changes which
block runs where, never the result.

Two instances (:func:`path` names the one a call takes, by layout alone):
``"vec"``, 16-byte loads and stores through an XOR-swizzled shared tile,
where the pointer, both row pitches and both ``bt`` tile edges are whole
16-byte steps; ``"scalar"``, one element per access, for the rest (odd
widths, views off 16 bytes).

A tensor on the CPU takes :func:`transpose_ref`, the plain version (exact,
so it is the oracle as well); a CUDA tensor launches the kernel or raises.
``bi_transpose.launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.morton import supports_morton


def transpose_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version and oracle (``repro.kernels.ref.transpose_ref``): the
    transpose as a fresh row-major tensor, as the kernel returns it."""
    return x.t().contiguous()


INSTANCES = ("scalar", "vec")  # the C entry's instance codes, in order


def tile(instance: str, itemsize: int) -> int:
    """The edge of one CUDA block's sub-tile (``csrc/bi_transpose.cu``): 16
    rows of 16 bytes a side for ``vec``, 32 or 64 elements for ``scalar``."""
    if instance == "vec":
        return 16 * (16 // itemsize)
    return 32 if itemsize >= 4 else 64


def _tiles(x: torch.Tensor, bt) -> tuple[int, int]:
    """``(bt_m, bt_n)``: ``bt`` (default: the planner's) clamped to each side;
    raises where it does not divide both."""
    m, n = x.shape
    if bt is None:
        from repro_torch.kernels import planner

        bt = planner.plan_transpose(m, n, x.dtype, planner.device_params(x.device))["bt"]
    bt_m, bt_n = min(int(bt), m), min(int(bt), n)
    if bt_m <= 0 or m % bt_m or n % bt_n:
        raise ValueError(f"bi_transpose: tile {bt} does not divide both sides of "
                         f"{tuple(x.shape)}")
    return bt_m, bt_n


def path(x: torch.Tensor, bt=None) -> str:
    """The instance a CUDA call on ``x`` (contiguous ``(m, n)``) with tile
    ``bt`` runs: ``"vec"`` where its pointer, both row pitches (``n`` and
    ``m`` elements) and both tile edges are whole 16-byte steps, else
    ``"scalar"``."""
    return _path(x, *_tiles(x, bt))


def _path(x, bt_m, bt_n):
    step = 16 // x.element_size() if x.element_size() in (1, 2, 4, 8) else 0
    if not step or x.data_ptr() % 16:
        return "scalar"
    return "vec" if all(e % step == 0 for e in (*x.shape, bt_m, bt_n)) else "scalar"


def _lib():
    lib = _build.load("bi_transpose")
    fn = lib.bi_transpose
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, I, I, I, I, I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def bi_transpose(x: torch.Tensor, *, bt=None, morton: bool = True,
                 out=None) -> torch.Tensor:
    """``x`` ``(m, n)`` -> ``(n, m)``, into ``out`` (a contiguous ``(n, m)``
    tensor of ``x``'s dtype and device) where given; see the module
    docstring."""
    if x.dim() != 2:
        raise ValueError(f"bi_transpose: x must be (m, n), got {tuple(x.shape)}")
    m, n = x.shape
    if out is not None and (out.shape != (n, m) or out.dtype != x.dtype
                            or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"bi_transpose: out must be a contiguous {(n, m)} {x.dtype} "
                         f"tensor on {x.device}")
    if x.numel() == 0:
        return x.new_empty((n, m)) if out is None else out
    bt_m, bt_n = _tiles(x, bt)
    if x.device.type == "cpu":
        return transpose_ref(x) if out is None else out.copy_(x.t())
    if x.device.type != "cuda":
        raise ValueError(f"bi_transpose: no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"bi_transpose: x must be contiguous, strides {x.stride()}")
    if x.element_size() not in (1, 2, 4, 8):
        raise TypeError(f"bi_transpose: {x.element_size()}-byte elements")
    instance = _path(x, bt_m, bt_n) if out is None or out.data_ptr() % 16 == 0 else "scalar"
    nm, nn = m // bt_m, n // bt_n
    edge = tile(instance, x.element_size())
    blocks = nm * nn * (-(-bt_m // edge)) * (-(-bt_n // edge))
    if blocks >= 2 ** 31:
        raise ValueError(f"bi_transpose: {blocks} CUDA blocks exceed the grid limit")
    if out is None:
        out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib()(x.data_ptr(), out.data_ptr(), m, n, bt_m, bt_n,
                 int(morton and supports_morton(nm, nn)), x.element_size(),
                 INSTANCES.index(instance), stream)
    _build.check(err, "bi_transpose")
    bi_transpose.launches += 1
    return out


bi_transpose.launches = 0
