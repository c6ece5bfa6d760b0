"""K2, the tiled matmul: ``C = A @ B`` with an f32 accumulator.

Replaces ``src/repro/kernels/hbp_matmul.py:_mm_kernel`` (entry
``hbp_matmul``).  The kernel is ``csrc/hbp_matmul.cu``, CUDA C++ for
``sm_90a`` (with ``csrc/hopper.cuh``'s TMA, mbarrier and wgmma helpers); its
header says what bounds each instance on the H100 and what the design does
about it.

``hbp_matmul(a, b, out_dtype=None)`` keeps the JAX entry's contract: ``a``
``(m, k)``, ``b`` ``(k, n)``, bf16 or f32, output in ``a``'s dtype unless
``out_dtype`` says otherwise.  Each operand may be a row-major matrix or the
transposed view of a row-major one (``embed.T`` for the tied logits, ``a.T``
for the backward's ``dB = Aᵀ g``); the kernel reads either in its stored
layout, so neither is copied.  Ragged shapes are masked inside the kernel,
so the JAX wrapper's divisor snapping and its oracle fallback have no
counterpart.

:func:`path` picks one of four instances from the dtype, the rows of ``a``
and the operands' layouts: ``"wgmma"`` (bf16, more than 16 rows: a TMA ring
feeding warpgroup MMAs), ``"stream"`` (bf16, at most 16 rows of a row-major
``a``: B streamed through a ``cp.async`` ring into ``mma.sync``, split-K
summed inside a thread-block cluster), ``"wmma"`` (bf16 operands that TMA
cannot describe) and ``"fma"`` (f32).  :func:`plan` sizes the launch for the
instance; both are memoized, and so is the SM count, so a call pays for
neither twice.  ``hbp_matmul(..., plan={"tile_n": ..., "splits": ...})``
overrides the plan's tile width and K splits (the measured autotune's
knobs, ``kernels/autotune.py``); :func:`check_override` says what each
instance takes, and an override it cannot take raises ``ValueError``, on a
CPU tensor too.

**Batched.**  With 3-D operands, ``a (E, m, k) @ b (E, k, n)``, one launch
computes all ``E`` products, ``C[e] = A[e] @ B[e]``: the counterpart of
``_mm_kernel`` under ``jax.vmap`` (the MoE expert products of
``common.expert_project``, where Pallas batching makes the expert axis one
more grid dimension).  Each slab may be row-major or a transposed view, as
above, and the slabs lie a fixed stride apart; the output is a contiguous
``(E, m, n)`` stack.  The instance is picked from one slab as for a 2-D
call (TMA also needs the stride between slabs on 16-byte steps), and the
plan counts the ``E`` slabs' tiles in its wave model; split-K through the
workspace is off for a batched call.

The differentiable entry is ``strassen_matmul.matmul``, the registry's
``matmul`` op: its classical backend is one call of this kernel, forward
and both backward products, batched ones too: ``dA = g Bᵀ`` and ``dB = Aᵀ
g`` per slab, each one batched launch on transposed slab views.  ``Aᵀ g``
contracts over the slab's rows (an MoE expert's capacity, 80 for
``olmoe-1b-7b`` at 512 tokens), so its K need not be a whole number of K
steps: every instance masks the last K step of each slab (zero fill by the
3-D tensor maps for ``wgmma``, per-slab bounds for the others), and never
reads the next slab's rows.

A tensor on the CPU takes :func:`matmul_ref`, the plain version; a CUDA
tensor launches the kernel or raises.  ``hbp_matmul.launches`` counts the
kernel launches, each once, ``hbp_matmul.batched_launches`` those of
batched calls among them and ``hbp_matmul.wmma_launches`` those of the
``wmma`` instance (the untied 256,206-column head's backward products,
whose gradient's row pitch TMA cannot describe).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
INSTANCES = ("wgmma", "stream", "wmma", "fma")  # the C entry's instance codes, in order
STREAM_MAX_M = 16  # the stream instance's rows: one m16 tile of mma.sync
STREAM_MAX_SPLITS = 8  # its split-K is one thread-block cluster (portable size)
# (tile rows, K step) of each instance; wgmma's tile widths, one template each
TILE = {"wgmma": (128, 64), "stream": (16, 64), "wmma": (64, 32), "fma": (128, 16)}
WGMMA_BN = (64, 128, 192, 256)
# the tile widths each instance is built for (a plan override's tile_n)
TILE_N = {"wgmma": WGMMA_BN, "stream": (64,), "wmma": (64,), "fma": (128,)}
# the SMs a plan for a CPU tensor assumes: the H100 SXM's, so a CPU plan is
# the plan the card would run
NOMINAL_SMS = 132
L2_SHARE = 16 * 2 ** 20  # an A this small stays in L2 while every B panel streams by


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Plain version: the product in f32, cast to ``out_dtype`` (default
    ``a``'s dtype), as ``repro.kernels.ref.matmul_ref``; batched over a
    leading axis for 3-D operands."""
    out_dtype = a.dtype if out_dtype is None else out_dtype
    return (a.float() @ b.float()).to(out_dtype)


class Plan(NamedTuple):
    """One launch: the instance's tile (rows, columns), ``splits`` K ranges of
    ``kchunk`` each (whole K steps; the last one ends at K), and ``group`` M
    tiles per column of the raster (wgmma and fma)."""
    tile_m: int
    tile_n: int
    splits: int
    kchunk: int
    group: int


def _k_split(k: int, bk: int, splits: int) -> tuple[int, int]:
    """(splits, kchunk): ``kchunk`` a whole number of K steps, ``splits`` the
    ranges needed to cover ``k`` once."""
    steps = math.ceil(k / bk)
    kchunk = math.ceil(steps / max(1, min(splits, steps))) * bk
    return math.ceil(k / kchunk), kchunk


@functools.lru_cache(maxsize=4096)
def plan(m: int, n: int, k: int, instance: str, sms: int, batch: int = 1) -> Plan:
    """The launch of one product, or of ``batch`` products of this shape in
    one launch, on ``sms`` SMs.  A batch multiplies the tiles of every wave
    model below, and turns off the split-K that goes through the workspace
    (wgmma, wmma, fma): ``batch`` x tiles blocks fill the SMs anyway.

    * ``wgmma``: 128-row tiles; the width (64-256) and split-K that minimise
      a wave model in µs: waves x K steps per split x (width + 32) x 2.6 ns
      (a 128 x 128 x 64 step at ~660 TFLOP/s; the 32 stands for each step's
      A tile and barriers), plus, with split-K, the f32 partials' traffic
      at 3 TB/s and 3 µs for the reduction's launch.  Split-K is tried only
      when a width's tiles leave SMs idle.  The raster's group is every M
      tile when A fits a third of the L2, so each B panel streams from HBM
      once.
    * ``stream``: 64-column tiles, K split over a cluster of up to 8 blocks
      until about 1.5 blocks per SM stream B and no block streams more than
      16 K steps (the split counts ``tools/k2_tiles.py`` measured best on the
      H100 at the decode products, within a few per cent).
    * ``wmma`` (the first port's plan): 16- or 64-row tiles, split-K while
      the tiles give fewer than four blocks per SM.
    * ``fma``: 128 x 128 tiles, split-K while the tiles leave SMs idle, four
      K steps per split at least.
    """
    bm, bk = TILE[instance]
    steps = math.ceil(k / bk)
    tiles_m = math.ceil(m / bm)
    may_split = batch == 1
    if instance == "wgmma":
        group = tiles_m if m * k * 2 <= L2_SHARE else min(tiles_m, 8)
        best = None
        for bn in WGMMA_BN:
            tiles = batch * tiles_m * math.ceil(n / bn)
            for want in {1, min(sms // tiles, steps // 4) if tiles < sms and may_split else 1}:
                splits, kchunk = _k_split(k, bk, max(want, 1))
                us = math.ceil(tiles * splits / sms) * (kchunk // bk) * (bn + 32) * 2.6e-3
                if splits > 1:
                    us += (2 * splits + 1) * m * n * 4 / 3e6 + 3.0
                if best is None or us < best[0]:
                    best = (us, Plan(bm, bn, splits, kchunk, group))
        return best[1]
    if instance == "stream":
        bn = 64
        tiles = batch * math.ceil(n / bn)
        want = max(math.ceil(1.5 * sms / tiles), math.ceil(steps / 16))
        splits, kchunk = _k_split(k, bk, min(STREAM_MAX_SPLITS, want))
        return Plan(bm, bn, splits, kchunk, 1)
    if instance == "wmma":
        bm = 16 if m <= 16 else 64
        tiles = math.ceil(m / bm) * math.ceil(n / 64)
        want = min(math.ceil(4 * sms / tiles), steps // 4) if may_split else 1
        splits, kchunk = _k_split(k, bk, max(1, want))
        return Plan(bm, 64, splits, kchunk, 1)
    if instance == "fma":
        tiles = tiles_m * math.ceil(n / 128)
        want = min(math.ceil(sms / tiles), steps // 4) if may_split else 1
        splits, kchunk = _k_split(k, bk, max(1, want))
        return Plan(bm, 128, splits, kchunk, min(tiles_m, 8))
    raise ValueError(f"hbp_matmul: no instance {instance!r}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The SMs a plan on ``device`` counts: the card's, or
    :data:`NOMINAL_SMS` for a CPU tensor."""
    device = torch.device(device)
    if device.type != "cuda":
        return NOMINAL_SMS
    return _sm_count(torch.cuda.current_device() if device.index is None else device.index)


def check_override(m: int, n: int, k: int, instance: str, batch: int, override) -> dict:
    """The plan override ``{"tile_n": ..., "splits": ...}`` (either key may
    be missing or None) validated against the instance it would change;
    returns the keys that are set.  Raises ``ValueError`` where the
    instance cannot take it: a ``tile_n`` it was not built for
    (:data:`TILE_N`: wgmma's 64-256, 64 for stream and wmma, 128 for fma),
    ``splits`` that is not a positive int, more K splits than the product
    has K steps, more than :data:`STREAM_MAX_SPLITS` (one cluster) for
    stream, or a workspace split-K (wgmma, wmma, fma) on a batched call."""
    unknown = set(override) - {"tile_n", "splits"}
    if unknown:
        raise ValueError(f"hbp_matmul: plan keys {sorted(unknown)}; expected tile_n, splits")
    got = {key: v for key, v in override.items() if v is not None}
    tile_n, splits = got.get("tile_n"), got.get("splits")
    if tile_n is not None and tile_n not in TILE_N[instance]:
        raise ValueError(f"hbp_matmul: tile_n {tile_n!r} on the {instance} instance, "
                         f"which is built for {TILE_N[instance]}")
    if splits is not None:
        steps = math.ceil(k / TILE[instance][1])
        if isinstance(splits, bool) or not isinstance(splits, int) or splits < 1:
            raise ValueError(f"hbp_matmul: splits {splits!r}; expected an int >= 1")
        if splits > max(steps, 1):
            raise ValueError(f"hbp_matmul: {splits} K splits of a product with {steps} "
                             f"K steps on the {instance} instance")
        if instance == "stream" and splits > STREAM_MAX_SPLITS:
            raise ValueError(f"hbp_matmul: {splits} K splits on the stream instance, "
                             f"whose split-K is one cluster of at most {STREAM_MAX_SPLITS}")
        if instance != "stream" and batch > 1 and splits > 1:
            raise ValueError(f"hbp_matmul: {splits} K splits on a batched {instance} "
                             "call, which has no workspace split-K")
    return got


def launch_plan(m: int, n: int, k: int, instance: str, sms: int, batch: int = 1,
                override=None) -> Plan:
    """:func:`plan`, with a validated override of its ``tile_n`` and
    ``splits`` (:func:`check_override`; ``splits`` is rounded to whole K
    steps a split, as the plan's own are).  Memoized per override."""
    if not override:
        return plan(m, n, k, instance, sms, batch)
    return _overridden(m, n, k, instance, sms, batch, tuple(sorted(override.items())))


@functools.lru_cache(maxsize=4096)
def _overridden(m, n, k, instance, sms, batch, override) -> Plan:
    p = plan(m, n, k, instance, sms, batch)
    got = check_override(m, n, k, instance, batch, dict(override))
    if "tile_n" in got:
        p = p._replace(tile_n=got["tile_n"])
    if "splits" in got:
        splits, kchunk = _k_split(k, TILE[instance][1], got["splits"])
        p = p._replace(splits=splits, kchunk=kchunk)
    return p


def _lib():
    lib = _build.load("hbp_matmul")
    fn = lib.hbp_matmul
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, I, I, I, L, L, I, I, I, I, I, I, I, I, I, I, I, L, L, P]
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


def _slab(x: torch.Tensor) -> torch.Tensor:
    """The first matrix of a batched operand (the matrix itself if 2-D): a
    view with the slabs' layout and the stack's base."""
    return x.as_strided(x.shape[-2:], x.stride()[-2:]) if x.dim() == 3 else x


def _tma_layout(x: torch.Tensor, name: str) -> bool:
    """Whether TMA (and 16-byte ``cp.async``) can read ``x`` in its stored
    layout: a 16-byte aligned base and a row pitch of whole 16-byte steps,
    and for a batched operand a stride between slabs of whole 16-byte
    steps."""
    ld, _ = _layout(_slab(x), name)
    es = x.element_size()
    batch_ok = x.dim() == 2 or (x.stride(0) > 0 and (x.stride(0) * es) % 16 == 0)
    return x.data_ptr() % 16 == 0 and (ld * es) % 16 == 0 and batch_ok


def path(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> str:
    """The instance a CUDA call on these operands runs: ``"fma"`` for f32;
    for bf16, ``"wmma"`` when TMA cannot describe ``a`` or ``b``
    (:func:`_tma_layout`), else ``"stream"`` when ``a`` is row-major with
    at most 16 rows (per slab, for a batched call), else ``"wgmma"``.
    Every instance writes either output dtype, so ``out_dtype`` does not
    change the choice."""
    del out_dtype
    if a.dtype == torch.float32:
        return "fma"
    if not (_tma_layout(a, "a") and _tma_layout(b, "b")):
        return "wmma"
    if a.shape[-2] <= STREAM_MAX_M and not _layout(_slab(a), "a")[1]:
        return "stream"
    return "wgmma"


def hbp_matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
               plan=None) -> torch.Tensor:
    """``a (m, k) @ b (k, n)``, or ``a (E, m, k) @ b (E, k, n)`` in one
    launch, with an f32 accumulator; see the module docstring.  ``plan``:
    an override of the launch's ``tile_n`` and ``splits`` (the autotune's
    knobs), validated against the instance on a CPU tensor too
    (:func:`check_override`)."""
    batched = a.dim() == 3
    if (a.dim() not in (2, 3) or b.dim() != a.dim() or a.shape[-1] != b.shape[-2]
            or (batched and a.shape[0] != b.shape[0])):
        raise ValueError(f"hbp_matmul: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODES:
        raise TypeError(f"hbp_matmul: dtypes {a.dtype}, {b.dtype}; "
                        "expected both float32 or both bfloat16")
    out_dtype = a.dtype if out_dtype is None else out_dtype
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"hbp_matmul: out_dtype {out_dtype}")
    if a.device != b.device:
        raise ValueError(f"hbp_matmul: operands on {a.device} and {b.device}")
    m, k = a.shape[-2:]
    n = b.shape[-1]
    batch = a.shape[0] if batched else 1
    if a.device.type == "cpu":
        if plan:
            launch_plan(m, n, k, path(a, b), NOMINAL_SMS, batch, plan)  # validates it
        return matmul_ref(a, b, out_dtype)
    if a.device.type == "meta":  # the shape alone: the dry run's trace
        return torch.empty((*a.shape[:-2], m, n), dtype=out_dtype, device="meta")
    if a.device.type != "cuda":
        raise ValueError(f"hbp_matmul: no kernel for device {a.device}")

    out = torch.empty((*a.shape[:-2], m, n), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    lda, trans_a = _layout(_slab(a), "a")
    ldb, trans_b = _layout(_slab(b), "b")
    sa, sb = (a.stride(0), b.stride(0)) if batched else (0, 0)
    instance = path(a, b)
    p = launch_plan(m, n, k, instance, _sm_count(a.device.index or 0), batch, plan)
    ws = (torch.empty((p.splits, m, n), dtype=torch.float32, device=a.device)
          if p.splits > 1 and instance != "stream" else None)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _lib()(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 None if ws is None else ws.data_ptr(), m, n, k, lda, ldb, trans_a, trans_b,
                 _DTYPE_CODES[a.dtype], _DTYPE_CODES[out_dtype], INSTANCES.index(instance),
                 p.tile_m, p.tile_n, p.splits, p.kchunk, p.group, batch, sa, sb, stream)
    _build.check(err, "hbp_matmul")
    hbp_matmul.launches += 1
    if batched:
        hbp_matmul.batched_launches += 1
    if instance == "wmma":
        hbp_matmul.wmma_launches += 1
    return out


hbp_matmul.launches = 0
hbp_matmul.batched_launches = 0
hbp_matmul.wmma_launches = 0
