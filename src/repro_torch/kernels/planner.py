"""Resource-oblivious tile planner: the port's copy of
``repro.kernels.planner``.

No kernel signature carries a hard-coded tile size: the registry derives
the tile kwargs from the queried device's fast-memory size M and line size
B through the ``repro_torch.core.costmodel`` envelopes.

Which M the port reads: a CUDA device's L2 cache
(``torch.cuda.get_device_properties(d).L2_cache_size``, 50 MiB on the H100)
with 128-byte lines.  The tiles sized here (the scan leaf, the transpose
tile grid, the Strassen cutoff) are the working sets of whole launches of
many blocks, whose reuse lives in L2; each CUDA kernel sizes its own
per-block tile in shared memory (as ``hbp_matmul.plan`` does).  A CPU
device gets exactly the JAX planner's CPU parameters (8 MiB, 64-byte
lines, lane 128), so every plan function returns the same dict as the JAX
one for the same shape, which the CPU tests check.  ``REPRO_FAST_BYTES``
overrides M on either.

Every plan function takes a torch dtype or a dtype name (``'float32'``)
and returns a dict of tile kwargs, each tile an exact divisor of its
dimension.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core import costmodel

# Lane width (last-dim tiling) in elements, as the JAX planner's.
LANE = 128

# Fast-memory sizes when the device reports nothing better (the JAX
# planner's table); a CUDA device reports its L2.
# the H100 SXM's L2, 50 MB (NVIDIA H100 Tensor Core GPU Architecture
# whitepaper): a ``meta`` tensor's fast memory, so the dry run's traces plan
# as the card does
H100_L2_BYTES = 50 * 2**20

_DEFAULT_FAST_BYTES = {"tpu": 16 * 2**20, "cpu": 8 * 2**20, "gpu": 16 * 2**20}

# Block-transfer granularity B (bytes): a cache line on the CPU, an L2 line
# on the GPU.
_DEFAULT_LINE_BYTES = {"tpu": 512, "cpu": 64, "gpu": 128}


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or its name (``'bfloat16'``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    d = getattr(torch, str(dtype), None)
    if not isinstance(d, torch.dtype):
        raise TypeError(f"unknown dtype {dtype!r}")
    return d


def _itemsize(dtype) -> int:
    return as_dtype(dtype).itemsize


def _dtype_name(dtype) -> str:
    return str(as_dtype(dtype)).removeprefix("torch.")


@dataclass(frozen=True)
class DeviceParams:
    """The queried machine parameters the planner is oblivious about."""

    platform: str
    kind: str
    fast_bytes: int  # M: fast-memory capacity the tiles must fit in
    line_bytes: int  # B: block-transfer granularity
    lane: int = LANE

    def sublane(self, dtype) -> int:
        """Second-minor tiling multiple: 8 f32 rows, packed 2x/4x for
        narrower dtypes."""
        return max(32 // max(_itemsize(dtype), 1), 8)


# keyed on (device, REPRO_FAST_BYTES), so flipping the variable takes effect
# without a clear
_DP_CACHE: dict = {}


def device_params(device=None) -> DeviceParams:
    """The parameters of ``device`` (default: the current CUDA device when
    there is one, else the CPU), memoized.  ``REPRO_FAST_BYTES`` overrides
    the fast-memory size."""
    env = os.environ.get("REPRO_FAST_BYTES")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (dev, env)
    hit = _DP_CACHE.get(key)
    if hit is not None:
        return hit
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        platform, kind, queried = "gpu", props.name, props.L2_cache_size
    elif dev.type == "meta":  # the dry run plans for the H100
        platform, kind, queried = "gpu", "meta", H100_L2_BYTES
    else:
        platform, kind, queried = dev.type, dev.type, None
    fast = int(env) if env else (queried or _DEFAULT_FAST_BYTES.get(platform, 8 * 2**20))
    dp = DeviceParams(platform=platform, kind=kind, fast_bytes=fast,
                      line_bytes=_DEFAULT_LINE_BYTES.get(platform, 64))
    _DP_CACHE[key] = dp
    return dp


def clear_device_params_cache() -> None:
    """Drop memoized device queries."""
    _DP_CACHE.clear()


# ---------------------------------------------------------------------------
# tile arithmetic
# ---------------------------------------------------------------------------

def _pow2_floor(x: int) -> int:
    return 1 << max(int(x).bit_length() - 1, 0)


def _divisors_desc(n: int) -> list[int]:
    small, large = [], []
    i = 1
    while i * i <= n:
        if n % i == 0:
            small.append(i)
            if i != n // i:
                large.append(n // i)
        i += 1
    return large + small[::-1]


def divisor_tile(dim: int, cap: int, multiple: int = 1) -> int:
    """Largest divisor of ``dim`` that is <= cap, preferring multiples of
    ``multiple``; falls back to any divisor (odd shapes)."""
    if dim <= 0:
        return 1
    cap = max(1, min(cap, dim))
    divs = _divisors_desc(dim)
    for d in divs:
        if d <= cap and d % multiple == 0:
            return d
    for d in divs:
        if d <= cap:
            return d
    return 1


def _budget(dp: DeviceParams) -> int:
    # one third of fast memory: headroom for double buffering and the output
    return max(dp.fast_bytes // 3, 1024)


# ---------------------------------------------------------------------------
# per-op plans
# ---------------------------------------------------------------------------

def plan_scan(shape, dtype, dp: Optional[DeviceParams] = None) -> dict:
    """BP leaf size of the blocked prefix scan: the largest lane-aligned
    block whose 4 resident buffers (in, out, local, offset) fit the budget."""
    dp = dp or device_params()
    n = shape[-1]
    cap = _pow2_floor(max(_budget(dp) // (4 * _itemsize(dtype)), 1))
    return {"block": divisor_tile(n, cap, dp.lane)}


# dtypes the Strassen schedule may serve (the extra adds are benign under an
# f32 accumulator)
_STRASSEN_DTYPES = ("float32", "bfloat16")


def strassen_cutoff(dtype, dp: Optional[DeviceParams] = None) -> int:
    """Recursion cutoff of the Strassen-schedule matmul: the largest
    power-of-two edge where the classical envelope still wins at the
    device's budgeted fast memory, in elements of ``dtype``."""
    dp = dp or device_params()
    itemsize = _itemsize(dtype)
    m_elems = max(_budget(dp) // itemsize, 2)
    b_elems = max(dp.line_bytes // itemsize, 1)
    return costmodel.strassen_crossover_edge(m_elems, b_elems)


def plan_matmul_backend(m: int, k: int, n: int, dtype,
                        dp: Optional[DeviceParams] = None) -> dict:
    """``strassen`` with its ``cutoff`` when the product is square, halves
    down to the cutoff, and the dtype takes the extra adds; ``classical``
    otherwise."""
    dp = dp or device_params()
    if not (m == k == n and _dtype_name(dtype) in _STRASSEN_DTYPES):
        return {"backend": "classical"}
    cut = strassen_cutoff(dtype, dp)
    levels, edge = 0, n
    while edge > cut and edge % 2 == 0:
        edge //= 2
        levels += 1
    if levels == 0 or edge > cut:
        return {"backend": "classical"}
    return {"backend": "strassen", "cutoff": cut}


def plan_matmul(m: int, k: int, n: int, dtype,
                dp: Optional[DeviceParams] = None) -> dict:
    """Square (bm, bn, bk) tiles from the O(sqrt M) envelope (two operand
    tiles in ``dtype`` and the f32 accumulator), plus the ``backend``
    verdict of :func:`plan_matmul_backend`.  The port's K2 fixes its own
    per-block tile, so the registry passes it only the backend."""
    dp = dp or device_params()
    itemsize = _itemsize(dtype)
    edge = costmodel.oblivious_tile_edge(_budget(dp), 1, 2 * itemsize + 4)
    t = _pow2_floor(edge)
    plan = {
        "bm": divisor_tile(m, t, dp.sublane(dtype)),
        "bn": divisor_tile(n, t, dp.lane),
        "bk": divisor_tile(k, t, dp.lane),
    }
    plan.update(plan_matmul_backend(m, k, n, dtype, dp))
    return plan


def plan_transpose(m: int, n: int, dtype,
                   dp: Optional[DeviceParams] = None) -> dict:
    """One square tile edge serving both dims, from the 2-buffer (in tile,
    out tile) envelope."""
    dp = dp or device_params()
    t = _pow2_floor(costmodel.oblivious_tile_edge(_budget(dp), 2, _itemsize(dtype)))
    g = math.gcd(m, n) if m != n else m
    return {"bt": divisor_tile(g, t, dp.lane)}


# a query block this short (decode) flips the plan into the decode regime
DECODE_MAX_SQ = 16


def plan_attention(sq: int, sk: int, hd: int, dtype,
                   dp: Optional[DeviceParams] = None, *,
                   kv_dtype=None) -> dict:
    """Flash-attention (q_block, kv_block) from the working-set quadratic
    4 t^2 + t * hd * (itemsize + 2 kv_itemsize + 4) <= budget, clamped to
    divisors; in the decode regime the whole query is one block and the
    budget goes to the deepest KV panel.  The port's K1 fixes its own
    blocks; this is the JAX plan, kept for the record of what the envelope
    gives."""
    dp = dp or device_params()
    itemsize = _itemsize(dtype)
    kv_item = _itemsize(kv_dtype) if kv_dtype is not None else itemsize
    kv_sub = dp.sublane(kv_dtype if kv_dtype is not None else dtype)
    budget = _budget(dp)
    if sq <= DECODE_MAX_SQ and sk > sq:
        per_row = 2 * hd * kv_item + 4 * sq + 4
        kb = _pow2_floor(max(budget // per_row, 1))
        return {"q_block": sq, "kv_block": divisor_tile(sk, kb, kv_sub)}
    c1 = hd * (itemsize + 2 * kv_item + 4) + 8
    t = int((-c1 + math.sqrt(c1 * c1 + 16.0 * budget)) / 8.0)
    t = _pow2_floor(max(t, 1))
    qb = divisor_tile(sq, t, dp.sublane(dtype))
    kb = divisor_tile(sk, 2 * t, kv_sub)
    return {"q_block": qb, "kv_block": kb}


def plan_fft(n: int, dp: Optional[DeviceParams] = None) -> dict:
    """Four-step split n = n1 * n2 with n1 ~ sqrt(n)."""
    if n <= 1 or n & (n - 1) != 0:
        return {"n1": 1}
    return {"n1": 1 << (n.bit_length() - 1) // 2}


def default_attention_blocks(dp: Optional[DeviceParams] = None,
                             head_dim: int = 128,
                             dtype=torch.bfloat16) -> tuple[int, int]:
    """Shape-agnostic blockwise-attention leaf sizes (JAX
    ``planner.py:331-338``): the envelope of :func:`plan_attention`,
    uncommitted to a sequence length.  The port's attention kernels fix
    their own blocks; ``RunOptions.q_block``/``kv_block`` carry these for
    the record, as JAX's jnp routes would read them."""
    plan = plan_attention(1 << 30, 1 << 30, head_dim, dtype, dp)
    return plan["q_block"], plan["kv_block"]


def resolve_run_options(opts, *, head_dim: int = 128, dtype=torch.bfloat16):
    """Fill the planner-owned ``None`` fields of a ``RunOptions`` (q_block,
    kv_block, autotune) from the device and the model's head_dim and
    activation dtype, as JAX's (``planner.py:341-358``): ``autotune=None``
    resolves to ``REPRO_AUTOTUNE``, else ``replay``.  Idempotent."""
    import dataclasses

    updates = {}
    if opts.q_block is None or opts.kv_block is None:
        qb, kb = default_attention_blocks(head_dim=head_dim, dtype=dtype)
        if opts.q_block is None:
            updates["q_block"] = qb
        if opts.kv_block is None:
            updates["kv_block"] = kb
    if getattr(opts, "autotune", "off") is None:
        from repro_torch.kernels import autotune  # layered above the planner

        updates["autotune"] = autotune.resolve_mode()
    if not updates:
        return opts
    return dataclasses.replace(opts, **updates)


def modeled_matmul_misses(m: int, k: int, n: int, dtype, plan: dict,
                          dp: Optional[DeviceParams] = None) -> float:
    """Cache-line traffic of a (bm, bn, bk) tiling."""
    dp = dp or device_params()
    itemsize = _itemsize(dtype)
    bm, bn, bk = plan["bm"], plan["bn"], plan["bk"]
    steps = (m // bm) * (n // bn) * (k // bk)
    per_step = (bm * bk + bk * bn) * itemsize
    out = m * n * itemsize
    return (steps * per_step + out) / dp.line_bytes
