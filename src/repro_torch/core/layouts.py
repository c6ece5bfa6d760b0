"""Data layouts from the paper: bit-interleaved (BI / Morton / Z-order),
RM<->BI conversion index maps, gapped arrays, and the in-order up-pass
output layout.

These are used three ways:
  1. by the simulator (``repro_torch.core.machine``) to generate access traces;
  2. by the value-level algorithms (``repro_torch.core.algorithms_torch``);
  3. conceptually by the kernels: K6 (``repro_torch.kernels.bi_transpose``)
     visits its tiles in Morton order (``repro_torch.kernels.morton``).

The port's copy of ``repro/core/layouts.py`` (pure Python and numpy).
"""
from __future__ import annotations

import math

import numpy as np


# ---------------------------------------------------------------------------
# bit interleaving (Morton / Z-order)
# ---------------------------------------------------------------------------

def _part1by1(x: np.ndarray) -> np.ndarray:
    """Spread the low 16 bits of x to even bit positions (vectorized)."""
    x = x.astype(np.uint32)
    x = (x | (x << 8)) & np.uint32(0x00FF00FF)
    x = (x | (x << 4)) & np.uint32(0x0F0F0F0F)
    x = (x | (x << 2)) & np.uint32(0x33333333)
    x = (x | (x << 1)) & np.uint32(0x55555555)
    return x


def _compact1by1(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32) & np.uint32(0x55555555)
    x = (x | (x >> 1)) & np.uint32(0x33333333)
    x = (x | (x >> 2)) & np.uint32(0x0F0F0F0F)
    x = (x | (x >> 4)) & np.uint32(0x00FF00FF)
    x = (x | (x >> 8)) & np.uint32(0x0000FFFF)
    return x


def bi_index(row, col) -> np.ndarray:
    """Z-order index: row bits to odd positions, col bits to even.
    The recursive quadrant order is (TL, TR, BL, BR) as in the paper."""
    return (_part1by1(np.asarray(row)) << 1) | _part1by1(np.asarray(col))


def bi_coords(z) -> tuple[np.ndarray, np.ndarray]:
    z = np.asarray(z)
    return _compact1by1(z >> 1), _compact1by1(z)


def rm_to_bi_perm(n: int) -> np.ndarray:
    """perm such that flat_bi[bi_index(r,c)] = rm[r,c]:
    returns indices p with flat_bi = rm.flatten()[p]."""
    z = np.arange(n * n)
    r, c = bi_coords(z)
    return (r * n + c).astype(np.int64)


def bi_to_rm_perm(n: int) -> np.ndarray:
    """inverse permutation: rm.flatten() = flat_bi[p]."""
    r, c = np.divmod(np.arange(n * n), n)
    return bi_index(r, c).astype(np.int64)


def rm_to_bi(m: np.ndarray) -> np.ndarray:
    n = m.shape[0]
    return m.reshape(-1)[rm_to_bi_perm(n)]


def bi_to_rm(flat: np.ndarray, n: int) -> np.ndarray:
    return flat[bi_to_rm_perm(n)].reshape(n, n)


# ---------------------------------------------------------------------------
# gapping (paper §3.2, BI->RM (gap RM) and LR list gapping)
# ---------------------------------------------------------------------------

def gap_for(r: int) -> int:
    """Row gap r/log^2 r for a size-r row (>= 0); the paper shows the total
    expansion is a constant factor since sum over r=2^i of 1/log^2 r = O(1)."""
    if r < 4:
        return 0
    return max(int(r / (math.log2(r) ** 2)), 1)


def gapped_row_starts(n: int) -> np.ndarray:
    """Start offset of each row in the gapped RM destination (gap = gap_for(n)
    between rows)."""
    stride = n + gap_for(n)
    return np.arange(n, dtype=np.int64) * stride


def gapped_size(n: int) -> int:
    return int(n * (n + gap_for(n)))


def gapped_list_positions(m: int, n: int) -> np.ndarray:
    """Paper's LR gapping: a contracted list of size m <= n is written in
    space n/x using every x-th location, where m = n/x^2 (so x = sqrt(n/m)).
    Returns the m write positions."""
    if m >= n:
        return np.arange(m, dtype=np.int64)
    x = max(int(math.isqrt(n // max(m, 1))), 1)
    return (np.arange(m, dtype=np.int64) * x)


# ---------------------------------------------------------------------------
# in-order up-pass output layout (paper §3.3 "Data Layout in a BP Computation")
# ---------------------------------------------------------------------------

def inorder_positions(n_leaves: int) -> dict[tuple[int, int], int]:
    """Positions of BP-tree nodes in an in-order traversal of the up-tree.
    Node key = (level, index-within-level), level 0 = leaves.  The in-order
    layout guarantees writes at any two nodes whose subtrees have > B leaves
    are >= B apart — zero up-pass block sharing above level log B."""
    assert n_leaves & (n_leaves - 1) == 0, "power of two"
    pos: dict[tuple[int, int], int] = {}
    counter = 0

    def rec(level: int, idx: int):
        nonlocal counter
        if level == 0:
            pos[(0, idx)] = counter
            counter += 1
            return
        rec(level - 1, 2 * idx)
        pos[(level, idx)] = counter
        counter += 1
        rec(level - 1, 2 * idx + 1)

    rec(int(math.log2(n_leaves)), 0)
    return pos
