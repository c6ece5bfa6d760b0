"""Morton (bit-interleaved, BI) order of a 2-D tile grid: the port's copy of
``repro.kernels.morton``.

The bit tricks work on Python ints and on integer tensors alike.
``csrc/bi_transpose.cu`` carries the same ``part1by1``/``compact1by1`` for
``uint32_t`` and decodes its block index with them; :func:`grid_decode` is
the one place that picks Morton or row-major order for a grid.
"""
from __future__ import annotations

from typing import Callable, Tuple

_EVEN_MASK = 0x55555555


def part1by1(x):
    """Spread the low 16 bits of ``x`` to even bit positions."""
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & _EVEN_MASK
    return x


def compact1by1(x):
    """Inverse of :func:`part1by1`: gather even bit positions to the low 16."""
    x = x & _EVEN_MASK
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    x = (x | (x >> 8)) & 0x0000FFFF
    return x


def morton_of(i, j):
    """Morton (Z-order) code of tile (i, j): row bits to odd positions, column
    bits to even, the recursive quadrant order (TL, TR, BL, BR)."""
    return (part1by1(i) << 1) | part1by1(j)


def morton_ij(g) -> Tuple[object, object]:
    """Decode Morton code ``g`` -> (i, j)."""
    return compact1by1(g >> 1), compact1by1(g)


def supports_morton(nm: int, nn: int) -> bool:
    """BI order is defined for square power-of-two tile grids; everything
    else falls back to row-major."""
    return nm == nn and nm > 0 and (nm & (nm - 1)) == 0


def grid_decode(nm: int, nn: int, *, morton: bool = True) -> Callable:
    """``decode(g) -> (i, j)`` for a flattened ``(nm * nn,)`` tile grid:
    Morton order when the grid is square power-of-two and ``morton`` is
    asked for, else row-major."""
    if morton and supports_morton(nm, nn):
        return morton_ij

    def rowmajor(g):
        return g // nn, g % nn

    return rowmajor
