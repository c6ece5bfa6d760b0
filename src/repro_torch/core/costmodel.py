"""Closed-form cache-cost envelopes from the paper: the port's copy of the
part of ``repro.core.costmodel`` that the kernel planner reads
(``repro_torch.kernels.planner``).  The functions are pure arithmetic and
kept verbatim, so a plan derived from them equals the JAX planner's for the
same device parameters.  The PWS excess bounds and ``table1_asymptotics``
come with the simulator core.
"""
from __future__ import annotations

import math


def seq_cache_complexity_scan(n: int, M: int, B: int) -> float:
    """Q for scans: O(n/B)."""
    return n / B


def seq_cache_complexity_mt(n2: int, M: int, B: int) -> float:
    """Q for MT/RM<->BI on an n x n matrix (input size n2 = n^2): O(n^2/B)."""
    return n2 / B


def seq_cache_complexity_mm(m: int, k: int, n: int, M: int, B: int) -> float:
    """Q for classical tiled matmul (Depth-n-MM without Strassen):
    O(mkn / (B sqrt M) + (mk + kn + mn)/B)."""
    return m * k * n / (B * math.sqrt(max(M, 1))) + (m * k + k * n + m * n) / B


def oblivious_tile_edge(M: int, n_arrays: int, itemsize: int) -> int:
    """The resource-oblivious square-tile envelope: ``n_arrays`` square
    tiles of ``itemsize``-byte elements fit in ``M`` bytes, i.e. edge =
    floor(sqrt(M / (n_arrays * itemsize)))."""
    return max(int(math.isqrt(max(M // max(n_arrays * itemsize, 1), 1))), 1)


def seq_cache_complexity_strassen(n: int, M: int, B: int) -> float:
    """Q = n^lambda / (B * M^(lambda/2 - 1)), lambda = log2 7 (paper §3.2)."""
    lam = math.log2(7)
    return n ** lam / (B * M ** (lam / 2 - 1))


def strassen_crossover_edge(M: int, B: int, *, min_edge: int = 128,
                            max_edge: int = 1 << 20) -> int:
    """Largest power-of-two square edge at which the classical envelope
    still wins against the Strassen one: the recursion cutoff of the
    Strassen-schedule matmul.  Both envelopes get the same O(n^2/B)
    read/write term; the leading terms cross at n ~ sqrt(M)."""
    edge = min_edge
    while edge < max_edge:
        n = 2 * edge
        lin = 3.0 * n * n / B
        if (seq_cache_complexity_strassen(n, M, B) + lin
                < seq_cache_complexity_mm(n, n, n, M, B)):
            break
        edge *= 2
    return edge


def seq_cache_complexity_fft(n: int, M: int, B: int) -> float:
    """Q = (n/B) log_M n."""
    return (n / B) * (math.log(n) / math.log(max(M, 2)))
