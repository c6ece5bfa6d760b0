"""Closed-form cost bounds from the paper: the port's copy of
``repro.core.costmodel``.  The kernel planner reads the cache-cost
envelopes (``repro_torch.kernels.planner``); the simulator's tests hold
``core.machine`` under ``pws.PWS`` to the PWS excess bounds and
``steals_bound``; ``table1_asymptotics`` is the paper's Table 1.  Every
function is pure arithmetic kept verbatim, so a plan or a bound derived
from them equals the JAX package's for the same arguments.
"""
from __future__ import annotations

import math


def log2(x: float) -> float:
    return math.log2(max(x, 2.0))


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


def pws_cache_excess_bp(p: int, M: int, B: int) -> float:
    """Lemma 4.4(ii,iii): O(p M / B) for f(r)=O(sqrt r), M >= B^2."""
    return p * M / B


def pws_block_excess_bp(p: int, B: int, r: int) -> float:
    """Lemma 4.8(i): O(p B log B) for r >= B; O(p r log r) for r < B."""
    if r >= B:
        return p * B * log2(B)
    return p * r * log2(max(r, 2))


def pws_cache_excess_type2(p: int, M: int, B: int, n: int, *, c: int,
                           s_kind: str) -> float:
    """Lemma 4.1 for Type 2 HBP:
    (i) c=1: O(p M/B s*(n, M));
    (ii) c=2, s(n)=sqrt n: O(p M/B log n / log M);
    (iii) c=2, s(n)=n/4: O(p (sqrt(n M)/B + sqrt(n/M) * sqrt(M)))."""
    if c == 1:
        s_star = max(math.log2(max(n, 2)) / math.log2(max(M, 2)), 1.0)
        return p * M / B * s_star
    if s_kind == "sqrt":
        return p * (M / B) * (log2(n) / log2(M))
    return p * (math.sqrt(n * M) / B + math.sqrt(n / M) * math.sqrt(M))


def pws_block_excess_type2(p: int, B: int, n: int, *, c: int, s_kind: str) -> float:
    """Lemma 4.2: (i) c=1: O(p B log B s*(n));
    (ii) c=2, s=sqrt: O(p B log n log log B); (iii) c=2, s=n/4: O(p B sqrt n)."""
    if c == 1:
        return p * B * log2(B) * log2(n)
    if s_kind == "sqrt":
        return p * B * log2(n) * max(math.log2(max(log2(B), 2)), 1.0)
    return p * B * math.sqrt(n)


def steals_bound(p: int, n_priorities: int) -> int:
    """Obs. 4.3 + Cor. 4.1: <= (p-1) steals per priority,
    <= 2 p D' total attempts."""
    return 2 * p * n_priorities


def table1_asymptotics() -> dict[str, dict]:
    """Table 1 (for the benchmark report): structural parameters."""
    return {
        "scan": {"type": 1, "f": "1", "L": "1", "W": "n", "T_inf": "log n", "Q": "n/B"},
        "mt": {"type": 1, "f": "1", "L": "1", "W": "n^2", "T_inf": "log n", "Q": "n^2/B"},
        "strassen": {"type": 2, "f": "1", "L": "1", "W": "n^2.807", "T_inf": "log^2 n",
                     "Q": "n^l/(B M^(l/2-1))"},
        "rm_to_bi": {"type": 1, "f": "sqrt r", "L": "1", "W": "n^2", "T_inf": "log n",
                     "Q": "n^2/B"},
        "bi_to_rm_direct": {"type": 1, "f": "sqrt r", "L": "sqrt r", "W": "n^2",
                            "T_inf": "log n", "Q": "n^2/B"},
        "bi_to_rm_gap": {"type": 1, "f": "sqrt r", "L": "gap", "W": "n^2",
                         "T_inf": "log n", "Q": "n^2/B"},
        "fft": {"type": 2, "f": "sqrt r", "L": "1", "W": "n log n",
                "T_inf": "log n loglog n", "Q": "(n/B) log_M n"},
        "lr": {"type": 3, "f": "sqrt r", "L": "gap", "W": "n log n",
               "T_inf": "log^2 n loglog n", "Q": "(n/B) log_M n"},
        "cc": {"type": 4, "f": "sqrt r", "L": "gap", "W": "n log^2 n",
               "T_inf": "log^3 n loglog n", "Q": "(n/B) log_M n log n"},
    }
