"""Value-level (numerically exact) PyTorch implementations of the paper's
algorithms: the port's counterpart of ``repro/core/algorithms_jax.py``.

Each is the *same algorithm* the simulator traces (``algorithms.py``), but
computing real values, in plain PyTorch on tensors of any device.  The
tests hold them against the JAX twins and independent oracles
(``torch.cumsum``, ``torch.matmul``, ``torch.fft``, the sequential list
ranking, union-find).  No model path reaches them, and they are not the
kernels' plain versions: those live beside each kernel.

The index maps of the BI layout ops come from ``layouts`` (numpy) and are
moved to the operand's device once per call.  List ranking and connected
components stay numpy, as in JAX.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import layouts


# ---------------------------------------------------------------------------
# scans / prefix sums (two-pass BP, the paper's PS)
# ---------------------------------------------------------------------------

def prefix_sums(x: torch.Tensor, block: int = 128) -> torch.Tensor:
    """Inclusive prefix sums via the paper's two-BP-pass algorithm:
    pass 1 computes per-block sums + their exclusive scan (the up-tree),
    pass 2 distributes offsets into each block (the down-pass)."""
    n = x.shape[-1]
    block = min(block, n)
    if n % block != 0:
        x = F.pad(x, (0, block - n % block))
    nb = x.shape[-1] // block
    xb = x.reshape(*x.shape[:-1], nb, block)
    local = torch.cumsum(xb, dim=-1)
    block_tot = local[..., -1]
    offsets = torch.cumsum(block_tot, dim=-1) - block_tot  # exclusive
    out = (local + offsets[..., None]).reshape(*x.shape[:-1], nb * block)
    return out[..., :n]


# ---------------------------------------------------------------------------
# BI layout ops
# ---------------------------------------------------------------------------

def _index(perm: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(perm, dtype=np.int64)).to(like.device)


def rm_to_bi(m: torch.Tensor) -> torch.Tensor:
    n = m.shape[0]
    return m.reshape(-1)[_index(layouts.rm_to_bi_perm(n), m)]


def bi_to_rm(flat: torch.Tensor, n: int) -> torch.Tensor:
    return flat[_index(layouts.bi_to_rm_perm(n), flat)].reshape(n, n)


def bi_to_rm_gapped(flat: torch.Tensor, n: int) -> torch.Tensor:
    """The gapped variant: scatter into the gapped buffer, then compact with
    a scan; value-identical to :func:`bi_to_rm` (the gapping matters for
    block misses, which the simulator measures)."""
    stride = n + layouts.gap_for(n)
    r, c = layouts.bi_coords(np.arange(n * n))
    dst = _index(r.astype(np.int64) * stride + c.astype(np.int64), flat)
    buf = flat.new_zeros(n * stride)
    buf[dst] = flat
    rr, cc = np.divmod(np.arange(n * n, dtype=np.int64), n)
    return buf[_index(rr * stride + cc, flat)].reshape(n, n)


def mt_bi(flat: torch.Tensor, n: int) -> torch.Tensor:
    """Transpose of a BI-layout matrix, staying in BI layout: the permutation
    that swaps the row and column bit positions (a pure index map, the BP
    tree's leaves)."""
    r, c = layouts.bi_coords(np.arange(n * n))
    return flat[_index(layouts.bi_index(c, r).astype(np.int64), flat)]


# ---------------------------------------------------------------------------
# Strassen
# ---------------------------------------------------------------------------

def strassen(a: torch.Tensor, b: torch.Tensor, leaf: int = 64) -> torch.Tensor:
    """Strassen matrix multiply (Type 2 HBP: 7 recursive subproblems computed
    into fresh arrays + MA combines => limited access)."""
    n = a.shape[0]
    if n <= leaf:
        return a @ b
    h = n // 2
    a11, a12, a21, a22 = a[:h, :h], a[:h, h:], a[h:, :h], a[h:, h:]
    b11, b12, b21, b22 = b[:h, :h], b[:h, h:], b[h:, :h], b[h:, h:]
    m1 = strassen(a11 + a22, b11 + b22, leaf)
    m2 = strassen(a21 + a22, b11, leaf)
    m3 = strassen(a11, b12 - b22, leaf)
    m4 = strassen(a22, b21 - b11, leaf)
    m5 = strassen(a11 + a12, b22, leaf)
    m6 = strassen(a21 - a11, b11 + b12, leaf)
    m7 = strassen(a12 - a22, b21 + b22, leaf)
    c11 = m1 + m4 - m5 + m7
    c12 = m3 + m5
    c21 = m2 + m4
    c22 = m1 - m2 + m3 + m6
    return torch.cat([torch.cat([c11, c12], dim=1), torch.cat([c21, c22], dim=1)], dim=0)


# ---------------------------------------------------------------------------
# six-step FFT (Bailey / the paper's FFT)
# ---------------------------------------------------------------------------

def fft_six_step(x: torch.Tensor) -> torch.Tensor:
    """FFT of length n = m^2 via the six-step algorithm:
    1. view as m x m, transpose; 2. m FFTs of size m (rows);
    3. twiddle; 4. transpose; 5. m FFTs of size m; 6. transpose.
    The row FFTs are ``torch.fft.fft`` of size m (the recursion bottoms out
    at once: the parallel structure, not the butterfly, is what the paper
    contributes).  The twiddles' angles are formed in f64 and rounded to
    ``x``'s complex dtype."""
    n = x.shape[-1]
    m = int(math.isqrt(n))
    assert m * m == n, "six-step FFT needs n = m^2"
    if not x.is_complex():
        x = x.to(torch.complex64)
    a = x.reshape(m, m).T  # 0-1. view as a matrix (a[i, j] = x[i*m + j]), transpose
    a = torch.fft.fft(a, dim=-1)  # 2. row FFTs
    i = torch.arange(m, dtype=torch.float64, device=x.device)
    tw = torch.polar(torch.ones((), dtype=torch.float64, device=x.device),
                     -2 * math.pi * torch.outer(i, i) / n)  # 3. twiddles
    a = a * tw.to(a.dtype)
    a = torch.fft.fft(a.T, dim=-1)  # 4-5. transpose, row FFTs
    return a.T.reshape(n)  # 6. transpose


# ---------------------------------------------------------------------------
# list ranking (IS-contraction + pointer jumping, with gapping)
# ---------------------------------------------------------------------------

def list_ranking(succ: np.ndarray) -> np.ndarray:
    """Rank (distance to the end) of each element of a linked list given
    successor pointers (succ[i] = next of i, terminal points to itself).

    Parallel-structure-faithful implementation: O(log log n) contraction
    stages removing independent sets of non-adjacent elements (2-coloring by
    random bits = the O(log^(k) n) coloring of MO-IS), then pointer jumping
    on the contracted list, then rank reinstatement in reverse.  Runs in
    numpy for test-oracle clarity, as in JAX."""
    n = len(succ)
    succ = succ.copy()
    dist = np.ones(n, dtype=np.int64)
    terminal = np.flatnonzero(succ == np.arange(n))
    dist[terminal] = 0

    rng = np.random.default_rng(0)
    alive = np.ones(n, dtype=bool)
    removed_stack: list[np.ndarray] = []
    threshold = max(n // max(int(math.log2(max(n, 2))), 1), 64)

    while alive.sum() > threshold:
        # independent set: pick i with coin[i]=1 and coin[succ[i]]=0, i not
        # terminal (no two adjacent selected)
        coin = rng.integers(0, 2, n).astype(bool)
        is_term = succ == np.arange(n)
        sel = alive & coin & ~coin[succ] & ~is_term & ~is_term[succ]
        idx = np.flatnonzero(sel)
        if len(idx) == 0:
            continue
        # splice out: pred of i points to succ[i]
        pred = np.full(n, -1, dtype=np.int64)
        valid = alive & (succ != np.arange(n))
        pred[succ[np.flatnonzero(valid)]] = np.flatnonzero(valid)
        has_pred = pred[idx] >= 0
        p_idx = pred[idx[has_pred]]
        succ[p_idx] = succ[idx[has_pred]]
        dist[p_idx] = dist[p_idx] + dist[idx[has_pred]]
        alive[idx] = False
        removed_stack.append(idx)

    # pointer jumping (doubling) on the contracted list
    rank = np.where(succ == np.arange(n), 0, dist)
    nxt = succ.copy()
    for _ in range(int(math.ceil(math.log2(max(n, 2)))) + 1):
        rank = rank + np.where(nxt == np.arange(n), 0, rank[nxt])
        nxt = nxt[nxt]

    # reinstate removed elements in reverse order
    for idx in reversed(removed_stack):
        rank[idx] = rank[succ[idx]] + dist[idx]
    return rank


def list_ranking_oracle(succ: np.ndarray) -> np.ndarray:
    """Sequential oracle: walk from the terminal backwards."""
    n = len(succ)
    rank = np.zeros(n, dtype=np.int64)
    pred = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        if succ[i] != i:
            pred[succ[i]] = i
    term = int(np.flatnonzero(succ == np.arange(n))[0])
    r = 0
    cur = term
    while pred[cur] >= 0:
        r += 1
        cur = pred[cur]
        rank[cur] = r
    return rank


# ---------------------------------------------------------------------------
# connected components (hook & contract over the LR primitives)
# ---------------------------------------------------------------------------

def connected_components(n: int, edges: np.ndarray) -> np.ndarray:
    """Label propagation / hook-and-contract: O(log n) stages, each stage =
    scans + 'pointer jumping' (shortcutting), the structure the paper counts
    as log n stages of list-ranking-like work.  Returns component labels."""
    label = np.arange(n, dtype=np.int64)
    if len(edges) == 0:
        return label
    u, v = edges[:, 0], edges[:, 1]
    for _ in range(int(math.ceil(math.log2(max(n, 2)))) * 2 + 2):
        # hook: point each root to the min neighbor label
        lu, lv = label[u], label[v]
        m = np.minimum(lu, lv)
        new = label.copy()
        np.minimum.at(new, lu, m)
        np.minimum.at(new, lv, m)
        # shortcut (pointer jumping)
        for _ in range(2):
            new = new[new]
        if np.array_equal(new, label):
            break
        label = new
    return label
