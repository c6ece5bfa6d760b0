"""K7, the four-step FFT over K2: DFT along the last axis.

Replaces ``src/repro/kernels/bi_fft.py:bi_fft`` and ``:_cmatmul``.  It adds
no CUDA source: as in the JAX package, every O(n^1.5) flop is a real f32
product on K2 (``hbp_matmul``), a complex product being four of them
(:func:`_cmatmul`), and the O(n) folds, twiddle and readout between the
stages are plain torch (XLA's in the JAX package).

For ``x`` ``(rows, n)``, ``n`` a power of two (``ValueError`` otherwise),
real or complex, with ``n = n1 * n2`` (``n1`` from ``planner.plan_fft``,
``n1 ~ sqrt(n)``):

  1. fold the rows into ``A`` ``(n1, rows * n2)``, ``A[j1, r*n2 + j2] =
     x[r, j1*n2 + j2]`` (a copy);
  2. column DFTs ``B = W(n1) @ A`` (4 K2 products);
  3. twiddle ``B[k1, r, j2] *= exp(-2 pi i k1 j2 / n)``;
  4. row DFTs ``C = B @ W(n2)`` (4 K2 products; ``W`` is symmetric);
  5. read out transposed, ``X[r, k2*n1 + k1] = C[k1, r, k2]`` (a copy).

A degenerate split (``n1`` or ``n2`` is 1) is one dense DFT product (4 K2
products).  Returns complex64 ``(rows, n)``.

The DFT and twiddle tables are built with numpy in f64, as the JAX code
builds them, cast to f32 and uploaded once per (n1, n2, device) into a
cache, so a call inside a CUDA-graph capture makes no host-to-device copy
(warm up outside the capture first).

On the CPU every K2 call takes ``matmul_ref``, so :func:`bi_fft` runs its
plain version there; :func:`bi_fft_plain` is the same composition with
``matmul_ref`` on any device (the card's comparisons) and :func:`fft_ref`
the oracle (``torch.fft.fft``).  ``bi_fft.launches`` counts the calls on
CUDA tensors (8 K2 launches each, 4 on a degenerate split).
"""
from __future__ import annotations

import importlib
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.hbp_matmul import matmul_ref

# the K2 module, not the function the package exports under its name
_k2 = importlib.import_module("repro_torch.kernels.hbp_matmul")

# (n1, n2, device) -> the f32 DFT and twiddle tables on that device
_TABLES: dict = {}


def fft_ref(x: torch.Tensor) -> torch.Tensor:
    """The oracle (``repro.kernels.ref.fft_ref``): the DFT along the last
    axis, complex64."""
    return torch.fft.fft(x.to(torch.complex64), dim=-1)


def _dft_factors(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Dense DFT matrix W[k, j] = exp(-2 pi i k j / n) as (real, imag) f32."""
    kj = np.outer(np.arange(n), np.arange(n))
    w = np.exp(-2j * np.pi * kj / n)
    return w.real.astype(np.float32), w.imag.astype(np.float32)


def _tables(n1: int, n2: int, device) -> dict:
    key = (n1, n2, device)
    hit = _TABLES.get(key)
    if hit is not None:
        return hit
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    if n1 == 1 or n2 == 1:
        wr, wi = _dft_factors(n1 * n2)
        t = {"wr": up(wr), "wi": up(wi)}
    else:
        w1r, w1i = _dft_factors(n1)
        w2r, w2i = _dft_factors(n2)
        k1j2 = np.outer(np.arange(n1), np.arange(n2)).astype(np.float64)
        tw = np.exp(-2j * np.pi * k1j2 / (n1 * n2))
        t = {"w1r": up(w1r), "w1i": up(w1i), "w2r": up(w2r), "w2i": up(w2i),
             "twr": up(tw.real.astype(np.float32))[:, None, :],
             "twi": up(tw.imag.astype(np.float32))[:, None, :]}
    _TABLES[key] = t
    return t


def _cmatmul(ar, ai, br, bi, mm):
    """(ar + i ai) @ (br + i bi) as four real products."""
    rr = mm(ar, br) - mm(ai, bi)
    ri = mm(ar, bi) + mm(ai, br)
    return rr, ri


def _split(n: int, n1: Optional[int]) -> tuple[int, int]:
    if n & (n - 1) != 0:
        raise ValueError(f"bi_fft needs a power-of-two length, got {n}")
    if n1 is None:
        from repro_torch.kernels import planner

        n1 = planner.plan_fft(n)["n1"]
    n1 = max(min(int(n1), n), 1)
    while n % n1 != 0:
        n1 //= 2
    return n1, n // n1


def _four_step(x, n1, n2, mm):
    rows, n = x.shape
    t = _tables(n1, n2, x.device)
    xr = (x.real if x.is_complex() else x).float()
    xi = x.imag.float() if x.is_complex() else torch.zeros_like(xr)
    if n1 == 1 or n2 == 1:  # one dense DFT product (W is symmetric)
        yr, yi = _cmatmul(xr.contiguous(), xi.contiguous(), t["wr"], t["wi"], mm)
        return torch.complex(yr, yi)
    # step 1: (rows, n) -> (n1, rows * n2)
    ar = xr.reshape(rows, n1, n2).transpose(0, 1).reshape(n1, rows * n2)
    ai = xi.reshape(rows, n1, n2).transpose(0, 1).reshape(n1, rows * n2)
    # step 2: column DFTs
    br, bi = _cmatmul(t["w1r"], t["w1i"], ar, ai, mm)
    # step 3: twiddle, broadcast over rows
    b3r, b3i = br.reshape(n1, rows, n2), bi.reshape(n1, rows, n2)
    cr = b3r * t["twr"] - b3i * t["twi"]
    ci = b3r * t["twi"] + b3i * t["twr"]
    # step 4: row DFTs
    dr, di = _cmatmul(cr.reshape(n1 * rows, n2), ci.reshape(n1 * rows, n2),
                      t["w2r"], t["w2i"], mm)
    # step 5: transposed readout X[r, k2*n1 + k1] = C[k1, r, k2]
    outr = dr.reshape(n1, rows, n2).permute(1, 2, 0).reshape(rows, n)
    outi = di.reshape(n1, rows, n2).permute(1, 2, 0).reshape(rows, n)
    return torch.complex(outr, outi)


def _check(x):
    if x.dim() != 2:
        raise ValueError(f"bi_fft: x must be (rows, n), got {tuple(x.shape)}")


def bi_fft(x: torch.Tensor, *, n1: Optional[int] = None) -> torch.Tensor:
    """DFT of ``x`` ``(rows, n)`` along its last axis on K2; see the module
    docstring."""
    _check(x)
    n1, n2 = _split(x.shape[1], n1)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bi_fft: no kernel for device {x.device}")
    out = _four_step(x, n1, n2, _k2.hbp_matmul)
    if x.device.type == "cuda":
        bi_fft.launches += 1
    return out


bi_fft.launches = 0


def bi_fft_plain(x: torch.Tensor, *, n1: Optional[int] = None) -> torch.Tensor:
    """Plain version: the same four steps with ``matmul_ref`` products."""
    _check(x)
    n1, n2 = _split(x.shape[1], n1)
    return _four_step(x, n1, n2, matmul_ref)
