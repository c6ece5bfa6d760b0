"""K7, the two-pass FFT: the DFT along the last axis, complex64.

Replaces ``src/repro/kernels/bi_fft.py:bi_fft`` and ``:_cmatmul``.  The
kernel is ``csrc/bi_fft.cu``, CUDA C++ for ``sm_90a``; its header says what
bounds it on the H100 (bytes) and how the tiles are laid out.

For ``x`` ``(rows, n)``, ``n`` a power of two (``ValueError`` otherwise),
real or complex, it keeps the JAX code's four-step split ``n = n1 * n2``
(``n1`` from ``planner.plan_fft``, ``n1 ~ sqrt(n)``, or the caller's), the
paper's Type 2 HBP recursion unrolled one level, but each small DFT is a
radix-4 Stockham FFT (one radix-2 stage first where log2 of its length is
odd) in place of a dense DFT product:

  1. pass 1 (columns): for each row ``r`` and column ``j2``, the length-``n1``
     FFT of ``x[r, j1*n2 + j2]`` over ``j1``, times the twiddle
     ``exp(-2 pi i k1 j2 / n)``, into ``B[r, k1, j2]`` (laid out like ``x``);
  2. pass 2 (lines): for each line ``(r, k1)``, the length-``n2`` FFT of
     ``B[r, k1, :]``, read out transposed, ``X[r, k2*n1 + k1] = C[r, k1, k2]``.

A degenerate split (``n1`` or ``n2`` is 1) is one pass of length ``n``
over the rows.  A pass takes lines of at most :data:`MAX_PASS` (the
kernel's shared-memory tile; read at call time).  A split with a longer
factor is the same DFT at another split, so it is planned again
(:func:`split`): ``plan_fft``'s split, its ``n1`` capped at ``MAX_PASS``.
``plan_fft``'s split is within the cap for every ``n <= 2**24``; past it
``n2`` is longer than a pass, and the lines of pass 2 are themselves a
``bi_fft`` of length ``n2`` over ``rows * n1`` lines (natural order), whose
result ``C[r, k1, k2]`` is read out as ``X[r, k2*n1 + k1]`` by K6
(``bi_transpose``, one launch a row), the same recursion on every device.
Any other dtype than complex64 is cast to it first, on ``x``'s device, as
the JAX code casts.

Every twiddle comes from tables built with numpy in f64 and rounded to
f32: the roots of unity of each pass's length and the ``n1 x n2``
inter-pass table, uploaded once per (n1, n2, device), so a call inside a
CUDA-graph capture copies nothing from the host (warm up outside it).

A CUDA tensor launches the kernel (two launches, one on a degenerate
split; past the cap pass 1 alone, then the nested call and the readout);
a CPU tensor takes :func:`bi_fft_plain`, the same stages in torch ops, each
product and sum rounded as the kernel rounds it; :func:`fft_ref` is the
oracle (``torch.fft.fft``).  ``bi_fft.launches`` counts the calls of the C
entries on CUDA tensors (each one or two kernels).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bi_transpose import bi_transpose

# the longest line a pass takes (csrc/bi_fft.cu's LOG_MAX_PASS)
MAX_PASS = 4096

# (n1, n2, device) -> the f32 twiddle tables on that device
_TABLES: dict = {}


def fft_ref(x: torch.Tensor) -> torch.Tensor:
    """The oracle (``repro.kernels.ref.fft_ref``): the DFT along the last
    axis, complex64."""
    return torch.fft.fft(x.to(torch.complex64), dim=-1)


def _roots(length: int) -> np.ndarray:
    """exp(-2 pi i t / length) for t < length, in f64, rounded to complex64."""
    return np.exp(-2j * np.pi * np.arange(length) / length).astype(np.complex64)


def _tables(n1: int, n2: int, device) -> dict:
    key = (n1, n2, device)
    hit = _TABLES.get(key)
    if hit is not None:
        return hit
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    if n1 == 1 or n2 == 1:
        t = {"t2": up(_roots(n1 * n2))}
    else:
        k1j2 = np.outer(np.arange(n1), np.arange(n2)).astype(np.float64)
        tw = np.exp(-2j * np.pi * k1j2 / (n1 * n2)).astype(np.complex64)
        t = {"t1": up(_roots(n1)), "t2": up(_roots(n2)), "tw": up(tw)}
    _TABLES[key] = t
    return t


def _longest(n1: int, n2: int) -> int:
    """The longest line a pass of the split takes."""
    return n1 * n2 if n1 == 1 or n2 == 1 else max(n1, n2)


def split(n: int, n1: Optional[int] = None) -> tuple[int, int]:
    """``(n1, n2)``, the four-step split a call of length ``n`` runs: the
    caller's ``n1`` (default ``plan_fft``'s), halved until it divides
    ``n``; where a pass of it is longer than :data:`MAX_PASS`,
    ``plan_fft``'s split with ``n1`` capped at ``MAX_PASS`` (``n2`` may
    then pass the cap, and pass 2 recurses)."""
    if n & (n - 1) != 0:
        raise ValueError(f"bi_fft needs a power-of-two length, got {n}")
    from repro_torch.kernels import planner

    if n1 is None:
        n1 = planner.plan_fft(n)["n1"]
    n1 = max(min(int(n1), n), 1)
    while n % n1 != 0:
        n1 //= 2
    if _longest(n1, n // n1) > MAX_PASS:
        n1 = min(planner.plan_fft(n)["n1"], MAX_PASS)
    return n1, n // n1


def _check(x):
    if x.dim() != 2:
        raise ValueError(f"bi_fft: x must be (rows, n), got {tuple(x.shape)}")


def _operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernel reads it: complex64."""
    return x.to(torch.complex64)


# -- the plain version ----------------------------------------------------------------------

def _radices(length: int) -> list[int]:
    """The kernel's stages for one line: radix 2 first where log2(length)
    is odd, then radix 4."""
    p = length.bit_length() - 1
    return [2] * (p & 1) + [4] * (p // 2)


def _cmul(ar, ai, tr, ti):
    return ar * tr - ai * ti, ar * ti + ai * tr


def _dft(radix, vr, vi):
    if radix == 2:
        return [vr[0] + vr[1], vr[0] - vr[1]], [vi[0] + vi[1], vi[0] - vi[1]]
    t0r, t0i = vr[0] + vr[2], vi[0] + vi[2]
    t1r, t1i = vr[0] - vr[2], vi[0] - vi[2]
    t2r, t2i = vr[1] + vr[3], vi[1] + vi[3]
    t3r, t3i = vi[1] - vi[3], -(vr[1] - vr[3])  # (v1 - v3) * -i
    return ([t0r + t2r, t1r + t3r, t0r - t2r, t1r - t3r],
            [t0i + t2i, t1i + t3i, t0i - t2i, t1i - t3i])


def _lines_fft(re, im, roots):
    """The Stockham FFT of every line of ``re + i im`` ``(lines, L)``, as
    ``csrc/bi_fft.cu``'s ``stage`` computes it; ``roots`` the length-L
    roots of unity (complex64)."""
    lines, length = re.shape
    tr_all, ti_all = roots.real, roots.imag
    ns = 1
    for radix in _radices(length):
        m = length // radix
        vr = list(re.reshape(lines, radix, m).unbind(1))
        vi = list(im.reshape(lines, radix, m).unbind(1))
        if ns > 1:
            k = torch.arange(m, device=re.device) % ns
            for r in range(1, radix):
                idx = r * k * (length // (ns * radix))
                vr[r], vi[r] = _cmul(vr[r], vi[r], tr_all[idx], ti_all[idx])
        yr, yi = _dft(radix, vr, vi)
        # butterfly b = q ns + k writes row q ns radix + r ns + k
        re, im = (torch.stack(y, 1).reshape(lines, radix, m // ns, ns).transpose(1, 2)
                  .reshape(lines, length) for y in (yr, yi))
        ns *= radix
    return re, im


def _two_pass(x, n1, n2):
    rows, n = x.shape
    if x.numel() == 0:
        return torch.empty((rows, n), dtype=torch.complex64, device=x.device)
    t = _tables(n1, n2, x.device)
    xr, xi = x.real, x.imag
    if n1 == 1 or n2 == 1:
        yr, yi = _lines_fft(xr.contiguous(), xi.contiguous(), t["t2"])
        return torch.complex(yr, yi)
    # pass 1: the columns j2 of each row, over j1; then the twiddle
    cr = xr.reshape(rows, n1, n2).transpose(1, 2).reshape(rows * n2, n1)
    ci = xi.reshape(rows, n1, n2).transpose(1, 2).reshape(rows * n2, n1)
    br, bi = _lines_fft(cr, ci, t["t1"])
    br = br.reshape(rows, n2, n1).transpose(1, 2)  # B[r, k1, j2]
    bi = bi.reshape(rows, n2, n1).transpose(1, 2)
    br, bi = _cmul(br, bi, t["tw"].real, t["tw"].imag)
    if n2 > MAX_PASS:  # pass 2 is a bi_fft of its own, read out by K6
        c = bi_fft_plain(torch.complex(br, bi).reshape(rows * n1, n2))
        return c.reshape(rows, n1, n2).transpose(1, 2).reshape(rows, n)
    # pass 2: the lines (r, k1), over j2; read out X[r, k2*n1 + k1]
    dr, di = _lines_fft(br.reshape(rows * n1, n2), bi.reshape(rows * n1, n2), t["t2"])
    dr = dr.reshape(rows, n1, n2).transpose(1, 2).reshape(rows, n)
    di = di.reshape(rows, n1, n2).transpose(1, 2).reshape(rows, n)
    return torch.complex(dr, di)


def bi_fft_plain(x: torch.Tensor, *, n1: Optional[int] = None) -> torch.Tensor:
    """Plain version: the kernel's passes, stage for stage, in torch ops
    on any device."""
    _check(x)
    n1, n2 = split(x.shape[1], n1)
    return _two_pass(_operand(x), n1, n2)


# -- the kernel -----------------------------------------------------------------------------

def _lib(entry):
    lib = _build.load("bi_fft")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([P, P, P, L, I, I, P, P, P, P] if entry == "bi_fft"
                       else [P, P, L, I, I, P, P, P])
        fn.restype = ctypes.c_int
    return fn


def bi_fft(x: torch.Tensor, *, n1: Optional[int] = None) -> torch.Tensor:
    """DFT of ``x`` ``(rows, n)`` along its last axis; see the module
    docstring."""
    _check(x)
    n1, n2 = split(x.shape[1], n1)
    if x.device.type == "cpu":
        return _two_pass(_operand(x), n1, n2)
    if x.device.type != "cuda":
        raise ValueError(f"bi_fft: no kernel for device {x.device}")
    x = _operand(x)
    if not x.is_contiguous():
        raise ValueError(f"bi_fft: x must be contiguous, strides {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError("bi_fft: x must be 16-byte aligned")
    rows, n = x.shape
    out = torch.empty((rows, n), dtype=torch.complex64, device=x.device)
    if out.numel() == 0:
        return out
    t = _tables(n1, n2, x.device)
    degenerate = n1 == 1 or n2 == 1
    scratch = None if degenerate else torch.empty_like(out)
    ptr = lambda a: None if a is None else a.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(x.device).cuda_stream
    log_n1, log_n2 = n1.bit_length() - 1, n2.bit_length() - 1
    if not degenerate and n2 > MAX_PASS:
        # pass 1 alone into scratch, its lines a bi_fft of their own, then
        # each row's (n1, n2) result transposed into X by K6
        err = _lib("bi_fft_cols")(x.data_ptr(), scratch.data_ptr(), rows, log_n1, log_n2,
                                  t["t1"].data_ptr(), t["tw"].data_ptr(), stream)
        _build.check(err, "bi_fft")
        bi_fft.launches += 1
        c = bi_fft(scratch.view(rows * n1, n2)).view(rows, n1, n2)
        for r in range(rows):
            bi_transpose(c[r], out=out[r].view(n2, n1))
        return out
    err = _lib("bi_fft")(x.data_ptr(), ptr(scratch), out.data_ptr(), rows, log_n1, log_n2,
                         ptr(t.get("t1")), t["t2"].data_ptr(), ptr(t.get("tw")), stream)
    _build.check(err, "bi_fft")
    bi_fft.launches += 1
    return out


bi_fft.launches = 0

