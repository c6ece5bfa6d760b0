#!/usr/bin/env python3
"""K7 on the card: the two-pass FFT against its plain version, and its times.

    python3 tools/k7_fft.py

Builds ``bi_fft`` only and prints ``ptxas``'s registers and spill stores of
each of its kernels, then:

* checks K7 (``bi_fft``) at a few shapes that reach both passes, both tile
  sizes and the degenerate one-pass split, on complex64 and real f32
  input (a real one is cast to complex64 on the card), against its plain
  version (normwise 1e-5, and whether the two are bitwise equal) and
  ``torch.fft.fft`` (normwise 1e-4), and that a call launches no K2
  product;
* times it for ``n`` from 2^8 to 2^22 (``planner.plan_fft``'s split) on a
  complex64 ``(rows, n)`` of 128 MB, past the 50 MB L2, beside
  ``torch.fft.fft`` on the same input, the two passes' byte floor (4 rows n
  8 bytes at 3.35 TB/s) and the bound (one read and one write, 2 rows n 8
  bytes, or 5 n log2 n rows f32 operations at 67 TFLOP/s, the larger);
  then the degenerate split (``n1 = 1``) for ``n`` from 2^8 to 2^12.

Times are milliseconds per call by CUDA events over a CUDA graph of calls.
Prints the card's name and power limit first; imports nothing of JAX.
"""
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import ptxas_entries, time_ms  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
CALL_ELEMENTS = 2 ** 24  # 128 MB of complex64 a call
CHECKS = [(256, 2 ** 16, None, False), (3, 2 ** 20, None, False), (2, 256, 1, False),
          (2, 4096, 8, False), (5, 2 ** 13, None, True), (7, 4096, 4096, True),
          (3, 2 ** 22, None, False)]


def main():
    import torch

    if not torch.cuda.is_available():
        print("k7_fft: CUDA is not available", file=sys.stderr)
        return 1
    import importlib

    from repro_torch.kernels import _build, planner
    from repro_torch.kernels.bi_fft import bi_fft, bi_fft_plain, fft_ref
    k2 = importlib.import_module("repro_torch.kernels.hbp_matmul")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    for name, log in _build.build(["bi_fft"]).items():
        for kern, regs, spill in ptxas_entries(log):
            print(f"    {kern}: {regs} registers, {spill} bytes of spill stores")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    failures = []

    def normwise(got, want):
        return ((got - want).abs().max() / want.abs().max()).item()

    print("[K7] against the plain version and torch.fft.fft")
    for rows, n, n1, real in CHECKS:
        x = torch.randn(rows, n, device=dev, generator=g)
        if not real:
            x = torch.complex(x, torch.randn(rows, n, device=dev, generator=g))
        k2_before, k7_before = k2.hbp_matmul.launches, bi_fft.launches
        got = bi_fft(x, n1=n1)
        torch.cuda.synchronize()
        k2_calls, k7_calls = k2.hbp_matmul.launches - k2_before, bi_fft.launches - k7_before
        want = bi_fft_plain(x, n1=n1)
        e_plain, same = normwise(got, want), torch.equal(got, want)
        e_lib = normwise(got, fft_ref(x))
        ok = e_plain <= 1e-5 and e_lib <= 1e-4 and k2_calls == 0 and k7_calls == 1
        if not ok:
            failures.append(f"{rows}x{n} n1={n1} real={real}")
        split = planner.plan_fft(n)["n1"] if n1 is None else n1
        print(f"    {'f32' if real else 'complex64'} ({rows}, {n}) split {split} x "
              f"{n // split}: vs plain {e_plain:.3e} (bitwise "
              f"{same}), vs torch.fft.fft {e_lib:.3e}; K2 launches {k2_calls} "
              f"{'ok' if ok else 'FAIL'}")
        del x, got, want

    def report(label, rows, n, n1):
        x = torch.complex(*(torch.randn(rows, n, device=dev, generator=g) for _ in "ri"))
        t_k = time_ms(torch, lambda x: bi_fft(x, n1=n1), [(x,)])
        t_l = time_ms(torch, lambda x: torch.fft.fft(x, dim=-1), [(x,)])
        nbytes = 2 * rows * n * 8
        b_bytes, b_ops = nbytes / HBM_BYTES_PER_S, 5 * n * math.log2(n) * rows / F32_OPS_PER_S
        bound, floor = 1e3 * max(b_bytes, b_ops), 1e3 * 2 * nbytes / HBM_BYTES_PER_S
        split = n1 if n1 else planner.plan_fft(n)["n1"]
        print(f"    {label:>6s} ({rows:6d}, {n:8d}) n1 {split:5d}: "
              f"K7 {t_k:.4f} ms; torch.fft.fft {t_l:.4f} (K7 / library {t_k / t_l:.2f}); "
              f"two-pass floor {floor:.4f} ({100 * floor / t_k:.1f}% of K7's time); bound "
              f"{bound:.4f} by {'bytes' if b_bytes >= b_ops else 'operations'} "
              f"({100 * bound / t_k:.1f}%)")
        del x

    print(f"[K7] complex64, {CALL_ELEMENTS * 8 >> 20} MB a call ({smi})")
    for p in range(8, 23):
        report(f"2^{p}", CALL_ELEMENTS >> p, 1 << p, None)
    print("    the degenerate split, one pass (n1 = 1):")
    for p in range(8, 13):
        report(f"2^{p}", CALL_ELEMENTS >> p, 1 << p, 1)
    if failures:
        print(f"k7_fft FAILED: {failures}", file=sys.stderr)
        return 1
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
