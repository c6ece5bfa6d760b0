#!/usr/bin/env python3
"""K4 and K5 on the card: the fused Strassen product and the chained scan
against their plain versions, and their times.

    python3 tools/k4_k5.py

Builds ``strassen_matmul``, ``bp_scan`` and ``hbp_matmul`` and prints
``ptxas``'s registers and spill stores of each K4 and K5 kernel, then:

* K4 (``strassen_matmul``, f32) at n = 4096, 8192 and 16384 with 1, 2 and 3
  levels (cutoff n >> levels; a third level runs the composition's
  combination step around seven fused launches): normwise error against
  its plain version (the same recursion on ``matmul_ref`` leaves, 1e-4) and
  ``torch.matmul`` (1e-3), the time, the leaves' rate in TFLOP/s
  (7^levels x 2 e^3 over the time), beside one classical K2 ``fma`` call
  and ``torch.matmul`` (TF32 off) on the same operands and the bound (the
  Strassen schedule's f32 operations at 67 TFLOP/s);
* K5 (``bp_scan``) on f32 and bf16 (64, 2^20), one 2^20 leaf a row, at
  tiles of 4, 8 and 16 chunks of 16 bytes a thread (``bp_scan.ROUNDS``) on
  both instances (``scalar`` forced by the same values one element off 16
  bytes), against its plain version and beside ``torch.cumsum`` and the
  bound (one read and one write at 3.35 TB/s).

Times are milliseconds per call by CUDA events over a CUDA graph of calls
(``chip_smoke.time_ms``).  Prints the card's name and power limit first;
imports nothing of JAX.
"""
import importlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import ptxas_entries, time_ms  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
K4_SIZES = (4096, 8192, 16384)
K4_LEVELS = (1, 2, 3)
SCAN_ROUNDS = (4, 8, 16)


def normwise(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def main():
    import torch

    if not torch.cuda.is_available():
        print("k4_k5: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, planner
    from repro_torch.kernels.hbp_matmul import hbp_matmul
    from repro_torch.kernels.strassen_matmul import path, strassen_matmul, strassen_matmul_plain
    k5 = importlib.import_module("repro_torch.kernels.bp_scan")

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    spills = []
    for name, log in _build.build(["strassen_matmul", "bp_scan", "hbp_matmul"]).items():
        for kern, regs, spill in ptxas_entries(log):
            if name != "hbp_matmul" or kern.startswith("mm_fma"):
                print(f"  {name}: {kern}: {regs} registers, {spill} bytes of spill stores")
            if spill and name != "hbp_matmul":
                spills.append(kern)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    failed = []

    print(f"K4, f32 ({smi}): ms per call; leaves' TFLOP/s; K2 fma classical and "
          f"torch.matmul (TF32 off) on the same operands")
    for n in K4_SIZES:
        a, b = (torch.randn(n, n, device=dev, generator=g) for _ in "ab")
        reps = 2 if n <= 8192 else 1
        t_k2 = time_ms(torch, hbp_matmul, [(a, b)], reps=reps, iters=2)
        t_lib = time_ms(torch, torch.matmul, [(a, b)], reps=reps, iters=2)
        lib = torch.matmul(a, b)
        for levels in K4_LEVELS:
            cutoff = n >> levels
            e = n >> levels
            k2 = hbp_matmul.launches
            got = strassen_matmul(a, b, cutoff=cutoff)
            torch.cuda.synchronize()
            e_plain = normwise(got, strassen_matmul_plain(a, b, cutoff=cutoff))
            e_lib = normwise(got, lib)
            same = torch.equal(strassen_matmul(a, b, cutoff=cutoff), got)
            ok = e_plain <= 1e-4 and e_lib <= 1e-3 and same and hbp_matmul.launches == k2
            del got
            t = time_ms(torch, lambda x, y, c=cutoff: strassen_matmul(x, y, cutoff=c), [(a, b)],
                        reps=reps, iters=2)
            flop = 7 ** levels * 2 * e ** 3
            ops = flop + sum(7 ** lv * 18 * (n >> (lv + 1)) ** 2 for lv in range(levels))
            print(f"  n {n:5d} levels {levels} (leaf {e}, {path(a, b, cutoff)}): {t:9.4f} ms, "
                  f"leaves {flop / t / 1e9:6.2f} TFLOP/s; bound {1e3 * ops / F32_OPS_PER_S:8.4f}; "
                  f"K2 fma {t_k2:9.4f} ({2 * n ** 3 / t_k2 / 1e9:6.2f} TFLOP/s); torch.matmul "
                  f"{t_lib:9.4f}; err vs plain {e_plain:.2e}, vs torch.matmul {e_lib:.2e}, "
                  f"repeat bitwise {same} {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"K4 {n} levels {levels}")
        del a, b, lib
        torch.cuda.empty_cache()

    print(f"K5, (64, 2^20), one leaf a row ({smi}): ms per call")
    rounds_default = dict(k5.ROUNDS)
    for dtype in (torch.float32, torch.bfloat16):
        rows, n = 64, 2 ** 20
        step = 16 // torch.empty((), dtype=dtype).element_size()
        x = torch.randn(rows, n, device=dev, generator=g).to(dtype)
        y = torch.empty(rows, n + 1, dtype=dtype, device=dev)[:, 1:]
        y.copy_(x)
        want = k5.bp_scan_plain(x, n).float()
        slack = 1e-6 * torch.cumsum(x.float().abs(), dim=-1) + 1e-6
        nbytes = 2 * x.numel() * x.element_size()
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        t_lib = time_ms(torch, lambda v: torch.cumsum(v, dim=-1), [(x,)])
        for rounds in SCAN_ROUNDS:
            k5.ROUNDS[dtype] = rounds
            for inst, v in (("vec", x), ("scalar", y)):
                assert k5.path(v) == inst
                got = k5.bp_scan(v).float()
                diff = (got - want).abs()
                tol = slack if dtype == torch.float32 else slack + torch.exp2(
                    torch.floor(torch.log2(torch.maximum(got.abs(), want.abs())
                                           .clamp_min(2.0 ** -126))) - 7)
                ok = bool((diff <= tol).all()) and torch.equal(k5.bp_scan(v).float(), got)
                t = time_ms(torch, k5.bp_scan, [(v,)])
                print(f"  {str(dtype)[6:]:8s} tile {k5.tile(dtype):6d} "
                      f"({rounds:2d} chunks a thread) {inst:6s}: {t:8.4f} ms ({100 * bound / t:5.1f}% "
                      f"of the {bound:.4f} bound); torch.cumsum {t_lib:8.4f}; max err vs plain "
                      f"{diff.max().item():.3e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    failed.append(f"K5 {dtype} {rounds} {inst}")
        k5.ROUNDS[dtype] = rounds_default[dtype]
        del x, y, want, slack
        torch.cuda.empty_cache()
    if spills:
        failed.append(f"spills in {spills}")
    print("k4_k5:", "FAILED " + ", ".join(failed) if failed else "ok")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
