#!/usr/bin/env python3
"""K2's tile widths (wgmma) and K splits (stream), on the card.

    python3 tools/k2_tiles.py

Times ``hbp_matmul`` at the bf16 products of ``qwen3-1.7b``'s training step
(4 x 128 tokens: forward, dX = g Wᵀ, dW = xᵀ g, the tied logits' forward, dH
and dEᵀ) and of the lockstep prefill (4 x 57 rows), once with the width
and split-K that ``hbp_matmul.plan`` picks and once with each of the
instance's tile widths (64, 128, 192, 256) and no split (and, for the
logits, the plan with a raster that walks N first); then the stream
instance at the decode products (4 and 8 rows) with the plan's split-K and
with each of 1-8 splits.  Each time is
milliseconds per call by CUDA events over a CUDA graph of calls that cycle
through operand copies past the 50 MB L2.  Prints one line per product and
the card's name and power limit; imports nothing of JAX.
"""
import importlib
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

L2_BYTES = 50 * 2 ** 20
D, FF, KV, V = 2048, 6144, 1024, 151936  # qwen3-1.7b's widths
T, PREFILL = 512, 228


def time_ms(torch, fn, sets, iters=20, reps=5):
    for args in sets:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def main():
    import torch

    if not torch.cuda.is_available():
        print("k2_tiles: CUDA is not available", file=sys.stderr)
        return 1
    mm = importlib.import_module("repro_torch.kernels.hbp_matmul")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    g = torch.Generator(device=dev).manual_seed(0)
    # (label, m, k, n, a stored (k, m), b stored (n, k))
    cases = []
    for kk, n, names in ((D, D, "wq/wo"), (D, KV, "wk/wv"), (D, FF, "w_gate/w_up"),
                         (FF, D, "w_down")):
        cases += [(f"fwd {names}", T, kk, n, False, False),
                  (f"dX {names}", T, n, kk, False, True),
                  (f"dW {names}", kk, T, n, True, False),
                  (f"prefill {names}", PREFILL, kk, n, False, False)]
    cases += [("fwd logits", T, D, V, False, True), ("dH logits", T, V, D, False, False),
              ("dE^T logits", D, T, V, True, False)]
    chosen_plan = mm.plan
    print(f"K2 wgmma ms per call by tile width ({smi}; {sms} SMs); 'plan' is the "
          f"width/splits hbp_matmul.plan picks")
    print(f"    {'product':22s} {'m x k x n':22s} {'plan':>8s} {'ms':>9s} "
          + " ".join(f"{'bn ' + str(bn):>9s}" for bn in mm.WGMMA_BN) + "   best")
    for label, m, k, n, ta, tb in cases:
        nbytes = 2 * (m * k + k * n)
        sets = []
        for _ in range(max(1, math.ceil(2 * L2_BYTES / nbytes))):
            a = torch.randn(k, m, device=dev, generator=g).bfloat16().T if ta else \
                torch.randn(m, k, device=dev, generator=g).bfloat16()
            b = torch.randn(n, k, device=dev, generator=g).bfloat16().T if tb else \
                torch.randn(k, n, device=dev, generator=g).bfloat16()
            sets.append((a, b))
        assert mm.path(*sets[0]) == "wgmma"
        p = chosen_plan(m, n, k, "wgmma", sms)
        times = {"plan": time_ms(torch, mm.hbp_matmul, sets)}
        for bn in mm.WGMMA_BN:
            forced = mm.Plan(p.tile_m, bn, 1, math.ceil(k / 64) * 64, p.group)
            mm.plan = lambda *_, f=forced: f
            try:
                times[bn] = time_ms(torch, mm.hbp_matmul, sets)
            finally:
                mm.plan = chosen_plan
        best = min(mm.WGMMA_BN, key=lambda bn: times[bn])
        print(f"    {label:22s} {f'{m}x{k}x{n}':22s} {f'{p.tile_n}/{p.splits}':>8s} "
              f"{times['plan']:9.4f} " + " ".join(f"{times[bn]:9.4f}" for bn in mm.WGMMA_BN)
              + f"   {best}")
        if "logits" in label and p.group > 1:  # the raster: N first instead (group 1)
            mm.plan = lambda *_, f=p._replace(group=1): f
            try:
                t_n_first = time_ms(torch, mm.hbp_matmul, sets)
            finally:
                mm.plan = chosen_plan
            print(f"    {'':22s} raster group {p.group} (every M tile): {times['plan']:.4f} ms; "
                  f"group 1 (N first): {t_n_first:.4f} ms")
        del sets

    # the stream instance (decode): each split count against the plan's
    splits_tried = (1, 2, 3, 4, 6, 8)
    print(f"K2 stream ms per call by K splits (one thread-block cluster per 64 output "
          f"columns; {smi})")
    print(f"    {'product':22s} {'m x k x n':22s} {'plan':>8s} {'ms':>9s} "
          + " ".join(f"{'s ' + str(x):>9s}" for x in splits_tried) + "   best")
    for m in (4, 8):
        for label, k, n, tb in (("wq/wo", D, D, False), ("wk/wv", D, KV, False),
                                ("w_gate/w_up", D, FF, False), ("w_down", FF, D, False),
                                ("logits", D, V, True)):
            nbytes = 2 * (m * k + k * n)
            sets = []
            for _ in range(max(1, math.ceil(2 * L2_BYTES / nbytes))):
                a = torch.randn(m, k, device=dev, generator=g).bfloat16()
                b = torch.randn(n, k, device=dev, generator=g).bfloat16().T if tb else \
                    torch.randn(k, n, device=dev, generator=g).bfloat16()
                sets.append((a, b))
            assert mm.path(*sets[0]) == "stream"
            p = chosen_plan(m, n, k, "stream", sms)
            times = {"plan": time_ms(torch, mm.hbp_matmul, sets)}
            for x in splits_tried:
                kchunk = math.ceil(math.ceil(k / 64) / x) * 64
                forced = mm.Plan(16, 64, math.ceil(k / kchunk), kchunk, 1)
                mm.plan = lambda *_, f=forced: f
                try:
                    times[x] = time_ms(torch, mm.hbp_matmul, sets)
                finally:
                    mm.plan = chosen_plan
            best = min(splits_tried, key=lambda x: times[x])
            print(f"    {label:22s} {f'{m}x{k}x{n}':22s} {f'{p.tile_n}/{p.splits}':>8s} "
                  f"{times['plan']:9.4f} " + " ".join(f"{times[x]:9.4f}" for x in splits_tried)
                  + f"   {best}")
            del sets
    return 0


if __name__ == "__main__":
    sys.exit(main())
