#!/usr/bin/env python3
"""K1q and K6 on the card: each instance against its plain version, and
their times.

    python3 tools/k1q_k6.py

Builds ``flash_attention`` and ``bi_transpose`` only, then:

* K1q (``flash_attention_int8``, bf16 ``q`` over an int8 cache) at the
  engine's shapes on ``qwen3-1.7b`` (8 slots, 16 query heads over 8 KV
  heads, hd 128, a 512-position cache): decode (8 x 1, kv_len lanes spread
  over 1-512 and one empty lane) and a continuation chunk (8 x 64 rows at
  q_offset 64 i).  Checks the output within 2e-2 and the lse within 1e-3 of
  the plain version, and exact zeros in the empty lane; times it per call
  with the cluster split that ``flash_attention.kv_splits`` plans and with
  none, beside K1 (``flash_attention``) over the same cache in bf16, which
  is K1q's yardstick, and the f32-``q`` FMA template over the int8 cache;
  then decode at every lane's depth 64, 128, 256 and 512 (K1q planned and
  unsplit, K1), which separates a call's fixed cost from its cost per
  64-key tile.
* K6 (``bi_transpose``) at phase 10's three shapes of ``chip_smoke.py``
  (f32 8192^2, bf16 4096x16384 and 6144x10240, the planner's tiles) and at
  int8 8192x16384 and f64 4096^2: each instance (forced through
  ``bi_transpose._path``) exact, and timed in turns (scalar, vec, vec,
  scalar) beside the bytes' bound at 3.35 TB/s.

Times are milliseconds per call by CUDA events over a CUDA graph of calls
whose operands cycle past the 50 MB L2.  Prints the card's name and power
limit; imports nothing of JAX.
"""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import ptxas_entries  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
SLOTS, LEN, H, KVH, HD, CHUNK, LAYERS = 8, 512, 16, 8, 128, 64, 28


def time_ms(torch, fn, sets, iters=None, reps=5):
    iters = iters or max(20, len(sets))
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
        print("k1q_k6: CUDA is not available", file=sys.stderr)
        return 1
    import importlib

    from repro_torch.kernels import _build, planner
    from repro_torch.kernels.bi_transpose import bi_transpose, path as k6_path
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_int8,
                                                     flash_attention_ref, fwd_path)
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    k6 = importlib.import_module("repro_torch.kernels.bi_transpose")
    planned, chosen = fa.kv_splits, k6._path
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    from repro_torch.models.common import kv_scale, quantize_kv

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    logs = _build.build(["flash_attention", "bi_transpose"])
    for name, log in logs.items():  # ptxas -v of the two instances' kernels
        for kern, regs, spill in ptxas_entries(log):
            if "_mma_kernel" in kern or kern.startswith("transpose_vec"):
                print(f"    {kern}: {regs} registers, {spill} bytes of spill stores")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    failures = []

    def lane(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    caches = []
    for _ in range(LAYERS):
        fp = [torch.randn(SLOTS, LEN, KVH, HD, device=dev, generator=g) for _ in "kv"]
        scales = [kv_scale(x) for x in fp]
        k8, v8 = (quantize_kv(x, sc) for x, sc in zip(fp, scales))
        kb, vb = ((x.float() * sc[:, None, :, None]).to(bf) for x, sc in ((k8, scales[0]),
                                                                          (v8, scales[1])))
        caches.append((k8, v8, *scales, kb, vb))
    decode_kl = [65, 129, 200, 257, 321, 400, LEN, 0]
    shapes = {
        "decode 8x1": (1, [max(n - 1, 0) for n in decode_kl], decode_kl),
        f"chunk 8x{CHUNK}": (CHUNK, [CHUNK * i for i in range(SLOTS)],
                             [CHUNK * i + CHUNK for i in range(SLOTS)]),
    }
    print(f"[K1q] qwen3-1.7b engine shapes, int8 cache {SLOTS}x{LEN}x{KVH}x{HD}, "
          f"{LAYERS} caches ({smi})")
    for label, (sq, qo, kl) in shapes.items():
        qs = [torch.randn(SLOTS, sq, H, HD, device=dev, generator=g).to(bf) for _ in caches]
        kw = dict(causal=True, q_offset=lane(qo), kv_len=lane(kl))
        k8, v8, ks, vs, kb, vb = caches[0]
        out, lse = flash_attention_int8(qs[0], k8, v8, ks, vs, **kw)
        r_out, r_lse = flash_attention_ref(qs[0], k8, v8, k_scale=ks, v_scale=vs, **kw)
        err = (out.float() - r_out.float()).abs().max().item()
        lse_err = (lse - r_lse).abs().max().item()
        dead = [i for i, n in enumerate(kl) if n == 0]
        zero = all(torch.count_nonzero(out[i]).item() == 0 for i in dead)
        ok = err <= 2e-2 and lse_err <= 1e-3 and zero
        if not ok:
            failures.append(f"K1q {label}")
        q8 = [(q, *c[:4]) for q, c in zip(qs, caches)]
        k1 = [(q, c[4], c[5]) for q, c in zip(qs, caches)]
        f32 = [(q.float(), *c[:4]) for q, c in zip(qs, caches)]
        split = planned(SLOTS, sq, H, KVH, LEN, sms)
        t_q8 = time_ms(torch, lambda q, k, v, a, b: flash_attention_int8(q, k, v, a, b, **kw), q8)
        fa.kv_splits = lambda *_: 1
        t_q8_1 = time_ms(torch, lambda q, k, v, a, b: flash_attention_int8(q, k, v, a, b, **kw),
                         q8)
        fa.kv_splits = planned
        t_k1 = time_ms(torch, lambda q, k, v: flash_attention(q, k, v, **kw), k1)
        t_fma = time_ms(torch, lambda q, k, v, a, b: flash_attention_int8(q, k, v, a, b, **kw),
                        f32)
        valid = sum(kl)
        q8_bytes = 2 * KVH * HD * valid + 2 * SLOTS * sq * H * HD * 2
        print(f"    {label}: K1q ({fwd_path(qs[0])}, {split} splits) {t_q8:.4f} ms, max abs err "
              f"{err:.3e} (2e-2), lse {lse_err:.3e} (1e-3), empty lane zeros {zero} "
              f"{'ok' if ok else 'FAIL'}; unsplit {t_q8_1:.4f} ms; K1 ({fwd_path(qs[0])}) over "
              f"the bf16 cache {t_k1:.4f} ms (K1q / K1 {t_q8 / t_k1:.3f}); K1q f32 q "
              f"({fwd_path(f32[0][0])}) {t_fma:.4f} ms; int8 bytes' bound "
              f"{1e3 * q8_bytes / HBM_BYTES_PER_S:.4f} ms")
    print("    decode, every lane at one depth: K1q planned / unsplit / K1 over bf16, ms")
    qs = [torch.randn(SLOTS, 1, H, HD, device=dev, generator=g).to(bf) for _ in caches]
    for depth in (64, 128, 256, 512):
        kw = dict(causal=True, q_offset=lane([depth - 1] * SLOTS), kv_len=lane([depth] * SLOTS))
        q8 = [(q, *c[:4]) for q, c in zip(qs, caches)]
        times = [time_ms(torch, lambda q, k, v, a, b: flash_attention_int8(q, k, v, a, b, **kw),
                         q8)]
        fa.kv_splits = lambda *_: 1
        times.append(time_ms(torch, lambda q, k, v, a, b: flash_attention_int8(q, k, v, a, b,
                                                                                **kw), q8))
        fa.kv_splits = planned
        times.append(time_ms(torch, lambda q, k, v: flash_attention(q, k, v, **kw),
                             [(q, c[4], c[5]) for q, c in zip(qs, caches)]))
        print(f"      depth {depth}: " + " / ".join(f"{t:.4f}" for t in times))
    del caches

    dp = planner.device_params(dev)
    cases = [("f32 8192x8192", torch.float32, 8192, 8192),
             ("bf16 4096x16384", bf, 4096, 16384), ("bf16 6144x10240", bf, 6144, 10240),
             ("int8 8192x16384", torch.int8, 8192, 16384), ("f64 4096x4096", torch.float64, 4096, 4096)]
    print(f"[K6] transposes past the L2 ({smi})")
    for label, dt, m, n in cases:
        x = (torch.randn(m, n, device=dev, generator=g) * 50).to(dt)
        bt = planner.plan_transpose(m, n, dt, dp)["bt"]
        want = x.t().contiguous()
        exact, t = {}, {"scalar": [], "vec": []}
        for inst in ("scalar", "vec", "vec", "scalar"):  # in turns, path() forced
            k6._path = lambda *_, i=inst: i
            exact[inst] = torch.equal(bi_transpose(x, bt=bt), want)
            t[inst].append(time_ms(torch, lambda x: bi_transpose(x, bt=bt), [(x,)]))
        k6._path = chosen
        del want
        if not all(exact.values()):
            failures.append(f"K6 {label} {exact}")
        b_ms = 1e3 * 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S
        sc, vc = min(t["scalar"]), min(t["vec"])
        print(f"    {label} bt {bt} (path: {k6_path(x, bt)}): scalar {t['scalar']} vec "
              f"{t['vec']} ms; bound {b_ms:.4f} ms: scalar {100 * b_ms / sc:.1f}%, vec "
              f"{100 * b_ms / vc:.1f}% of it; exact {exact}")
        del x
    if failures:
        print(f"k1q_k6 FAILED: {failures}", file=sys.stderr)
        return 1
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
