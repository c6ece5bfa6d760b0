#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1, no result line):

1. Build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, in parallel) and print the card's name and power
   limit.
2. Hold each kernel against its plain PyTorch version on the card, at the
   serving path's shapes, within the tolerances printed beside each case.
3. Serve the ``qwen3-1.7b`` smoke config at f32 with one set of parameters
   on the card and on the CPU (plain versions): identical greedy tokens.
4. Serve ``qwen3-1.7b`` at full width in bf16 from a seeded init: 4
   requests, prompts of 16-64 tokens, 16 new tokens each, a 256-slot cache.
   Every kernel's launch count is set to 0 just before the run and read
   just after; each must be > 0.
5. Time each kernel, its plain version and the PyTorch library call for the
   same function at phase 4's shapes, beside the least time the card could
   take (bytes over 3.35 TB/s or operations over the bf16 peak of
   989 TFLOP/s, whichever is larger; the H100 SXM data sheet).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX or
of the ``repro`` package.
"""
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
L2_BYTES = 50 * 2 ** 20
ARCH = "qwen3-1.7b"
BATCH, MAX_NEW, MAX_LEN = 4, 16, 256


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def bound_ms(nbytes, ops, dtype):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, arg_sets, reps=5):
    """Device milliseconds per call: calls cycling through ``arg_sets``
    (sized past the L2 cache where the real caller finds its operands cold)
    are captured in one CUDA graph and replayed, timed with CUDA events, so
    the host's cost of launching each call is left out."""
    iters = max(20, len(arg_sets))
    for args in arg_sets:  # warm-up outside the capture
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def copies_past_l2(nbytes):
    return max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1)))


def main():
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script", file=sys.stderr)
        return 1
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import torch.nn.functional as F

    from repro_torch.configs import get_config, get_smoke_config, reduced
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.kernels.hbp_matmul import hbp_matmul, matmul_ref
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import build_model

    # f32 products on the card stay full f32 (the plain versions' reference)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = {"hbp_matmul": hbp_matmul, "flash_attention": flash_attention}

    def reset_counts():
        for k in kernels.values():
            k.launches = 0

    def counts():
        return {name: k.launches for name, k in kernels.items()}

    # -- 1. build ------------------------------------------------------------
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"[1] built {sorted(logs) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():  # ptxas -v, one line per source
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill stores", log))
        print(f"    {name}: {len(regs)} kernels, at most {max(regs, default=0)} "
              f"registers, {spills} bytes of spill stores in all")
    print(smi)

    # -- 2. kernels against their plain versions ------------------------------
    cfg = get_config(ARCH)
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    weights = {"wq": (d, cfg.q_dim), "wk": (d, cfg.kv_dim), "wv": (d, cfg.kv_dim),
               "wo": (cfg.q_dim, d), "w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)}
    tol = {"bfloat16": (1e-2, 2 ** -7), "float32": (1e-4, 1e-4)}  # (atol, rtol)
    g = torch.Generator(device=dev).manual_seed(0)
    max_err = {"hbp_matmul": 0.0, "flash_attention": 0.0}
    failures = []

    def compare(kernel, label, got, want, dtype, atol=None, rtol=None):
        a_tol, r_tol = tol[dtype] if atol is None else (atol, rtol)
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        ok = bool((diff <= a_tol + r_tol * want.float().abs()).all())
        max_err[kernel] = max(max_err[kernel], err)
        print(f"    {kernel:15s} {label:44s} max_abs_err {err:.3e} "
              f"(atol {a_tol:g} + rtol {r_tol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{kernel} {label}")

    # phase 4's prompts, drawn here so that phase 2 checks its exact shapes too
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, V, n).astype(np.int32) for n in rng.integers(16, 65, BATCH)]
    plen = max(map(len, prompts))

    print(f"[2] kernels vs plain versions on the card ({ARCH} shapes; phase 4 "
          f"prefills {BATCH} x {plen} tokens)")
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for T in (4, 256, BATCH * plen):
            x = {kk: torch.randn(T, kk, device=dev, generator=g).to(dt) for kk in (d, ff)}
            for name, (kk, n) in weights.items():
                w = (torch.randn(kk, n, device=dev, generator=g) / math.sqrt(kk)).to(dt)
                compare("hbp_matmul", f"{dtype} {name} ({T}x{kk} @ {kk}x{n})",
                        hbp_matmul(x[kk], w), matmul_ref(x[kk], w), dtype)
        table = (0.02 * torch.randn(V, d, device=dev, generator=g)).to(dt)
        xs = torch.randn(4, d, device=dev, generator=g).to(dt)
        compare("hbp_matmul", f"{dtype} logits (4x{d} @ ({V}x{d})^T view)",
                hbp_matmul(xs, table.T), matmul_ref(xs, table.T), dtype)
        del table

        for sq in (64, plen):
            q = torch.randn(BATCH, sq, h, hd, device=dev, generator=g).to(dt)
            kv = [torch.randn(BATCH, sq, kvh, hd, device=dev, generator=g).to(dt) for _ in "kv"]
            out, lse = flash_attention(q, *kv, causal=True)
            r_out, r_lse = flash_attention_ref(q, *kv, causal=True)
            compare("flash_attention", f"{dtype} prefill causal {sq}x{sq} out", out, r_out,
                    dtype, *((1e-5, 0.0) if dtype == "float32" else (None, None)))
            compare("flash_attention", f"{dtype} prefill causal {sq}x{sq} lse", lse, r_lse,
                    dtype, 1e-4, 1e-5)
        q1 = torch.randn(BATCH, 1, h, hd, device=dev, generator=g).to(dt)
        cache = [torch.randn(BATCH, MAX_LEN, kvh, hd, device=dev, generator=g).to(dt)
                 for _ in "kv"]
        lane = lambda xs: torch.tensor(xs, dtype=torch.int32, device=dev)  # noqa: E731
        decode_cases = [
            ("decode scalar kv_len", 0, lane([100]), lane([101]), []),
            ("decode (b,) lanes, kv_len 0 lane", 0, lane([17, 255, 0, 40]),
             lane([18, 256, 0, 41]), [2]),
            ("decode window 16, fully masked row", 16, lane([100, 50, 30, 200]),
             lane([101, 51, 0, 60]), [2, 3]),
        ]
        for label, window, qo, kl, dead in decode_cases:
            out, lse = flash_attention(q1, *cache, causal=True, window=window,
                                       q_offset=qo, kv_len=kl)
            r_out, r_lse = flash_attention_ref(q1, *cache, causal=True, window=window,
                                               q_offset=qo, kv_len=kl)
            compare("flash_attention", f"{dtype} {label} out", out, r_out, dtype,
                    *((1e-5, 0.0) if dtype == "float32" else (None, None)))
            compare("flash_attention", f"{dtype} {label} lse", lse, r_lse, dtype, 1e-4, 1e-5)
            for row in dead:
                if torch.count_nonzero(out[row]).item() != 0:
                    failures.append(f"flash_attention {dtype} {label}: row {row} not exact zeros")
            if dead:
                print(f"    {'flash_attention':15s} rows {dead} exact zeros: "
                      f"{all(torch.count_nonzero(out[r]).item() == 0 for r in dead)}")
    torch.cuda.synchronize()
    check(not failures, f"kernels disagree with their plain versions: {failures}")

    # -- 3. small parity: cuda vs cpu, f32 smoke config ------------------------
    small = reduced(get_smoke_config(ARCH), dtype="float32")
    host_model = build_model(small, device="cpu")
    host_model.init(torch.Generator().manual_seed(0))
    params = host_model.state_dict()
    small_rng = np.random.default_rng(1)
    small_prompts = [small_rng.integers(3, small.vocab_size, n).astype(np.int32)
                     for n in (5, 9, 12, 7)]
    tokens = {}
    for where in ("cuda", "cpu"):
        srv = Server(small, device=where, params=params, max_batch=BATCH, max_len=64)
        reqs = [Request(i, p, max_new=12) for i, p in enumerate(small_prompts)]
        srv.run_batch(reqs)
        tokens[where] = [r.out for r in reqs]
    print(f"[3] smoke f32 greedy tokens cuda == cpu: {tokens['cuda'] == tokens['cpu']} "
          f"({sum(map(len, tokens['cuda']))} tokens)")
    check(tokens["cuda"] == tokens["cpu"],
          f"cuda tokens {tokens['cuda']} != cpu tokens {tokens['cpu']}")

    # -- 4. full width ----------------------------------------------------------
    t0 = time.perf_counter()
    server = Server(cfg, device="cuda", max_batch=BATCH, max_len=MAX_LEN)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks = np.zeros((BATCH, plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    toks = torch.from_numpy(toks).to(dev)

    # launches per prefill and per decode step (also the warm-up)
    reset_counts()
    logits, kvc = server.model.prefill(toks, MAX_LEN)
    per_prefill = counts()
    reset_counts()
    server.model.decode_step(logits.argmax(-1).to(torch.int32)[:, None],
                             torch.tensor(plen, dtype=torch.int32, device=dev), kvc)
    per_step = counts()
    torch.cuda.synchronize()
    del logits, kvc

    reqs = [Request(i, p, max_new=MAX_NEW) for i, p in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = server.run_batch(reqs)
    launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[4] {ARCH} full width bf16 ({cfg.n_layers} layers, d={d}, {h}/{kvh} heads, "
          f"hd={hd}, d_ff={ff}, vocab={V}); init {init_s:.2f} s; prompts "
          f"{[len(p) for p in prompts]}; max_len {MAX_LEN}")
    print(f"    completed {out['completed']}; logits finite {out['logits_finite']}; "
          f"peak memory {peak_gb:.2f} GB")
    print(f"    launches in the run {launches}; per prefill {per_prefill}; "
          f"per decode step {per_step}")
    print(f"    prefill {1e3 * out['prefill_s']:.3f} ms; decode "
          f"{1e3 * out['decode_s'] / max(out['decode_steps'], 1):.3f} ms/step over "
          f"{out['decode_steps']} steps; {out['tok_per_s']:.1f} tok/s "
          f"({out['tokens']} tokens in {out['wall_s']:.3f} s)")
    check(all(len(r.out) == MAX_NEW for r in reqs), f"short requests: {out['completed']}")
    check(out["logits_finite"], "non-finite logits in the full-width run")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    steps = out["decode_steps"]
    for name in kernels:
        check(launches[name] == per_prefill[name] + steps * per_step[name],
              f"{name}: {launches[name]} launches, expected "
              f"{per_prefill[name]} + {steps} x {per_step[name]}")
    # the decode step's cache depth halfway through the run, for phase 5
    mid_pos = plen + steps // 2
    wall_step_ms = 1e3 * out["decode_s"] / max(steps, 1)

    # -- 5. times at phase 4's shapes -------------------------------------------
    print(f"[5] times in ms at phase 4's shapes, bf16, ({smi})")
    bf = torch.bfloat16
    es = 2
    rows = []

    def time_matmul(label, m, k, n, trans, calls):
        b_bytes = k * n * es
        sets = []
        for _ in range(copies_past_l2(b_bytes)):
            a = torch.randn(m, k, device=dev, generator=g).to(bf)
            w = torch.randn(n, k, device=dev, generator=g).to(bf)
            sets.append((a, w.T if trans else w.T.contiguous()))
        t_k = time_ms(torch, hbp_matmul, sets)
        t_p = time_ms(torch, matmul_ref, sets)
        t_l = time_ms(torch, torch.matmul, sets)
        nbytes = (m * k + k * n + m * n) * es
        b_ms, b_by = bound_ms(nbytes, 2 * m * n * k, "bfloat16")
        rows.append(dict(kernel="hbp_matmul", label=label, calls=calls, ms=t_k, plain_ms=t_p,
                         library_ms=t_l, bound_ms=b_ms, bytes=nbytes, ops=2 * m * n * k,
                         bound_by=b_by))
        del sets

    L = cfg.n_layers
    T_prefill = BATCH * plen
    for phase, T in (("decode", BATCH), ("prefill", T_prefill)):
        for name, (kk, n) in weights.items():
            time_matmul(f"{phase} {name} {T}x{kk}@{kk}x{n}", T, kk, n, False, L)
    time_matmul(f"logits {BATCH}x{d}@({V}x{d})^T", BATCH, d, V, True, 1)

    def sdpa(q, k, v, mask, causal):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            is_causal=causal, enable_gqa=True)

    def time_attention(label, sq, kv_lens, calls):
        sk = MAX_LEN if sq == 1 else sq
        sets, lib_sets = [], []
        for _ in range(L):  # one cache per layer, as the decode step reads them
            q = torch.randn(BATCH, sq, h, hd, device=dev, generator=g).to(bf)
            k = torch.randn(BATCH, sk, kvh, hd, device=dev, generator=g).to(bf)
            v = torch.randn(BATCH, sk, kvh, hd, device=dev, generator=g).to(bf)
            if sq == 1:
                kl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
                mask = (torch.arange(sk, device=dev)[None, :] < kl[:, None])[:, None, None, :]
                sets.append((q, k, v, kl, kl - 1))
                lib_sets.append((q, k, v, mask, False))
            else:
                sets.append((q, k, v, None, None))
                lib_sets.append((q, k, v, None, True))
        kern = lambda q, k, v, kl, qo: flash_attention(q, k, v, causal=True, q_offset=qo, kv_len=kl)  # noqa: E731
        plain = lambda q, k, v, kl, qo: flash_attention_ref(q, k, v, causal=True, q_offset=qo, kv_len=kl)  # noqa: E731
        t_k = time_ms(torch, kern, sets)
        t_p = time_ms(torch, plain, sets)
        t_l = time_ms(torch, sdpa, lib_sets)
        if sq == 1:
            pairs = h * sum(kv_lens)
            kv_bytes = 2 * kvh * hd * es * sum(kv_lens)
        else:
            pairs = BATCH * h * sq * (sq + 1) // 2
            kv_bytes = 2 * BATCH * sk * kvh * hd * es
        nbytes = 2 * BATCH * sq * h * hd * es + kv_bytes + BATCH * h * sq * 4
        b_ms, b_by = bound_ms(nbytes, 4 * hd * pairs, "bfloat16")
        rows.append(dict(kernel="flash_attention", label=label, calls=calls, ms=t_k,
                         plain_ms=t_p, library_ms=t_l, bound_ms=b_ms, bytes=nbytes,
                         ops=4 * hd * pairs, bound_by=b_by))

    time_attention(f"decode 4x1x{h}x{hd} vs cache {MAX_LEN}, kv_len {mid_pos + 1}",
                   1, [mid_pos + 1] * BATCH, L)
    time_attention(f"prefill causal 4x{plen}x{h}x{hd}", plen, None, L)

    print(f"    {'kernel':15s} {'shape':42s} {'calls':>5s} {'ms':>9s} {'plain_ms':>9s} "
          f"{'library':>9s} {'bound_ms':>9s} {'by':>10s} {'% bound':>8s}")
    for r in rows:
        print(f"    {r['kernel']:15s} {r['label']:42s} {r['calls']:5d} {r['ms']:9.4f} "
              f"{r['plain_ms']:9.4f} {r['library_ms']:9.4f} {r['bound_ms']:9.4f} "
              f"{r['bound_by']:>10s} {100 * r['bound_ms'] / r['ms']:7.1f}%")

    # one whole decode step on the device: every kernel and elementwise op,
    # captured in a CUDA graph and replayed back to back (no host gaps)
    logits, kvc = server.model.prefill(toks, MAX_LEN)
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    pos = torch.tensor(mid_pos, dtype=torch.int32, device=dev)
    step_ms = time_ms(torch, lambda: server.model.decode_step(tok, pos, kvc), [()])
    kernel_step_ms = sum(r["ms"] * r["calls"] for r in rows
                         if not r["label"].startswith("prefill"))
    print(f"    decode step: {step_ms:.4f} ms on the device (CUDA graph replay), "
          f"{kernel_step_ms:.4f} ms of it in the two kernels (timed alone, cold L2); "
          f"{wall_step_ms:.3f} ms per step in phase 4's run: device busy "
          f"{100 * step_ms / wall_step_ms:.1f}% of the wall time")
    del server, logits, kvc

    # one entry per kernel: the sum over one decode step's calls
    step_rows = {name: [r for r in rows if r["kernel"] == name
                        and not r["label"].startswith("prefill")] for name in kernels}
    replaces = {"hbp_matmul": "src/repro/kernels/hbp_matmul.py:33",
                "flash_attention": "src/repro/kernels/flash_attention.py:137"}
    entries = []
    for name, rs in step_rows.items():
        tot = {key: sum(r[key] * r["calls"] for r in rs)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes", "ops")}
        print(f"    {name}: one decode step = {sum(r['calls'] for r in rs)} calls, "
              f"{tot['ms']:.4f} ms (bound {tot['bound_ms']:.4f} ms)")
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max_err[name], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": ("bytes" if tot["bytes"] / HBM_BYTES_PER_S
                         >= tot["ops"] / PEAK_OPS["bfloat16"] else "operations"),
            "library_ms": tot["library_ms"],
        })
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
