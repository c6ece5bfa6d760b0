"""Device times of the attention kernels (K1, K1q, K3) at the shapes of
``chip_smoke.py`` phases 5, 7, 9 and 12, and a hash of each attention
kernel's SASS, for the ``repro_torch`` package under ``--src``.

    python3 tools/attn_times.py [--src DIR]

``--src`` (default: this checkout's ``src``) lets one call on one card time
two trees in turn, for example a parent commit unpacked under ``build/``:
run the script once per tree, alternating (parent, change, change, parent),
and compare the lines.  Equal SASS hashes mean the two trees compiled an
instance to the same machine code.  Shapes, bf16, one cache or tile set per
layer as the step reads them (past the 50 MB L2):

* ``chip_smoke.ARCH`` (``qwen3-1.7b``, hd 128): K1 decode against phase
  5's cache at its halfway kv_len, K1 prefill over phase 4's prompts, K1
  forward and K3 at phase 6's training shape; K1q decode and a chunk over
  phase 8's int8 cache at lanes spread over it;
* ``chip_smoke.GEMMA_ARCH`` (``gemma3-1b``, hd 256; skipped where the tree
  has no hd 256): K1 and K1q decode over phase 12's cache with the arch's
  window, K3 at phase 12's training shape with that window.

The shapes are ``chip_smoke.py``'s constants and the arch's config from
``--src``.

Each time is the mean per call over CUDA-graph replays (CUDA events,
``chip_smoke.time_ms``).  The last line is one JSON object with every
number, the card's name and power limit.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # the package itself comes from --src

from chip_smoke import (  # noqa: E402
    ARCH, BATCH, CHUNK, ENGINE_LEN, GEMMA_ARCH, GEMMA_LEN, GEMMA_TRAIN_BATCH, GEMMA_TRAIN_SEQ,
    MAX_LEN, MAX_NEW, SLOTS, TRAIN_BATCH, TRAIN_SEQ, int8_cache_hd, time_ms)


def sass_hashes(lib: Path) -> dict:
    """sha256 (16 hex digits) of each kernel's SASS in ``lib``, by its
    mangled name."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for chunk in sass.split("Function : ")[1:]:
        mangled, body = chunk.split(None, 1)
        # the anonymous namespace's mangled name carries a per-source hash
        name = re.sub(r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "(anonymous)", mangled)
        out[name] = hashlib.sha256(body.encode()).hexdigest()[:16]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("attn_times: CUDA is not available", file=sys.stderr)
        return 1
    src = str(Path(args.src).resolve())
    sys.path.insert(0, src)
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    # the package exports the wrapper under the module's name
    fa = importlib.import_module("repro_torch.kernels.flash_attention")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    _build.build(["flash_attention", "flash_attention_bwd"])
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=g).to(bf)

    def lane(xs):
        return torch.tensor(xs, dtype=torch.int32, device=dev)

    def fwd(q, k, v, qo, kl, w, ks=None, vs=None):
        return fa.flash_attention(q, k, v, causal=True, window=w, q_offset=qo, kv_len=kl,
                                  k_scale=ks, v_scale=vs)

    def bwd(q, k, v, out, lse, go, w):
        return fa.flash_attention_bwd(q, k, v, out, lse, go, causal=True, window=w)

    def train_sets(b, s, h, kvh, hd, w):
        sets = []
        for _ in range(4):
            q, k, v, go = randn(b, s, h, hd), randn(b, s, kvh, hd), randn(b, s, kvh, hd), \
                randn(b, s, h, hd)
            out, lse = fwd(q, k, v, None, None, w)
            sets.append((q, k, v, out, lse, go, w))
        return sets

    times = {}
    # phases 4-9's arch at hd 128: phase 4's prompts, phase 5's halfway decode
    # depth, phase 6's training shape, phase 8's engine cache
    cfg = get_config(ARCH)
    L, h, kvh, hd = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    plen = int(max(np.random.default_rng(0).integers(16, 65, BATCH)))
    mid = plen + (MAX_NEW - 1) // 2
    times[f"k1 decode {BATCH}x1 vs {MAX_LEN} (hd {hd})"] = time_ms(torch, fwd, [
        (randn(BATCH, 1, h, hd), randn(BATCH, MAX_LEN, kvh, hd), randn(BATCH, MAX_LEN, kvh, hd),
         lane([mid - 1] * BATCH), lane([mid] * BATCH), 0) for _ in range(L)])
    times[f"k1 prefill {BATCH}x{plen} (hd {hd})"] = time_ms(torch, fwd, [
        (randn(BATCH, plen, h, hd), randn(BATCH, plen, kvh, hd), randn(BATCH, plen, kvh, hd),
         None, None, 0) for _ in range(L)])
    train = train_sets(TRAIN_BATCH, TRAIN_SEQ, h, kvh, hd, 0)
    times[f"k1 train fwd {TRAIN_BATCH}x{TRAIN_SEQ} (hd {hd})"] = time_ms(
        torch, fwd, [(q, k, v, None, None, 0) for q, k, v, *_ in train])
    times[f"k3 train {TRAIN_BATCH}x{TRAIN_SEQ} (hd {hd})"] = time_ms(torch, bwd, train)
    qo = [ENGINE_LEN * (2 * i + 1) // (2 * SLOTS) for i in range(SLOTS)]  # mid-run lanes
    q8 = [int8_cache_hd(SLOTS, kvh, hd, ENGINE_LEN, dev, g) for _ in range(L)]
    times[f"k1q decode {SLOTS}x1 vs int8 {ENGINE_LEN} (hd {hd})"] = time_ms(torch, fwd, [
        (randn(SLOTS, 1, h, hd), k8, v8, lane(qo), lane([p + 1 for p in qo]), 0, ks, vs)
        for k8, v8, ks, vs in q8])
    cq = [min(p, ENGINE_LEN - CHUNK) for p in qo]
    times[f"k1q chunk {SLOTS}x{CHUNK} vs int8 {ENGINE_LEN} (hd {hd})"] = time_ms(torch, fwd, [
        (randn(SLOTS, CHUNK, h, hd), k8, v8, lane(cq), lane([p + CHUNK for p in cq]), 0, ks, vs)
        for k8, v8, ks, vs in q8])
    del q8, train
    if 256 in fa.HEAD_DIMS:
        # phase 12's arch at hd 256: its engine cache and training shape
        cfg = get_config(GEMMA_ARCH)
        L, h, kvh, hd, w = (cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
                            cfg.sliding_window)
        qo = [GEMMA_LEN * (2 * i + 1) // (2 * SLOTS) for i in range(SLOTS)]
        kl = [p + 1 for p in qo]
        times[f"k1 decode {SLOTS}x1 vs {GEMMA_LEN} window {w} (hd {hd})"] = time_ms(torch, fwd, [
            (randn(SLOTS, 1, h, hd), randn(SLOTS, GEMMA_LEN, kvh, hd),
             randn(SLOTS, GEMMA_LEN, kvh, hd), lane(qo), lane(kl), w) for _ in range(L)])
        times[f"k1q decode {SLOTS}x1 vs int8 {GEMMA_LEN} window {w} (hd {hd})"] = time_ms(
            torch, fwd, [(randn(SLOTS, 1, h, hd), k8, v8, lane(qo), lane(kl), w, ks, vs)
                         for k8, v8, ks, vs in (int8_cache_hd(SLOTS, kvh, hd, GEMMA_LEN, dev, g)
                                                for _ in range(L))])
        train = train_sets(GEMMA_TRAIN_BATCH, GEMMA_TRAIN_SEQ, h, kvh, hd, w)
        times[f"k3 train {GEMMA_TRAIN_BATCH}x{GEMMA_TRAIN_SEQ} window {w} (hd {hd})"] = \
            time_ms(torch, bwd, train)
    sass = {}
    for name in ("flash_attention", "flash_attention_bwd"):
        sass.update(sass_hashes(_build.library_path(name)))
    for key, t in times.items():
        print(f"{key:48s} {t:.5f} ms")
    print(f"SASS of {len(sass)} attention kernels hashed ({smi})")
    print(json.dumps({"src": src, "device": smi, "times_ms": times, "sass": sass}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
