#!/usr/bin/env python3
"""The cross-attention families on the card: ``chip_smoke.py``'s phase 2
cases for them and its phase 15 alone.

    python3 tools/cross_attention.py

Builds the kernels, holds K1 non-causal with ``sq != sk`` (over 1601 image
keys at hd 128, 512 frames at hd 64, 17 keys), K3 non-causal and K2 at the
256,206-column head (``stream``, ``wgmma``, the backward on ``wmma``)
against their plain versions (``chip_smoke.cross_kernel_checks``), then runs
``chip_smoke.phase_15``: ``seamless-m4t-large-v2`` at full width and depth
through the Engine (8 slots, 2048 positions, chunk 256, 16 requests with
their own frames) and the Server, trained for 3 AdamW steps at 4 x 1024;
``llama-3.2-vision-90b`` at full width and 10 layers, its gates drawn
non-zero, through the Engine and the Server; K1's cross-attention per
decode step, K3 per training step and the ``wmma`` head backward beside
their bounds, plain versions and the library calls.  Exits 1 on a failed
gate.  Prints the card's name and power limit, and last phase 15's numbers
and the cases' largest errors as JSON; imports nothing of JAX.
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("cross_attention: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build

    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    _, reset_counts, counts = cs.launch_counters()
    trace, counted, finite_logits = cs.engine_tracers(torch, counts)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    max_err, failures = {}, []
    try:
        cs.cross_kernel_checks(torch, dev, g, cs.comparer(max_err, failures), failures)
        cs.check(not failures, f"kernels disagree with their plain versions: {failures}")
        out = cs.phase_15(torch, np, dev, g, smi, counts, reset_counts, trace, counted,
                          finite_logits, cs.REGISTRY_KERNELS)
    except cs.SmokeFailure as e:
        print(f"cross_attention FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"phase_15": out, "max_abs_err": max_err}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
