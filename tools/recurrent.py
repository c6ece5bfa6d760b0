#!/usr/bin/env python3
"""The recurrent-state families at full width and depth on the card:
``chip_smoke.py``'s phase 14 alone.

    python3 tools/recurrent.py

Builds the kernels, then runs ``chip_smoke.phase_14``: ``recurrentgemma-2b``
through the Engine (8 slots, 4096 positions, chunk 256, 16 requests of
64-3072 prompt tokens) and through the Server with the linear and the ring
cache (its first decode logits compared), trained for 3 AdamW steps at
2 x 1024; K1 per decode step and K3 per training step beside their bounds,
plain versions and ``scaled_dot_product_attention``, the RG-LRU recurrence
per prefill chunk and per training step beside its bytes bound; then
``mamba2-370m`` through the Engine with the same requests and trained at
4 x 1024.  Exits 1 on a failed gate.  Prints the card's name and power
limit, and last phase 14's numbers as JSON; imports nothing of JAX.
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
        print("recurrent: CUDA is not available", file=sys.stderr)
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
    try:
        out = cs.phase_14(torch, np, dev, g, smi, counts, reset_counts, trace, counted,
                          finite_logits, cs.REGISTRY_KERNELS)
    except cs.SmokeFailure as e:
        print(f"recurrent FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
