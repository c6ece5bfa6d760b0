#!/usr/bin/env python3
"""``olmoe-1b-7b`` trained at full width, and its checkpoint round trip, on
the card: ``chip_smoke.py``'s phases 13 and 13b alone.

    python3 tools/moe_train.py

Builds the kernels, then runs ``chip_smoke.phase_13``: the depth that
leaves 8 GB of the card free at peak (on a fresh process the whole card is
free, so it may be deeper than in ``chip_smoke.py``, whose earlier phases
hold some memory), 3 AdamW steps at 4 x 128 tokens under the fault-tolerant
runner with one injected retry against an unfaulted run, one step's device
time by ``torch.profiler``, the batched backward timed beside its bound and
``torch.bmm``, and the 1-layer checkpoint round trip in a temporary
directory.  Exits 1 on a failed gate.  Prints the card's name and power
limit, and last the batched backward's numbers as JSON; imports nothing of
JAX.
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
        print("moe_train: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build

    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    _, reset_counts, counts = cs.launch_counters()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    try:
        out = cs.phase_13(torch, np, dev, g, smi, counts, reset_counts, cs.REGISTRY_KERNELS)
    except cs.SmokeFailure as e:
        print(f"moe_train FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
