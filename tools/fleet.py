#!/usr/bin/env python3
"""The fleet on the card: ``chip_smoke.py``'s phase 2 cases for it and its
phase 16 alone.

    python3 tools/fleet.py

Builds the kernels, holds K2 at the fused QKV width of ``qwen3-1.7b``
(2048 x 4096, 8 and 512 rows, bf16 and f32) against its plain version
(``chip_smoke.fused_qkv_checks``), then runs ``chip_smoke.phase_16``:
``qwen3-1.7b`` at full width and depth behind the ``Router`` (2 replicas of
4 slots, phase 8's 16 requests) by ``pws``, by ``rws``, with a replica's
death and checkpoint-streamed restart, with slot migrations, and with a
join and a leave, each against a single engine's tokens; then phase 8's
engine traffic with fused QKV beside the unfused run.  Exits 1 on a failed
gate.  Prints the card's name and power limit, and last phase 16's numbers
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
        print("fleet: CUDA is not available", file=sys.stderr)
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
        cs.fused_qkv_checks(torch, dev, g, cs.comparer(max_err, failures))
        cs.check(not failures, f"kernels disagree with their plain versions: {failures}")
        out = cs.phase_16(torch, np, dev, smi, counts, reset_counts, trace, counted,
                          finite_logits, cs.REGISTRY_KERNELS)
    except cs.SmokeFailure as e:
        print(f"fleet FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"phase_16": out, "max_abs_err": max_err}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
