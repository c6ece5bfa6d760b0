#!/usr/bin/env python3
"""Multi-device planning on the card: ``chip_smoke.py``'s phase 19 alone.

    python3 tools/mesh_plan.py

Builds the kernels, serves phase 8's 16 requests through the ``Engine``
(``qwen3-1.7b`` at full width, bf16, 8 slots, analytic plans) for the
tokens phase 19 holds ``Engine.restart`` to, then runs
``chip_smoke.phase_19``: training on the one-card mesh against the run
without one, the checkpoint's ``mesh_shape`` and its restore by
``elastic_restore``, ``Engine.restart`` on the mesh, ``trace_analysis`` of a
training and a decode step beside their device time, and the dry run of
three cells on the host.  Exits 1 on a failed gate.  Prints the card's name
and power limit, and last phase 19's numbers as JSON; imports nothing of
JAX.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("mesh_plan: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.serve import Request
    from repro_torch.models import RunOptions

    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    _, reset_counts, counts = cs.launch_counters()
    dev = torch.device("cuda")
    cfg = get_config(cs.ARCH)
    workload = cs.engine_workload(np, cfg.vocab_size)
    engine = Engine(cfg, device="cuda", max_batch=cs.SLOTS, max_len=cs.ENGINE_LEN,
                    chunk=cs.CHUNK, opts=RunOptions(autotune="off"))
    reqs = [Request(i, p, max_new=m) for i, (p, m) in enumerate(workload)]
    engine.run(reqs)
    tokens = [r.out for r in reqs]
    del engine
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        out = cs.phase_19(torch, np, dev, smi, counts, reset_counts, workload, tokens)
    except cs.SmokeFailure as e:
        print(f"mesh_plan FAILED: {e}", file=sys.stderr)
        return 1
    print(f"phase 19 in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({k: v for k, v in out.items()}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
