"""Host wall per decode step of full-width qwen3-1.7b on one card, through
the lockstep ``Server`` and the continuous-batching ``Engine`` (bf16 cache),
for the ``repro_torch`` package under ``--src``.

    python3 tools/decode_wall.py [--src DIR] [--runs N]

``--src`` (default: this checkout's ``src``) lets one call on one host time
two trees in turn (for example a parent commit unpacked under ``build/``):
run the script once per tree, alternating, and compare the lines.  Each
path runs once to warm up and then ``--runs`` times; the weights are random
from a seed, the workloads are those of ``chip_smoke.py`` phases 4 and 8.
It also prints the host microseconds of one ``models.common.project`` call
at a decode step's 4 x 2048 @ 2048 x 2048 bf16 product (no grad, 2000
calls).  The last line is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ARCH = "qwen3-1.7b"
BATCH, MAX_NEW, MAX_LEN = 4, 16, 256
SLOTS, ENGINE_LEN, CHUNK, ENGINE_REQUESTS = 8, 512, 64, 16


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("decode_wall: CUDA is not available", file=sys.stderr)
        return 1
    src = str(Path(args.src).resolve())
    sys.path.insert(0, src)
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models.common import project

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    cfg = get_config(ARCH)
    V = cfg.vocab_size
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, V, n).astype(np.int32) for n in rng.integers(16, 65, BATCH)]
    erng = np.random.default_rng(0)
    workload = [(erng.integers(3, V, int(erng.integers(16, 193))).astype(np.int32),
                 int(erng.integers(8, 49))) for _ in range(ENGINE_REQUESTS)]

    def per_step(out):
        return 1e3 * out["decode_s"] / max(out["decode_steps"], 1)

    result = {"src": src, "device": smi}
    server = Server(cfg, device="cuda", max_batch=BATCH, max_len=MAX_LEN)
    lock = []
    for _ in range(args.runs + 1):
        out = server.run_batch([Request(i, p, max_new=MAX_NEW) for i, p in enumerate(prompts)])
        if not out["logits_finite"]:
            print("decode_wall: non-finite logits (lockstep)", file=sys.stderr)
            return 1
        lock.append(per_step(out))
    result["lockstep_decode_ms"] = lock[1:]

    d = cfg.d_model
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(BATCH, d, device="cuda", generator=g).to(torch.bfloat16)
    w = torch.randn(d, d, device="cuda", generator=g).to(torch.bfloat16)
    with torch.no_grad():
        project(a, w)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            project(a, w)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
    result["project_host_us"] = 1e6 * (t1 - t0) / 2000
    del server, a, w
    torch.cuda.empty_cache()

    engine = Engine(cfg, device="cuda", max_batch=SLOTS, max_len=ENGINE_LEN, chunk=CHUNK)
    eng = []
    for _ in range(args.runs + 1):
        reqs = [Request(i, p, max_new=m) for i, (p, m) in enumerate(workload)]
        out = engine.run(reqs)
        if len(out["completed"]) != len(reqs):
            print(f"decode_wall: engine completed {out['completed']}", file=sys.stderr)
            return 1
        eng.append(per_step(out))
    result["engine_decode_ms"] = eng[1:]
    print(f"{src}: lockstep decode ms/step {result['lockstep_decode_ms']}; engine decode "
          f"ms/step {result['engine_decode_ms']}; project host us "
          f"{result['project_host_us']:.2f} ({smi})")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
