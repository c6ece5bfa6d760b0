"""Batched serving on the PyTorch port: lockstep greedy decode with
per-request prompts and lengths, on ``make_debug_mesh``.

  python examples/serve_lm_torch.py --arch qwen3-1.7b --batch 4
  python examples/serve_lm_torch.py --device cpu

The counterpart of ``examples/serve_lm.py`` (f32 smoke config).
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.serve import Request, Server
from repro_torch.models import RunOptions


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_smoke_config(args.arch), dtype="float32")
    server = Server(cfg, mesh=make_debug_mesh(tp=1, device=args.device), max_len=96,
                    opts=RunOptions(remat="none"))

    rng = np.random.default_rng(0)
    reqs = [
        Request(i, rng.integers(3, cfg.vocab_size, int(rng.integers(4, 24))).astype(np.int32),
                max_new=args.max_new)
        for i in range(args.batch)
    ]
    out = server.run_batch(reqs)
    print(f"served {out['tokens']} tokens in {out['wall_s']:.2f}s "
          f"({out['tok_per_s']:.1f} tok/s, batch={args.batch}) on {server.device}")
    for r in reqs:
        print(f"  req {r.uid} (prompt {len(r.prompt):2d} toks) -> {r.out}")
    return reqs


if __name__ == "__main__":
    main()
