#!/usr/bin/env python3
"""The measured autotune on the card: ``chip_smoke.py``'s phase 17 alone.

    python3 tools/autotune.py [--tune-dir DIR]

Builds the kernels, then runs ``chip_smoke.phase_17``: ``autotune.search``
on every distinct K2 product of one ``qwen3-1.7b`` engine decode step and
one 64-token chunk step, on the int8 K1q decode call and on phase 10's
scan, transpose, FFT and Strassen shapes (each winner held against its
plain version), then phase 8's engine traffic replayed on that table beside
the analytic plans.  The table is written under ``--tune-dir`` (default: a
temporary directory, removed after), one JSON file per device kind in the
JAX table format, which ``REPRO_TUNE_DIR=DIR`` then replays in any run of
the port on the same card, torch and kernel sources.  Exits 1 on a failed
gate.
Prints the card's name and power limit, and last the phase's numbers as
JSON; imports nothing of JAX.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tune-dir", default=None,
                    help="keep the searched table here (default: a temporary directory)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("autotune: CUDA is not available", file=sys.stderr)
        return 1
    tune = args.tune_dir or tempfile.mkdtemp(prefix="autotune_")
    os.environ["REPRO_TUNE_DIR"] = str(Path(tune).resolve())
    import chip_smoke as cs
    from repro_torch.kernels import _build

    try:
        _build.build()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip()
        print(smi)
        _, reset_counts, counts = cs.launch_counters()
        trace, counted, finite_logits = cs.engine_tracers(torch, counts)
        try:
            out = cs.phase_17(torch, np, torch.device("cuda"), smi, reset_counts, trace,
                              counted, finite_logits)
        except cs.SmokeFailure as e:
            print(f"autotune FAILED: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"phase_17": {k: v for k, v in out.items() if k != "rows"}}))
        return 0
    finally:
        if args.tune_dir is None:
            shutil.rmtree(tune, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
