"""End-to-end LM training on the PyTorch port: data pipeline -> PWS-planned
placement on ``make_debug_mesh`` -> fault-tolerant loop with checkpoints in
the JAX package's format.

Presets:
  10m  (default) ~10M params
  100m           ~100M params (the deliverable-scale config; same code)

  python examples/train_lm_torch.py --preset 10m --steps 300
  python examples/train_lm_torch.py --device cpu --steps 20

The counterpart of ``examples/train_lm.py``.
"""
import argparse
import logging
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.train import train
from repro_torch.models import RunOptions
from repro_torch.optim import AdamWConfig

PRESETS = {
    "10m": ModelConfig(
        name="lm-10m", family="dense", n_layers=4, d_model=256, n_heads=4,
        n_kv_heads=2, d_ff=1024, vocab_size=8192, qk_norm=True,
    ),
    "100m": ModelConfig(
        name="lm-100m", family="dense", n_layers=10, d_model=640, n_heads=10,
        n_kv_heads=5, d_ff=2560, vocab_size=50304, qk_norm=True,
    ),
}


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="10m", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temporary one)")
    args = ap.parse_args(argv)

    cfg = PRESETS[args.preset]
    out = train(
        cfg,
        mesh=make_debug_mesh(tp=1, device=args.device),
        steps=args.steps,
        data_cfg=DataConfig(global_batch=args.batch, seq_len=args.seq, seed=0),
        opts=RunOptions(remat="none"),
        opt_cfg=AdamWConfig(lr=6e-4),
        ckpt_dir=args.ckpt_dir or tempfile.mkdtemp(prefix="repro_train_lm_torch_"),
        save_every=max(args.steps // 3, 1),
        log_every=20,
    )
    n = min(len(out["losses"]), 10)
    first = sum(out["losses"][:n]) / n
    last = sum(out["losses"][-n:]) / n
    print(f"\nloss {first:.4f} -> {last:.4f} over {args.steps} steps "
          f"({out['wall_s']:.0f}s, {out['wall_s'] / args.steps * 1e3:.0f} ms/step)")
    assert last < first, "training did not learn"
    return out


if __name__ == "__main__":
    main()
