"""The trainer: the counterpart of ``repro/launch/train.py``.

config -> model (seeded init) -> synthetic data -> AdamW steps, every
matrix product on K2 (forward and backward), every attention forward on K1
and every attention backward on K3.  One device; the JAX trainer's mesh,
sharding planner, autotune and fault-tolerant checkpointing have no
counterpart yet (``ROADMAP.md``).  An MoE config raises: the batched expert
products have no backward yet, and a full-width MoE needs sharding to
train.

    python -m repro_torch.launch.train --arch qwen3-1.7b --steps 3
    python -m repro_torch.launch.train --arch gemma3-1b --reduced --device cpu --steps 2
    python -m repro_torch.launch.train --reduced --device cpu --steps 2
"""
from __future__ import annotations

import argparse
import logging
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.launch.steps import make_train_step
from repro_torch.models import RunOptions, UnsupportedFamilyError, build_model
from repro_torch.optim import AdamWConfig, adamw_init

log = logging.getLogger("repro_torch.train")


def train(cfg, *, steps: int, data_cfg: DataConfig,
          opts: RunOptions = RunOptions(), opt_cfg: AdamWConfig = AdamWConfig(),
          device=None, log_every: int = 10) -> dict:
    """Train ``cfg`` from a seeded init (``data_cfg.seed``) for ``steps``
    steps on ``device`` (CUDA unless told otherwise; raises without it).
    Returns the model, the optimizer state, per-step ``losses``,
    ``grad_norms`` and ``step_s`` (host wall time of each step, ended by
    reading its loss on the host), and ``wall_s``.  Raises
    ``UnsupportedFamilyError`` on an MoE config, on every device."""
    if cfg.n_experts:
        raise UnsupportedFamilyError(cfg.family, "MoE training")
    dev = resolve_device(device)
    ds = SyntheticLMDataset(data_cfg, cfg)
    model = build_model(cfg, opts, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(data_cfg.seed))
    opt_state = adamw_init(dict(model.named_parameters()))
    train_step = make_train_step(model, opt_cfg)

    losses, grad_norms, step_s = [], [], []
    t0 = time.perf_counter()
    for step in range(steps):
        t = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in ds.batch_at(step).items()}
        opt_state, metrics = train_step(opt_state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        step_s.append(time.perf_counter() - t)
        grad_norms.append(float(metrics["grad_norm"]))
        if log_every and step % log_every == 0:
            log.info("step %d loss %.4f (%.2fs)", step, losses[-1], time.perf_counter() - t0)
    return {"model": model, "opt_state": opt_state, "losses": losses,
            "grad_norms": grad_norms, "step_s": step_s,
            "wall_s": time.perf_counter() - t0}


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", help="smoke-size config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.reduced else get_config(args.arch)
    out = train(cfg, steps=args.steps,
                data_cfg=DataConfig(global_batch=args.batch, seq_len=args.seq),
                device=args.device)
    print(f"final loss {out['losses'][-1]:.4f} (first {out['losses'][0]:.4f}) "
          f"in {out['wall_s']:.1f}s on {out['model'].device}")


if __name__ == "__main__":
    main()
