"""Quickstart on the PyTorch port: build an assigned architecture, inspect
the PWS plan on a mesh, run one training step and a prefill + decode round
trip, on ``make_debug_mesh`` (the card's (1, 1) mesh, or the CPU's).

  python examples/quickstart_torch.py                # CUDA
  python examples/quickstart_torch.py --device cpu   # the plain versions

The counterpart of ``examples/quickstart.py``.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import planner
from repro_torch.launch.mesh import axis_sizes, make_debug_mesh, mesh_device
from repro_torch.models import RunOptions, build_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1. pick an architecture (reduced config), on the debug mesh's device
    mesh = make_debug_mesh(1, tp=1, device=args.device)
    dev = mesh_device(mesh)
    cfg = get_smoke_config("qwen3-1.7b")
    model = build_model(cfg, RunOptions(remat="none"), device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    print(f"arch={cfg.name} family={cfg.family} params={n_params:,} mesh={axis_sizes(mesh)}")

    # 2. the PWS planner: resource-oblivious model, mesh-aware plan
    specs = planner.plan_params(params, mesh)
    planner.place(params, specs, mesh)
    print("\nPWS plan (sample):")
    for name in list(specs)[:5]:
        print("  ", name, "->", specs[name])

    # 3. one training step (loss and gradients)
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(3, cfg.vocab_size, (2, 32), generator=g, device=dev,
                           dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    loss = model.loss(batch)
    loss.backward()
    print(f"\ntrain loss: {loss.item():.4f}")

    # 4. prefill + decode
    with torch.no_grad():
        logits, cache = model.prefill(batch, 64)
        nxt = logits.argmax(-1)[:, None].to(torch.int32)
        for i in range(4):
            pos = torch.tensor(32 + i, dtype=torch.int32, device=dev)
            logits, cache = model.decode_step(nxt, pos, cache)
            nxt = logits.argmax(-1)[:, None].to(torch.int32)
            print(f"decoded token {i}: {nxt[:, 0].tolist()}")


if __name__ == "__main__":
    main()
