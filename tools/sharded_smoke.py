#!/usr/bin/env python3
"""Sharded execution on the card: ``chip_smoke.py``'s phase 20 alone.

    python3 tools/sharded_smoke.py
    python3 tools/sharded_smoke.py --device cpu --smoke --train-layers 2

Builds the kernels, then runs ``chip_smoke.phase_20``: K1, K2 and K3 held
to their plain versions at ``qwen3-1.7b``'s shard shapes on the ``(2, 2)``
mesh, and four ranks that share the card over gloo serving and training
against this process's one-device runs (tokens, logits and losses gated;
a decode step's wall and collectives, each rank's peak memory printed).
``--device cpu --smoke`` rehearses it on the CPU at the smoke config.
Then it reads what (b)'s gate (``chip_smoke.SHARD_F32_DISTANCE``)
makes of two sharded runs made wrong on purpose, on the same prompts:
``bf16-partials``, the row-parallel products' partial sums rounded to bf16
and all-reduced in bf16 (lower precision, not a fault), and
``swapped-wo``, the last layer's attention output rows cut at the other
model rank's offset (a layout fault): each one's distance from the f32
model's logits over the one-device bf16 server's, and the gate's verdict.
Exits 1 on a failed gate.  Prints the card's name and power limit; imports
nothing of JAX.
"""
import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CONTROLS = ("bf16-partials", "swapped-wo")


def control_rank(spec):
    """One rank of the controls: phase 20 (b)'s bf16 server on the ``(2,
    2)`` mesh, prefilling the same prompts under each control in turn;
    returns rank 0's whole last-token logits by control."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import collectives, planner
    from repro_torch.launch.mesh import make_debug_mesh, mesh_device
    from repro_torch.launch.serve import Server

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_debug_mesh(cs.SHARD_RANKS, tp=cs.SHARD_TP, device=spec["device"])
    dev = mesh_device(mesh)
    cfg = get_config(spec["arch"]) if spec["full"] else get_smoke_config(spec["arch"])
    server = Server(cfg, mesh=mesh, max_batch=cs.BATCH, max_len=cs.MAX_LEN)
    prompts = spec["prompts"]
    plen = max(map(len, prompts))
    toks = np.zeros((len(prompts), plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    tokens = torch.from_numpy(toks).to(dev)
    out = {}

    reduce_from = collectives.reduce_from
    collectives.reduce_from = lambda x, m, a: reduce_from(x.to(cfg.activation_dtype), m, a)
    try:
        out["bf16-partials"] = server.prefill(tokens)[0].float().cpu()
    finally:
        collectives.reduce_from = reduce_from

    wo = server.model.layers[-1].wo
    whole = planner.gather({"wo": wo})["wo"]
    half = whole.shape[0] // 2
    with torch.no_grad():
        wo.copy_(planner.placement(wo).cut(torch.cat([whole[half:], whole[:half]])))
    out["swapped-wo"] = server.prefill(tokens)[0].float().cpu()
    return out if torch.distributed.get_rank() == 0 else None


def controls(res, device):
    """Spawn the control ranks and print each control's reading of (b)'s
    gate beside the sound run's."""
    import chip_smoke as cs
    from repro_torch.launch.mesh import spawn

    one, r0 = res["one"], res["ranks"][0]
    f32 = one["b_logits_f32"]

    def dist(x):
        return (x - f32).abs().max().item()

    d_one = dist(one["b_logits"])
    got = spawn(control_rank, cs.SHARD_RANKS, res["spec"], device=device)[0]
    print(f"[20c] (b)'s gate, the distance from the f32 model's logits over the one-device "
          f"bf16 server's {d_one:.6e} (limit {cs.SHARD_F32_DISTANCE:g}): sound run "
          f"{dist(r0['b_logits']) / d_one:.4f}")
    for name in CONTROLS:
        ratio = dist(got[name]) / d_one
        print(f"    {name}: {dist(got[name]):.6e}, ratio {ratio:.4f}, "
              f"{'passes' if ratio <= cs.SHARD_F32_DISTANCE else 'rejected'}; from the "
              f"one-device bf16 logits {(got[name] - one['b_logits']).abs().max().item():.6e}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config for (b) and (c) (a CPU rehearsal)")
    ap.add_argument("--train-layers", type=int, default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    import chip_smoke as cs

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("sharded_smoke: CUDA is not available", file=sys.stderr)
            return 1
        from repro_torch.kernels import _build

        _build.build()
        torch.backends.cuda.matmul.allow_tf32 = False
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
    else:
        smi = "CPU rehearsal: no device numbers"
    print(smi)
    failures, max_err = [], {}
    try:
        res = cs.phase_20(torch, np, dev, smi, cs.comparer(max_err, failures), failures,
                          full=not args.smoke,
                          train_layers=args.train_layers or cs.SHARD_TRAIN_LAYERS)
        cs.check(not failures, f"phase 20 failed: {failures}")
        controls(res, dev.type)
    except cs.SmokeFailure as e:
        print(f"sharded_smoke FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
