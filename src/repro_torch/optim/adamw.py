"""Decoupled AdamW with bf16 params and f32 master copies: the counterpart
of ``repro/optim/adamw.py``, with the same semantics.

Parameters and gradients are dicts of tensors keyed by parameter name (the
JAX pytree's leaves).  The state holds an int32 ``step`` and f32 ``master``,
``m`` and ``v`` per parameter.  Each update clips by the global gradient
norm, bias-corrects, applies weight decay to *every* leaf (norms and the
embedding included, as JAX ``adamw.py:62-67`` does) and re-casts each
parameter from its master.

Where JAX returns new trees, :func:`adamw_update` updates ``master``, ``m``,
``v`` and the parameters in place under ``torch.no_grad`` and returns the
same objects: a full-width state would otherwise be copied every step.  The
step counter, the norm and the clip scale stay on the device, so an update
never waits on the host.

On a sharded mesh the parameters, gradients and state are this rank's
blocks (``core/planner.py``'s ``Placement``): :func:`adamw_init` tags the
state's leaves as their parameters are tagged, :func:`global_norm` is the
norm of the whole gradient (the squares of split leaves summed over the
axes they are split over, each replicated leaf counted once), and the
update runs on the local blocks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core import collectives, planner


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params: dict[str, torch.Tensor]) -> dict:
    """f32 master copies and zero moments for each parameter; step 0."""
    device = next(iter(params.values())).device

    def like(p, t):
        return planner.tag(t, planner.placement(p))

    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "master": {n: like(p, p.detach().float().clone()) for n, p in params.items()},
        "m": {n: like(p, torch.zeros(p.shape, dtype=torch.float32, device=p.device))
              for n, p in params.items()},
        "v": {n: like(p, torch.zeros(p.shape, dtype=torch.float32, device=p.device))
              for n, p in params.items()},
    }


def global_norm(tree: dict[str, torch.Tensor], placements: Optional[dict] = None
                ) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares.  With
    ``placements`` (name -> ``planner.Placement`` or None), leaves that are
    blocks of split tensors have their squares summed over the axes they
    are split over, so every rank gets the whole gradient's norm."""
    if not placements or all(pl is None for pl in placements.values()):
        return torch.sqrt(sum(g.float().square().sum() for g in tree.values()))
    groups: dict = {}
    for name, g in tree.items():
        pl = placements.get(name)
        key = () if pl is None else pl.split_axes()
        groups[key] = groups.get(key, 0) + g.float().square().sum()
    mesh = next(pl.mesh for pl in placements.values() if pl is not None)
    return torch.sqrt(sum(collectives.all_sum(v, mesh, axes) if axes else v
                          for axes, v in sorted(groups.items())))


@torch.no_grad()
def adamw_update(params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
                 opt_state: dict, cfg: AdamWConfig) -> tuple[dict, dict, dict]:
    """One AdamW step, in place (see the module docstring).  Returns
    ``(params, opt_state, metrics)`` with ``metrics = {"grad_norm", "lr"}``."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads, {n: planner.placement(p) for n, p in params.items()})
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
             if cfg.grad_clip else 1.0)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    for name, p in params.items():
        master, m, v = (opt_state[k][name] for k in ("master", "m", "v"))
        g = grads[name].float() * scale
        m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1.0 - cfg.b2) * g.square())
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * master
        master.sub_(cfg.lr * delta)
        p.copy_(master)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm,
                               "lr": torch.full((), cfg.lr, device=step.device)}
