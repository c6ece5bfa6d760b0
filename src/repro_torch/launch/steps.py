"""The training step: the counterpart of ``make_train_step`` in
``repro/launch/steps.py:52-84``.

The model owns its parameters, so the step takes and returns the optimizer
state alone and updates the parameters in place (``optim.adamw_update``).
In place, a step cannot be undone once its update has begun, so the step
marks that boundary for ``runtime.FaultTolerantRunner``: the update comes
last, and a failure inside it is raised as ``UpdateStartedError``, which
the runner does not retry; a failure before it (the forward, the backward,
the ``before_update`` hook) leaves the parameters and the AdamW state as
they were, and the runner may run the step again.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import Model
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.runtime.fault_tolerance import UpdateStartedError


def make_train_step(model: Model, opt_cfg: Optional[AdamWConfig] = None):
    """``train_step(opt_state, batch, before_update=None) -> (opt_state,
    metrics)``: loss and gradients by autograd, ``before_update()`` if given
    (fault injection, before anything is written), then one AdamW update,
    which a failure inside raises as ``UpdateStartedError``.  With
    ``model.opts.microbatches = k > 1`` the batch is cut into k equal parts
    along its first axis, each part's gradients are accumulated in f32, and
    the loss and the gradients are divided by k, as the JAX step does.
    ``metrics`` holds device scalars: ``loss``, ``grad_norm``, ``lr``."""
    opt_cfg = opt_cfg or AdamWConfig()
    n_micro = max(model.opts.microbatches, 1)
    params = dict(model.named_parameters())

    def grads_of(batch):
        for p in params.values():
            p.grad = None
        loss = model.loss(batch)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in params.items()}

    def train_step(opt_state, batch, before_update: Optional[Callable[[], None]] = None):
        if n_micro == 1:
            loss, grads = grads_of(batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % n_micro:
                raise ValueError(f"batch of {b} rows does not split into "
                                 f"{n_micro} microbatches")
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for n, p in params.items()}
            for part in zip(*(x.chunk(n_micro) for x in batch.values())):
                l, g = grads_of(dict(zip(batch, part)))
                loss += l
                for n, acc in grads.items():
                    acc += g[n].float()
            loss = loss / n_micro
            grads = {n: g / n_micro for n, g in grads.items()}
        if before_update is not None:
            before_update()
        try:
            _, opt_state, metrics = adamw_update(params, grads, opt_state, opt_cfg)
        except Exception as e:
            raise UpdateStartedError("the AdamW update failed after it began") from e
        for p in params.values():
            p.grad = None
        metrics["loss"] = loss
        return opt_state, metrics

    return train_step
