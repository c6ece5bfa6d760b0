"""Step functions (train / prefill / decode) and their abstract inputs:
the counterpart of ``repro/launch/steps.py``.

:func:`build_step_bundle` builds a step on a model on the ``meta`` device
with ``meta`` stand-ins for every input (JAX: ``ShapeDtypeStruct``s), never
allocated: the dry run traces it (``launch/dryrun.py``), where each kernel
op gives its output shapes alone (``kernels.registry``).

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

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import Model, RunOptions, build_model
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
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


# ---------------------------------------------------------------------------
# abstract inputs and the step bundle (JAX ``steps.py:20-50, :87-125``)
# ---------------------------------------------------------------------------

@dataclass
class StepBundle:
    """A step function plus abstract inputs (``meta`` tensors), ready to
    trace.  ``fn(*args)`` runs the step; the port's model owns its
    parameters, so ``args[0]`` is the model's own parameter dict, which the
    step reads through the model.  ``kinds``: "params" | "opt" | "batch" |
    "cache" | "scalar" per arg."""

    name: str
    fn: Callable
    args: tuple
    kinds: tuple
    model: Model


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def abstract_params(model: Model) -> dict:
    """The model's parameters as ``meta`` tensors of their shapes and
    dtypes (JAX: ``jax.eval_shape`` of ``model.init``); a model built on
    ``meta`` gives its own."""
    return {n: p if p.device.type == "meta" else _meta(p.shape, p.dtype)
            for n, p in model.named_parameters()}


def abstract_opt_state(aparams: dict) -> dict:
    """The AdamW state of ``aparams`` on ``meta``."""
    return adamw_init({n: p if p.device.type == "meta" else _meta(p.shape, p.dtype)
                       for n, p in aparams.items()})


def abstract_batch(model: Model, shape: ShapeConfig, *, with_labels: bool) -> dict:
    """``tokens`` (and ``labels``) (b, s) int32 and the family's modality
    inputs (``batch_extras_specs``), on ``meta``."""
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((b, s), torch.int32)}
    if with_labels:
        batch["labels"] = _meta((b, s), torch.int32)
    batch.update({k: _meta(sp.shape, sp.dtype)
                  for k, sp in model.batch_extras_specs(b, s).items()})
    return batch


def abstract_cache(model: Model, shape: ShapeConfig):
    """The decode cache of ``shape`` (batch, positions) on ``meta``; the
    model must be built on ``meta``."""
    if model.device.type != "meta":
        raise ValueError(f"abstract_cache: a model on {model.device}; build it on 'meta'")
    return model.init_cache(shape.global_batch, shape.seq_len)


def make_prefill_step(model: Model, max_len: int):
    def prefill_step(params, batch):
        return model.prefill(batch, max_len)

    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, tokens, pos, cache):
        return model.decode_step(tokens, pos, cache)

    return decode_step


def build_step_bundle(cfg: ModelConfig, shape: ShapeConfig,
                      opts: Optional[RunOptions] = None,
                      opt_cfg: Optional[AdamWConfig] = None,
                      model: Optional[Model] = None) -> StepBundle:
    """The step of ``shape.kind`` for ``cfg`` on a model built on ``meta``
    (or ``model``, one already built there), with abstract inputs:
    ``train_step(params, opt_state, batch)``, ``prefill_step(params,
    batch)`` or ``serve_step(params, tokens, pos, cache)``, as JAX's
    bundle."""
    if model is None:
        model = build_model(cfg, opts, device="meta")
    aparams = abstract_params(model)
    if shape.kind == "train":
        step = make_train_step(model, opt_cfg)
        aopt = abstract_opt_state(aparams)
        abatch = abstract_batch(model, shape, with_labels=True)
        return StepBundle("train_step", lambda params, opt, batch: step(opt, batch),
                          (aparams, aopt, abatch), ("params", "opt", "batch"), model)
    if shape.kind == "prefill":
        abatch = abstract_batch(model, shape, with_labels=False)
        return StepBundle("prefill_step", make_prefill_step(model, shape.seq_len),
                          (aparams, abatch), ("params", "batch"), model)
    if shape.kind == "decode":
        tokens = _meta((shape.global_batch, 1), torch.int32)
        pos = _meta((), torch.int32)
        acache = abstract_cache(model, shape)
        return StepBundle("serve_step", make_decode_step(model),
                          (aparams, tokens, pos, acache),
                          ("params", "batch", "scalar", "cache"), model)
    raise ValueError(shape.kind)
