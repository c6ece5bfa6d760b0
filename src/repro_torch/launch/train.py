"""The trainer: the counterpart of ``repro/launch/train.py``.

config -> model (seeded init) -> synthetic data -> AdamW steps under a
fault-tolerant runner, every matrix product on K2 (forward and backward;
an MoE layer's expert products on its batched launches, both ways), every
attention forward on K1 and every attention backward on K3.  With
``ckpt_dir`` the run resumes from the latest checkpoint there, saves every
``save_every`` steps in the background and once after the last step, in
the JAX package's format (``repro_torch.checkpoint``): a JAX run can resume
from the port's checkpoints and the port from JAX's.  The run takes a mesh
as JAX's does (default: the ``(1, 1)`` mesh of ``device``); the PWS planner
places the parameters, the AdamW state and each batch
(``build_training``), and the manifest records the mesh's shape.  On a mesh
of more than one rank the dense family trains sharded: FSDP over ``data``
and tensor parallelism over ``model`` for the weights and the AdamW state,
each data rank its rows of the batch, the FSDP leaves' gradients
reduce-scattered and the replicated leaves' all-reduced over the axes
their work was split over; a checkpoint is written whole by rank 0.  Any
other family raises naming ``ROADMAP.md``.  Under ``torchrun`` the CLI
starts the group from the environment (``launch/mesh.py``).  The data pipeline's modality inputs (the
encoder-decoder's ``audio_frames``, the VLM's ``image_embeds``, f32) go to
the device with the tokens; the model casts them to its activation dtype.  The measured autotune's mode
(``RunOptions.autotune``, else ``REPRO_AUTOTUNE``, else ``replay``) is
pinned process-wide at start and the device's tuned table logged, as in
JAX.

    python -m repro_torch.launch.train --arch qwen3-1.7b --steps 3
    python -m repro_torch.launch.train --arch olmoe-1b-7b --reduced --device cpu --steps 2
    python -m repro_torch.launch.train --arch recurrentgemma-2b --reduced --device cpu --steps 2
    python -m repro_torch.launch.train --arch seamless-m4t-large-v2 --reduced --device cpu --steps 2
    python -m repro_torch.launch.train --arch llama-3.2-vision-90b --reduced --device cpu --steps 2
    python -m repro_torch.launch.train --reduced --device cpu --steps 4 \\
        --ckpt-dir /tmp/run --save-every 2

Run the last one again with ``--steps 6`` and it resumes at step 4.
``--impl`` installs an execution policy (the JAX grammar,
``op=backend[:knob=value][,...]``).
"""
from __future__ import annotations

import argparse
import logging
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core import planner, sharding_hints
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.kernels import autotune, policy
from repro_torch.launch.mesh import (axis_sizes, init_from_env, is_sharded, make_debug_mesh,
                                     mesh_device, mesh_for)
from repro_torch.launch.serve import install_impl
from repro_torch.launch.steps import abstract_opt_state, make_train_step
from repro_torch.models import RunOptions, build_model, check_sharded
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.fault_tolerance import FaultTolerantRunner

log = logging.getLogger("repro_torch.train")


def build_training(cfg, mesh, opts: RunOptions, opt_cfg: AdamWConfig, example: dict):
    """JAX's ``build_training``: returns ``(train_step, init_state,
    shardings)``.  The model is built on the mesh's device (``train_step.model``);
    ``shardings`` are the plans of its parameters, its AdamW state and
    ``example``'s batch (``plan_params`` / ``plan_opt_state`` /
    ``plan_batch``, as ``NamedSharding``s).  ``init_state(generator)``
    draws the parameters and the AdamW state and places both by the plan;
    it returns ``(params, opt_state)``.  On a mesh of more than one rank
    each rank holds its blocks (the model is built without memory and
    ``place`` allocates them) and ``train_step`` runs under the sharding
    rules, with ``example``'s rows as the global batch, which must divide
    the data axis; a family not yet sharded raises
    ``NotImplementedError``."""
    dev = mesh_device(mesh, "training")
    check_sharded(cfg, mesh)
    sharded = is_sharded(mesh)
    model = build_model(cfg, opts, device="meta" if sharded else dev)
    model.device = dev
    params = dict(model.named_parameters())
    p_spec = planner.plan_params(params, mesh)
    o_spec = planner.plan_opt_state(abstract_opt_state(params), mesh)
    b_spec = planner.plan_batch({k: torch.from_numpy(v) for k, v in example.items()}, mesh)
    rows = next(iter(example.values())).shape[0]
    if sharded:
        if planner.row_block(mesh, rows)[2] is None:
            raise ValueError(f"training on {axis_sizes(mesh)}: a batch of {rows} rows "
                             "does not divide the data axis")
        planner.place(params, p_spec, mesh)
    step = make_train_step(model, opt_cfg)

    def train_step(opt_state, batch, before_update=None):
        with sharding_hints.axis_rules(sharding_hints.execution_rules(mesh), mesh,
                                       sharding_hints.extents(cfg, rows)):
            return step(opt_state, batch, before_update)

    train_step.model = model

    def init_state(generator: torch.Generator):
        model.init(generator)
        placed = planner.place(params, p_spec, mesh)
        if any(placed[n] is not p for n, p in params.items()):
            raise RuntimeError("a parameter left the model's device")
        return params, planner.place(adamw_init(params), o_spec, mesh)

    shardings = tuple(planner.named(s, mesh) for s in (p_spec, o_spec, b_spec))
    return train_step, init_state, shardings


def train(cfg, *, steps: int, data_cfg: DataConfig,
          opts: RunOptions = RunOptions(), opt_cfg: AdamWConfig = AdamWConfig(),
          mesh=None, device=None, log_every: int = 10, ckpt_dir: Optional[str] = None,
          save_every: int = 0, keep: int = 3,
          before_update: Optional[Callable[[int], None]] = None) -> dict:
    """Train ``cfg`` from a seeded init (``data_cfg.seed``) up to step
    ``steps`` on ``mesh`` (default: the ``(1, 1)`` mesh of ``device``, CUDA
    unless told otherwise; raises without it).  Parameters, AdamW state and
    each batch are placed by the planner's plans (``build_training``): on a
    mesh of more than one rank, each rank's blocks (the dense family; any
    other raises ``NotImplementedError``).

    Each step runs under ``runtime.FaultTolerantRunner``: a failure before
    the step's update is retried up to twice, one after it raises (the JAX
    trainer retries only when it checkpoints; here a retry needs no
    checkpoint, since it reruns the step from the state in memory).  With
    ``ckpt_dir`` (JAX ``train.py:90-126``) the run starts
    from the latest checkpoint there, if any, saves every ``save_every``
    steps (default: at the last) keeping ``keep`` of them, and saves the
    final state; each manifest's ``mesh_shape`` is the mesh's
    ``{axis: size}``, as JAX writes it.  ``before_update(step)``, if given,
    is called in each attempt after the gradients and before the update
    (fault injection).

    Returns the model, the optimizer state, the mesh, ``start`` (the first
    step run: 0, or the step after the restored checkpoint), per-step
    ``losses``, ``grad_norms`` and ``step_s`` (host wall time of each step
    run, ended by reading its loss on the host), ``retries``, ``stragglers``
    and ``wall_s``."""
    mesh = mesh_for(mesh, device, "training")
    dev = mesh_device(mesh, "training")
    # replay the device's tuned plans from the first step (a cold table is a
    # no-op); RunOptions.autotune / REPRO_AUTOTUNE select off/replay/search
    autotune.startup(opts.autotune, dev)
    prov = autotune.provenance(dev)
    log.info("policy %s | autotune table %s (%d tuned plan(s), %s)",
             policy.current().describe(), prov["table"], prov["tuned_plans"],
             "present" if prov["table_exists"] else "absent")
    ds = SyntheticLMDataset(data_cfg, cfg)
    train_step, init_state, (_, _, b_sh) = build_training(
        cfg, mesh, opts, opt_cfg, ds.batch_at(0))
    model = train_step.model
    params, opt_state = init_state(torch.Generator(device=dev).manual_seed(data_cfg.seed))
    b_spec = {k: sh.spec for k, sh in b_sh.items()}
    mesh_shape = axis_sizes(mesh)

    mgr = CheckpointManager(ckpt_dir, keep=keep) if ckpt_dir else None
    runner = FaultTolerantRunner(mgr, save_every=save_every or steps, mesh_shape=mesh_shape,
                                 lockstep=is_sharded(mesh))
    _, start = runner.restore_or({"params": params, "opt_state": opt_state})

    losses, grad_norms, step_s = [], [], []
    t0 = time.perf_counter()
    for step in range(start, steps):
        t = time.perf_counter()
        batch = planner.place({k: torch.from_numpy(v) for k, v in ds.batch_at(step).items()},
                              b_spec, mesh)
        hook = None if before_update is None else (lambda step=step: before_update(step))
        out = {}

        def do_step():
            out["opt_state"], out["metrics"] = train_step(opt_state, batch, hook)
            return {"params": params, "opt_state": out["opt_state"]}

        runner.run_step(step, do_step)
        opt_state, metrics = out["opt_state"], out["metrics"]
        losses.append(float(metrics["loss"]))  # waits for the step
        step_s.append(time.perf_counter() - t)
        grad_norms.append(float(metrics["grad_norm"]))
        if log_every and step % log_every == 0:
            log.info("step %d loss %.4f (%.2fs)", step, losses[-1], time.perf_counter() - t0)
    if mgr is not None:
        mgr.save_async(steps - 1, {"params": params, "opt_state": opt_state}, mesh_shape)
        mgr.wait()
    return {"model": model, "opt_state": opt_state, "mesh": mesh, "start": start,
            "losses": losses, "grad_norms": grad_norms, "step_s": step_s,
            "retries": runner.retries, "stragglers": runner.monitor.flagged,
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
    ap.add_argument("--ckpt-dir", default=None,
                    help="resume from the latest checkpoint here and save into it")
    ap.add_argument("--save-every", type=int, default=0,
                    help="steps between checkpoints (default: the last step only)")
    ap.add_argument("--impl", default="",
                    help="execution-policy impl map, op=backend[:knob=value][,...] "
                         "('*' wildcard; a bare backend means '*=backend')")
    args = ap.parse_args(argv)
    install_impl(args.impl)

    cfg = get_smoke_config(args.arch) if args.reduced else get_config(args.arch)
    init_from_env(args.device)
    mesh = make_debug_mesh(tp=2, device=args.device)
    out = train(cfg, steps=args.steps,
                data_cfg=DataConfig(global_batch=args.batch, seq_len=args.seq),
                mesh=mesh, ckpt_dir=args.ckpt_dir, save_every=args.save_every)
    if not out["losses"]:
        print(f"nothing to run: the checkpoint is at step {out['start'] - 1} of {args.steps}")
        return
    print(f"steps {out['start']}-{args.steps - 1}: final loss {out['losses'][-1]:.4f} "
          f"(first {out['losses'][0]:.4f}) in {out['wall_s']:.1f}s on {out['model'].device}, "
          f"mesh {axis_sizes(out['mesh'])}")


if __name__ == "__main__":
    main()
