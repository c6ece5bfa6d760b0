"""What each rank of ``tests/test_torch_sharded.py``'s four gloo ranks runs:
every sharded case once, on the ``qwen3-1.7b`` smoke config at f32, its
results handed back to the test through ``repro_torch.launch.mesh.spawn``.

This module imports ``torch`` and the port only (no JAX), so the spawned
ranks start quickly; the JAX references live in the test module.
"""
from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config, reduced
from repro_torch.core import collectives, planner
from repro_torch.data import DataConfig
from repro_torch.kernels import policy
from repro_torch.launch.engine import Engine
from repro_torch.launch.mesh import axis_sizes, make_debug_mesh
from repro_torch.launch.router import Router
from repro_torch.launch.serve import Request, Server
from repro_torch.launch.train import train
from repro_torch.models import RunOptions, build_model, common
from repro_torch.optim import adamw_init
from repro_torch.runtime import elastic
from repro_torch.runtime.fault_tolerance import FaultInjector

ARCH = "qwen3-1.7b"
MAX_LEN = 64
SLOTS = 4  # divides the data axis: each data rank owns two slots
CHUNK = 8
INT8_CHUNK = 24  # at least the longest prompt, as the int8 parity needs
STEPS = 3
DATA = DataConfig(global_batch=2, seq_len=16)
NEVER = 10 ** 9
FAULTS = "decode@3=raise,slot@1=nan_logits"
INT8 = dict(impl={"attention": "pallas"}, variants={"attention": {"kv_dtype": "int8"}})
# the families and configs this slice does not shard, each with its reason
UNSHARDED = ("olmoe-1b-7b", "qwen3-moe-30b-a3b", "recurrentgemma-2b", "mamba2-370m",
             "seamless-m4t-large-v2", "llama-3.2-vision-90b", "gemma3-1b")


def cfg_f32(arch: str = ARCH):
    return reduced(get_smoke_config(arch), dtype="float32")


def prompts(vocab: int) -> list:
    """The server's wave: four ragged prompts (one per slot)."""
    rng = np.random.default_rng(7)
    return [rng.integers(3, vocab, int(n)).astype(np.int32) for n in (5, 11, 8, 3)]


def workload(n: int, make, *, seed: int = 0, max_prompt: int = 20, max_new: int = 8,
             vocab: int = 256) -> list:
    """``tests/test_engine.py``'s mixed workload: ragged prompts, skewed
    generation budgets; ``make`` builds the port's or the JAX Request."""
    rng = np.random.default_rng(seed)
    return [make(i, rng.integers(3, vocab, int(rng.integers(4, max_prompt))).astype(np.int32),
                 max_new=int(rng.integers(2, max_new + 1)))
            for i in range(n)]


def _engine_tokens(engine, n: int = 6) -> list:
    reqs = workload(n, Request)
    engine.run(reqs)
    return [r.out for r in reqs]


def _whole_state(params: dict, opt_state: dict) -> dict:
    """The train state gathered whole (every rank of the mesh calls it)."""
    return {"params": planner.gather(dict(params)),
            "opt_state": {k: planner.gather(v) for k, v in opt_state.items()}}


def _equal_states(a: dict, b: dict) -> bool:
    """Two whole train states hold the same bits, leaf by leaf."""
    return all(torch.equal(a["params"][n], b["params"][n]) for n in b["params"]) and all(
        torch.equal(a["opt_state"][k][n], b["opt_state"][k][n])
        for k in ("master", "m", "v") for n in b["params"]) and int(
        a["opt_state"]["step"]) == int(b["opt_state"]["step"])


def row_parallel_operands():
    """A bf16 product ``x (24, 256) @ w (256, 96)`` (seeded), the shapes of
    the row-parallel case."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((24, 256), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((256, 96), dtype=np.float32) / 16)
    return x.to(torch.bfloat16), w.to(torch.bfloat16)


def _row_parallel(mesh) -> torch.Tensor:
    """``common.project`` over a bf16 ``w`` whose rows are split over
    ``model``, each rank's ``x`` its columns of the contraction."""
    x, w = row_parallel_operands()
    block = planner.place({"w": w}, {"w": planner.P("model", None)}, mesh)["w"]
    lo = planner.placement(block).offset(0)
    return common.project(x[:, lo:lo + block.shape[0]], block)


def run(params: dict, jax_ckpt: str, work: str) -> dict:
    """Every case on the ``(2, 2)`` mesh of the four ranks, then the
    restores onto ``(1, 2)`` (ranks 0-1) and one device (rank 0)."""
    import torch.distributed as dist

    rank = dist.get_rank()
    cfg = cfg_f32()
    mesh = make_debug_mesh(4, tp=2, device="cpu")
    out = {"mesh": axis_sizes(mesh), "row_parallel": _row_parallel(mesh)}

    server = Server(cfg, mesh=mesh, device="cpu", params=params, max_len=MAX_LEN)
    reqs = [Request(i, p, max_new=6) for i, p in enumerate(prompts(cfg.vocab_size))]
    collectives.reset_counts()
    res = server.run_batch(reqs)
    out["server"] = [r.out for r in reqs]
    out["server_finite"] = res["logits_finite"]
    out["decode_collectives"] = collectives.counts()
    logits, _ = server.prefill(torch.from_numpy(np.stack([prompts(cfg.vocab_size)[1]] * 2)))
    out["prefill_logits"] = logits

    fused = Server(cfg, mesh=mesh, device="cpu", params=params, max_len=MAX_LEN,
                   opts=RunOptions(fused_qkv=True))
    reqs = [Request(i, p, max_new=6) for i, p in enumerate(prompts(cfg.vocab_size))]
    fused.run_batch(reqs)
    out["server_fused"] = [r.out for r in reqs]

    kw = dict(mesh=mesh, device="cpu", params=params, max_batch=SLOTS, max_len=MAX_LEN,
              degrade_after=NEVER)
    out["engine"] = _engine_tokens(Engine(cfg, chunk=CHUNK, **kw))
    faulted = Engine(cfg, chunk=CHUNK, injector=FaultInjector(FAULTS), snapshot_every=2, **kw)
    out["engine_faulted"] = _engine_tokens(faulted)
    out["engine_faulted_stats"] = faulted.stats()["faults"]
    with policy.apply(**INT8):
        out["engine_int8"] = _engine_tokens(Engine(cfg, chunk=INT8_CHUNK, **kw), n=4)

    # three training steps: resumed from JAX's own step-0 checkpoint
    port = Path(work) / "port"
    if rank == 0:
        shutil.copytree(jax_ckpt, port)
    dist.barrier()
    trained = train(cfg, steps=STEPS, data_cfg=DATA, mesh=mesh, device="cpu", log_every=0,
                    ckpt_dir=str(port), save_every=100)
    out["start"], out["losses"] = trained["start"], trained["losses"]
    model = trained["model"]
    whole = _whole_state(dict(model.named_parameters()), trained["opt_state"])
    if rank == 0:
        out["trained"] = whole

    like_params = build_model(cfg, device="meta").state_dict()
    like = {"params": like_params, "opt_state": adamw_init(like_params)}
    # onto (1, 2): ranks 0 and 1; every rank builds the mesh
    mesh12 = make_debug_mesh(2, tp=2, device="cpu")
    if mesh12.get_coordinate() is not None:
        step, state = elastic.elastic_restore(CheckpointManager(port), like, mesh12)
        got = _whole_state(state["params"], state["opt_state"])
        out["restored_12"] = _equal_states(got, whole)
        out["restored_12_step"] = step
        engine = Engine.restart(cfg, port, mesh=mesh12, max_batch=2, max_len=MAX_LEN,
                                chunk=CHUNK, degrade_after=NEVER)
        out["restart_12"] = _engine_tokens(engine, n=2)
    mesh1 = make_debug_mesh(1, tp=1, device="cpu")
    if mesh1.get_coordinate() is not None:
        step, state = elastic.elastic_restore(CheckpointManager(port), like, mesh1)
        out["restored_1"] = _equal_states(state, whole)

    out["refused"] = {}
    for arch in UNSHARDED:
        try:
            Server(get_smoke_config(arch), mesh=mesh, device="cpu", max_len=MAX_LEN)
        except NotImplementedError as e:
            out["refused"][arch] = str(e)
    try:
        Router(cfg, mesh=mesh, n_replicas=2, params=params, max_batch=2, max_len=MAX_LEN)
    except NotImplementedError as e:
        out["refused"]["router"] = str(e)
    dist.barrier()
    return out
