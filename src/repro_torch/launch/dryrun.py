"""Dry run over the production meshes: the counterpart of
``repro/launch/dryrun.py``, host only, nothing allocated.

Each (arch x shape x mesh) cell plans its step on JAX's abstract
production mesh (``(16, 16)`` over ``("data", "model")``, or ``(2, 16,
16)`` with ``"pod"``) and traces it on ``meta`` tensors, where the
registry's kernel ops give their output shapes alone
(``kernels.registry``).  The record keeps JAX's keys; how each number is
derived:

* ``memory.argument_bytes``, ``output_bytes``, ``alias_bytes``: exactly
  from the plans, the bytes one device holds of each input (``plan_params``
  in ``--opts``' ``param_sharding`` mode, the AdamW state by
  ``plan_opt_state``, ``plan_batch``, ``plan_cache``) and output (a train
  step's params, AdamW state and metrics; a prefill's logits, batch-planned,
  and cache; a decode step's logits and cache); alias: what the step
  donates (a train step's params and AdamW state, a decode step's cache).
* ``memory.temp_bytes``: the peak of the bytes the step's own allocations
  hold at once in a trace on ``meta`` of one device's work: the per-device
  batch (the global batch over the data axes; a batch of one stays whole)
  on a per-device model, whose heads, kv heads, FFN width, experts and
  vocab are divided by the ``model`` axis where it divides them (tensor and
  expert parallelism; the rest full width), with the planner's
  microbatches and one MoE dispatch group.
* ``memory.peak_bytes_est``: argument + output + temp - alias, as JAX.
* ``hlo``: ``trace_analysis`` of the same trace: FLOPs, HBM bytes; no
  collective is traced, since the port has no sharded execution yet
  (``ROADMAP.md`` queue 1), so ``collective_bytes`` is 0 and
  ``roofline.collective_s`` is not modeled.
* ``roofline``: per-device quantities over one H100's peaks.

Compare ``peak_bytes_est`` with the card's 80 GB: ``_MICROBATCH_TABLE``
is JAX's, sized for its own devices, and says nothing of what fits a card.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parents[3]
OUT_DIR = REPO / "experiments" / "dryrun_torch"

# one H100 SXM (NVIDIA H100 Tensor Core GPU datasheet): dense bf16 tensor-core
# peak, HBM3 rate, and one direction of NVLink 4's 900 GB/s
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
CARD_BYTES = 80e9


def cell_id(arch: str, shape: str, mesh: str, tag: str = "") -> str:
    t = f"_{tag}" if tag else ""
    return f"{arch}_{shape}_{mesh}{t}"


# JAX's microbatch counts for its heavy cells (``repro/launch/dryrun.py``),
# kept so the planner's options equal JAX's; sized for JAX's own devices
_MICROBATCH_TABLE = {
    ("llama-3.2-vision-90b", "train_4k", "single"): 16,
    ("llama-3.2-vision-90b", "train_4k", "multi"): 8,  # = global_batch/dp
    ("qwen3-32b", "train_4k", "single"): 2,
    ("qwen3-32b", "train_4k", "multi"): 2,
}


def planner_defaults(cfg, shape, mesh) -> dict:
    """The planner's RunOptions for a cell (JAX's rule): microbatches from
    the table for the heavy cells, else enough to keep the per-device
    residual activation stack under ~6e9 bytes; one MoE dispatch group per
    data shard."""
    from repro_torch.launch.mesh import axis_sizes

    sizes = axis_sizes(mesh)
    dp = 1
    for a in ("pod", "data"):
        if a in sizes:
            dp *= sizes[a]
    tp = sizes.get("model", 1)
    mesh_kind = "multi" if "pod" in sizes else "single"
    out: dict = {}
    if cfg.n_experts:
        out["moe_groups"] = dp
    if shape.kind == "train":
        key = (cfg.name, shape.name, mesh_kind)
        if key in _MICROBATCH_TABLE:
            out["microbatches"] = _MICROBATCH_TABLE[key]
            return out
        layers = cfg.n_layers + (cfg.encoder_layers or 0)
        per_dev_tokens = max(shape.global_batch // dp, 1) * shape.seq_len / tp
        est = layers * per_dev_tokens * cfg.d_model * 2  # bf16 residual stack
        micro = 1
        while est / micro > 6e9 and micro < max(shape.global_batch // dp, 1):
            micro *= 2
        if micro > 1:
            out["microbatches"] = micro
    return out


def device_config(cfg, tp: int):
    """One device's share of ``cfg`` under ``tp``-way tensor and expert
    parallelism: heads, kv heads, FFN width, experts (and the experts a
    token takes) and vocab divided by ``tp`` where ``tp`` divides them;
    everything else whole."""
    def div(x):
        return x // tp if x and x % tp == 0 else x

    kw = dict(head_dim=cfg.head_dim_, n_heads=div(cfg.n_heads), d_ff=div(cfg.d_ff),
              vocab_size=div(cfg.vocab_size))
    if cfg.n_heads and cfg.n_kv_heads and cfg.n_heads % tp == 0:
        # a device's query heads share ceil(their count / the group size) kv heads
        group = cfg.n_heads // cfg.n_kv_heads
        kw["n_kv_heads"] = max(1, (cfg.n_heads // tp) // group)
    if cfg.n_experts and cfg.n_experts % tp == 0 and cfg.experts_per_token % tp == 0:
        kw["n_experts"] = cfg.n_experts // tp
        kw["experts_per_token"] = cfg.experts_per_token // tp
    return dataclasses.replace(cfg, **kw)


def _dp_tp(mesh) -> tuple[int, int]:
    from repro_torch.launch.mesh import axis_sizes

    sizes = axis_sizes(mesh)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    return dp, sizes.get("model", 1)


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, opts_kw: dict | None = None,
             trace: bool = True, tag: str = "", cfg=None, shape=None) -> dict:
    """One cell's record (see the module docstring); ``trace=False`` leaves
    out the trace (temp bytes, ``hlo``, ``roofline``).  ``cfg`` / ``shape``
    stand in for the arch's config and the shape's (a smoke-size cell)."""
    import torch

    from repro_torch.configs import SHAPES, ShapeConfig, get_config
    from repro_torch.launch import trace_analysis
    from repro_torch.launch.mesh import make_production_mesh, mesh_device_count
    from repro_torch.launch.steps import build_step_bundle
    from repro_torch.models import RunOptions

    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag,
        "kind": shape.kind, "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "status": "ok",
    }
    if shape_name == "long_500k" and not cfg.supports_long_context:
        rec["status"] = "SKIP(full-attention)"
        return rec

    t0 = time.perf_counter()
    opts_kw = dict(opts_kw or {})
    opts_kw.pop("axis_rules", None)  # the models carry no hint sites yet
    param_mode = opts_kw.pop("param_sharding", "fsdp")
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    opts_kw = {**planner_defaults(cfg, shape, mesh), **opts_kw}
    rec["opts"] = {**opts_kw, "param_sharding": param_mode}
    rec["n_devices"] = mesh_device_count(mesh)

    # the global step, planned: argument / output / alias bytes
    bundle = build_step_bundle(cfg, shape, RunOptions(autotune="off", **opts_kw))
    rec["memory"] = plan_bytes(bundle, shape, mesh, param_mode)
    del bundle

    if trace:
        dp, tp = _dp_tp(mesh)
        b_dev = shape.global_batch // dp if shape.global_batch % dp == 0 else \
            shape.global_batch
        micro = opts_kw.get("microbatches", 1)
        dev_opts = RunOptions(autotune="off", **{**opts_kw, "moe_groups": 1,
                                                 "microbatches": micro if b_dev % micro == 0
                                                 else 1})
        dev_shape = ShapeConfig(shape.name, shape.seq_len, b_dev, shape.kind)
        local = build_step_bundle(device_config(cfg, tp), dev_shape, dev_opts)
        grad = torch.enable_grad() if shape.kind == "train" else torch.no_grad()
        with grad:
            stats = trace_analysis.analyze(local.fn, *local.args, allocations=True)
        rec["memory"]["temp_bytes"] = stats.peak_alloc_bytes
        rec["hlo"] = stats.as_dict()
        rec["roofline"] = trace_analysis.roofline(stats, PEAK_FLOPS, HBM_BW, NVLINK_BW)
        rec["trace"] = {"per_device_batch": b_dev, "tp": tp,
                        "microbatches": dev_opts.microbatches,
                        "kernel_flops": stats.kernel_flops, "aten_flops": stats.aten_flops}
    m = rec["memory"]
    m["peak_bytes_est"] = (m["argument_bytes"] + m["output_bytes"]
                           + m.get("temp_bytes", 0) - m["alias_bytes"])
    m["fits_card"] = m["peak_bytes_est"] <= CARD_BYTES
    rec["seconds"] = time.perf_counter() - t0
    return rec


def plan_bytes(bundle, shape, mesh, param_mode: str = "fsdp") -> dict:
    """``argument_bytes``, ``output_bytes`` and ``alias_bytes`` of one device
    of ``mesh`` for the step ``bundle`` (``steps.build_step_bundle``), from
    the plans (see the module docstring)."""
    import torch

    from repro_torch.core import planner

    specs = []
    for arg, kind in zip(bundle.args, bundle.kinds):
        if kind == "params":
            specs.append(planner.plan_params(arg, mesh, mode=param_mode))
        elif kind == "opt":
            specs.append(planner.plan_opt_state(arg, mesh))
        elif kind == "batch":
            specs.append(planner.plan_batch(arg, mesh))
        elif kind == "cache":
            specs.append(planner.plan_cache(arg, mesh))
        else:
            specs.append(planner.P())
    arg_bytes = [planner.shard_bytes(a, s, mesh) for a, s in zip(bundle.args, specs)]
    logits = torch.empty((shape.global_batch, bundle.model.cfg.vocab_size),
                         dtype=torch.float32, device="meta")
    logit_bytes = planner.shard_bytes(logits, planner.plan_batch(logits, mesh), mesh)
    if bundle.name == "train_step":
        out_bytes = arg_bytes[0] + arg_bytes[1] + 3 * 4  # loss, grad_norm, lr
        alias = arg_bytes[0] + arg_bytes[1]
    elif bundle.name == "prefill_step":
        cache = bundle.model.init_cache(shape.global_batch, shape.seq_len)
        out_bytes = logit_bytes + planner.shard_bytes(cache, planner.plan_cache(cache, mesh),
                                                      mesh)
        alias = 0
    else:
        out_bytes = logit_bytes + arg_bytes[3]
        alias = arg_bytes[3]
    return {"argument_bytes": sum(arg_bytes), "output_bytes": out_bytes, "alias_bytes": alias}


def all_cells(mesh_kinds: list[str]) -> list[tuple[str, str, str]]:
    from repro_torch.configs import SHAPES, list_archs

    return [(arch, shape, mesh_kind) for mesh_kind in mesh_kinds
            for arch in list_archs() for shape in SHAPES]


def _run_jobs(cells, args, out_dir: Path) -> int:
    """Each cell in a process of its own, ``args.jobs`` at a time; returns
    the failures."""
    import subprocess

    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    pending, running, failures = list(cells), [], 0
    while pending or running:
        while pending and len(running) < args.jobs:
            arch, shape, mesh_kind = pending.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape, "--mesh", mesh_kind, "--out-dir", str(out_dir)]
            for flag in ("tag", "opts", "impl"):
                if getattr(args, flag):
                    cmd += [f"--{flag}", getattr(args, flag)]
            running.append(((arch, shape, mesh_kind), subprocess.Popen(
                cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        time.sleep(0.2)
        for item in [r for r in running if r[1].poll() is not None]:
            running.remove(item)
            (arch, shape, mesh_kind), proc = item
            text = proc.stdout.read()
            if proc.returncode:
                failures += 1
                rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "tag": args.tag,
                       "status": f"FAIL: {text[-2000:]}"}
                (out_dir / f"{cell_id(arch, shape, mesh_kind, args.tag)}.json").write_text(
                    json.dumps(rec, indent=1))
            print(next((ln for ln in text.splitlines() if ln.startswith("[")),
                       f"[FAIL] {arch} {shape} {mesh_kind}"), flush=True)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="", help="variant tag for perf experiments")
    ap.add_argument("--opts", default="", help="JSON RunOptions overrides")
    ap.add_argument("--impl", default="",
                    help="execution-policy impl map, op=backend[,op=backend] "
                         "('*' wildcard), exported as REPRO_IMPL")
    ap.add_argument("--out-dir", default=str(OUT_DIR))
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, one process each (default: one, in "
                         "this process)")
    args = ap.parse_args(argv)

    if args.impl:
        from repro_torch.kernels import policy

        policy.parse_impl_spec(args.impl)  # validate before any cell
        os.environ["REPRO_IMPL"] = args.impl
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    opts_kw = json.loads(args.opts) if args.opts else {}
    mesh_kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = all_cells(mesh_kinds)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, m) for m in mesh_kinds]

    t_all = time.perf_counter()
    if args.jobs > 1:
        failures = _run_jobs(cells, args, out_dir)
        print(f"done, {failures} failures / {len(cells)} cells in "
              f"{time.perf_counter() - t_all:.1f}s")
        return 1 if failures else 0
    failures = 0
    for arch, shape, mesh_kind in cells:
        t0 = time.perf_counter()
        try:
            rec = run_cell(arch, shape, mesh_kind, opts_kw=opts_kw, tag=args.tag)
        except Exception:  # noqa: BLE001 -- a failed cell is recorded, the rest run
            failures += 1
            rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "tag": args.tag,
                   "status": f"FAIL: {traceback.format_exc()[-2000:]}"}
        (out_dir / f"{cell_id(arch, shape, mesh_kind, args.tag)}.json").write_text(
            json.dumps(rec, indent=1))
        mem = rec.get("memory", {})
        gb = mem.get("peak_bytes_est", 0) / 1e9
        dom = rec.get("roofline", {}).get("dominant", "-")
        print(f"[{rec['status'][:20]:20s} {time.perf_counter() - t0:6.1f}s] {arch} {shape} "
              f"{mesh_kind}: {gb:.2f} GB a device, {dom}", flush=True)
        if not args.all:
            print(json.dumps(rec, indent=1))
    print(f"done, {failures} failures / {len(cells)} cells in "
          f"{time.perf_counter() - t_all:.1f}s")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
