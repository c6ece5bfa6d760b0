"""Batched lockstep serving: the counterpart of ``repro/launch/serve.py``.

The server packs up to ``max_batch`` requests, left-pads their prompts with
token 0 to a shared length (the pad is attended, not masked, exactly as in
the JAX server, so both give the same tokens), prefills them, and decodes
greedily in lockstep, one shared position per step, with per-row stop: a
row that reaches ``max_new`` or ``eos_id`` stops appending, and the wave
ends when every row has stopped.

Every matrix product and attention call runs on the port's CUDA kernels;
with ``device="cpu"`` they run on their plain PyTorch versions.  The server
takes a mesh where JAX's does (``launch/mesh.py``; the CLI's is
``make_debug_mesh`` over every rank of the process group) and places the
weights by the planner's plan.  On a mesh of more than one rank the dense
family runs sharded: each rank holds its blocks of the weights, each data
rank prefills and decodes its rows of the wave (every row where the wave
does not divide the data axis), and the sampled tokens are gathered so that
every rank's host holds the same output; another family raises naming
``ROADMAP.md``.  Under ``torchrun`` the CLI starts the group from the
environment (NCCL with a card a rank; ranks that share a card: gloo)::

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --device cuda

The measured autotune replays the device's tuned
table by default (``REPRO_AUTOTUNE`` = ``off`` | ``replay`` | ``search``,
tables under ``REPRO_TUNE_DIR``; ``kernels/autotune.py``).  ``--impl`` installs the execution policy
(``repro_torch.kernels.policy``) with the JAX launcher's grammar,
``op=backend[:knob=value][,...]``; the port acts on the attention knob
``kv_dtype=int8``, which serves from an int8 KV cache read by K1q:

    python -m repro_torch.launch.serve --arch qwen3-1.7b --device cuda
    python -m repro_torch.launch.serve --arch qwen2.5-14b --reduced --device cpu
    python -m repro_torch.launch.serve --arch gemma3-1b --reduced --device cpu
    python -m repro_torch.launch.serve --arch recurrentgemma-2b --reduced --device cpu \
        --windowed-decode-cache
    python -m repro_torch.launch.serve --arch mamba2-370m --reduced --device cpu
    python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 --reduced --device cpu
    python -m repro_torch.launch.serve --arch llama-3.2-vision-90b --reduced --device cpu
    python -m repro_torch.launch.serve --reduced --device cpu \
        --impl 'attention=pallas:kv_dtype=int8'

:meth:`Server.prefill` and :meth:`Server.decode` are the per-call entry
points of the lockstep path; ``run_batch`` drives them, and the engine's
``check_lockstep_parity`` runs each request alone through them.  A modality
family (the encoder-decoder's ``audio_frames``, the VLM's ``image_embeds``)
takes its inputs beside the tokens; ``run_batch`` draws them as the JAX
server does, from ``np.random.default_rng(0)`` in f32, so the two servers'
tokens compare.
"""
from __future__ import annotations

import argparse
import contextlib
import logging
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core import collectives, planner, sharding_hints
from repro_torch.kernels import autotune, policy
from repro_torch.kernels import planner as kernel_planner
from repro_torch.launch.mesh import (axis_sizes, init_from_env, is_sharded, make_debug_mesh,
                                     mesh_device, mesh_for)
from repro_torch.models import RunOptions, build_model, check_sharded
from repro_torch.models import common

log = logging.getLogger("repro_torch.serve")


@dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (plen,) int32
    max_new: int = 16
    out: list = field(default_factory=list)
    # modality-frontend inputs keyed by the model's batch_extras_specs()
    # ("image_embeds" / "audio_frames"), one row each, no batch axis
    extras: Optional[dict] = None


class Server:
    def __init__(self, cfg, *, mesh=None, device=None, params: Optional[dict] = None,
                 max_batch: int = 8, max_len: int = 256,
                 opts: Optional[RunOptions] = None):
        """``mesh``: where JAX's server takes its mesh (default: the ``(1, 1)``
        mesh of ``device``, CUDA unless told otherwise); the parameters are
        placed by ``plan_params`` on it: on a mesh of more than one rank
        each rank holds its blocks (the dense family; any other raises
        ``NotImplementedError`` naming ``ROADMAP.md``).  ``params``: a
        state dict (``repro_torch.checkpoint``; whole tensors, or blocks
        placed on this mesh) to load; without one the weights are drawn by
        the model's ``init`` from a ``torch.Generator`` seeded with 0, as
        the JAX server uses key 0 (on a sharded mesh each rank draws every
        whole tensor and keeps its block: the same weights).
        ``opts``: the model's ``RunOptions`` (``windowed_decode_cache``
        serves the hybrid's decode from its ring cache), resolved by the
        planner as JAX's server resolves them (``autotune=None``:
        ``REPRO_AUTOTUNE``, else ``replay``); the resolved autotune mode is
        pinned process-wide (``autotune.startup``, as in JAX; on a sharded
        mesh only rank 0 searches) and the device's tuned-table provenance
        logged."""
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.opts = kernel_planner.resolve_run_options(
            opts or RunOptions(), head_dim=cfg.head_dim_, dtype=cfg.activation_dtype)
        self.mesh = mesh_for(mesh, device, "serving")
        device = mesh_device(self.mesh, "serving")
        check_sharded(cfg, self.mesh)
        self.sharded = is_sharded(self.mesh)
        autotune.startup(self.opts.autotune, device)
        prov = autotune.provenance(device)
        log.info("policy %s | autotune table %s (%d tuned plan(s), %s)",
                 policy.current().describe(), prov["table"], prov["tuned_plans"],
                 "present" if prov["table_exists"] else "absent")
        # sharded: built without memory, each block allocated by ``place``
        self.model = build_model(cfg, self.opts, device="meta" if self.sharded else device)
        self.model.device = self.device = device
        weights = dict(self.model.named_parameters())
        if self.sharded:
            planner.place(weights, planner.plan_params(weights, self.mesh), self.mesh)
        if params is None:
            self.model.init(torch.Generator(device=self.device).manual_seed(0))
        elif self.sharded:
            planner.assign(weights, params)
        else:
            self.model.load_state_dict(params)
        if not self.sharded:
            planner.place(weights, planner.plan_params(weights, self.mesh), self.mesh)

    def bound(self, b: int):
        """The sharding rules the model's calls on a ``b``-row batch run
        under on a sharded mesh (``sharding_hints.execution_rules``, with
        the config's extents), which its ``constrain`` sites and the loss
        read; none on one device, where every ``constrain`` returns at
        once."""
        if not self.sharded:
            return contextlib.nullcontext()
        return sharding_hints.axis_rules(sharding_hints.execution_rules(self.mesh), self.mesh,
                                         sharding_hints.extents(self.cfg, b))

    def rows(self, b: int) -> tuple[int, int, object]:
        """This rank's rows of a ``b``-row batch and the data axes they are
        split over (``planner.row_block``; ``(0, b, None)`` on one device)."""
        return planner.row_block(self.mesh, b)

    def gather_rows(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Every data rank's rows of ``x`` (``x`` itself where ``axes`` is
        None)."""
        return x if axes is None else collectives.all_gather_rows(x, self.mesh, axes)

    def greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """This rank's rows' greedy tokens (int32) from the model's logits:
        the first maximum, over a split vocabulary the lowest global index
        (``common.greedy``)."""
        if not self.sharded:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return common.greedy(logits, self.model.output_table())

    def _local(self, tokens: torch.Tensor, extras: Optional[dict]):
        lo, hi, axes = self.rows(tokens.shape[0])
        if axes is None:
            return tokens, extras, axes
        return (tokens[lo:hi], {k: v[lo:hi] for k, v in (extras or {}).items()} or None,
                axes)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, extras: Optional[dict] = None):
        """Prefill ``tokens`` (b, s) into a fresh ``max_len`` cache, with the
        modality inputs ``extras`` (each with b rows) for a family that
        takes them; returns (last-token logits (b, V) f32, cache).  On a
        sharded mesh the cache holds this rank's rows and KV heads, and the
        logits are gathered whole."""
        local, extras, axes = self._local(tokens, extras)
        with self.bound(tokens.shape[0]):
            logits, cache = self.model.prefill({"tokens": local, **(extras or {})},
                                               self.max_len)
        if self.sharded:
            logits = self.gather_rows(common.whole_vocab(logits, self.model.output_table()),
                                      axes)
        return logits, cache

    def draw_extras(self, b: int) -> dict:
        """The modality inputs of a ``b``-row wave at the shapes of the
        model's ``batch_extras_specs(b, max_len)``, drawn as the JAX server
        draws them (``serve.py:137-144``): ``np.random.default_rng(0)``,
        standard normal in f32; none for a text-only family."""
        rng = np.random.default_rng(0)
        return {k: torch.from_numpy(rng.standard_normal(sp.shape, dtype=np.float32)
                                    ).to(self.device)
                for k, sp in self.model.batch_extras_specs(b, self.max_len).items()}

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, pos: torch.Tensor, cache):
        """One greedy decode step: tokens (b, 1) at ``pos`` (an int32 device
        scalar or (b,)); returns (next tokens (b,) int32, cache).  The
        argmax takes the first maximum, as ``jnp.argmax``.  On a sharded
        mesh ``cache`` is this rank's (from :meth:`prefill`) and the tokens
        come back gathered."""
        b = tokens.shape[0]
        lo, hi, axes = self.rows(b)
        if axes is not None:
            tokens = tokens[lo:hi]
            pos = pos[lo:hi] if pos.dim() else pos
        with self.bound(b):
            logits, cache = self.model.decode_step(tokens, pos, cache)
        return self.gather_rows(self.greedy(logits), axes), cache

    @torch.no_grad()
    def run_batch(self, requests: list[Request],
                  eos_id: Optional[int] = None) -> dict:
        """Prefill + greedy decode a batch of requests in lockstep with
        per-row stop.  A modality family's inputs come from
        :meth:`draw_extras`, as in JAX (the requests' own ``extras`` are the
        engine's).  Returns per-request completion counts, the wave's
        totals, the prefill and decode wall times, and whether every logit
        the wave produced was finite.  On a sharded mesh each data rank
        runs its rows and every rank gets every row's tokens."""
        if len(requests) > self.max_batch:
            raise ValueError(f"{len(requests)} requests > max_batch={self.max_batch}")
        b = len(requests)
        plen = max(len(r.prompt) for r in requests)
        toks = np.zeros((b, plen), np.int32)
        for i, r in enumerate(requests):
            toks[i, plen - len(r.prompt):] = r.prompt  # left-pad
        tokens = torch.from_numpy(toks).to(self.device)
        extras = self.draw_extras(b)
        local, extras, axes = self._local(tokens, extras)

        t0 = time.perf_counter()
        with self.bound(b):
            logits, cache = self.model.prefill({"tokens": local, **(extras or {})},
                                               self.max_len)
        nxt = self.greedy(logits)  # first maximum, as jnp
        finite = torch.isfinite(logits).all()
        host = self.gather_rows(nxt, axes).tolist()  # waits for the prefill
        t_prefill = time.perf_counter() - t0
        pos = torch.full((), plen, dtype=torch.int32, device=self.device)
        done = [False] * b
        steps = 0
        for _ in range(max(r.max_new for r in requests)):
            for i, r in enumerate(requests):
                if done[i]:
                    continue  # per-row stop: finished rows stop appending
                r.out.append(host[i])
                if len(r.out) >= r.max_new or (eos_id is not None and host[i] == eos_id):
                    done[i] = True
            if all(done):
                break  # the wave drained early: skip the dead steps
            with self.bound(b):
                logits, cache = self.model.decode_step(nxt[:, None], pos, cache)
            nxt = self.greedy(logits)
            finite &= torch.isfinite(logits).all()
            pos += 1
            host = self.gather_rows(nxt, axes).tolist()  # the host needs them for per-row stop
            steps += 1
        if self.sharded:  # finite on every rank
            finite = collectives.all_sum((~finite).float(), self.mesh,
                                         tuple(self.mesh.mesh_dim_names)) == 0
        wall = time.perf_counter() - t0
        n_tokens = sum(len(r.out) for r in requests)
        return {"wall_s": wall, "tokens": n_tokens,
                "tok_per_s": n_tokens / max(wall, 1e-9),
                "prefill_s": t_prefill, "decode_s": wall - t_prefill,
                "decode_steps": steps, "logits_finite": bool(finite),
                "completed": {r.uid: len(r.out) for r in requests}}


def install_impl(spec: str) -> None:
    """Install the process policy named by an ``--impl`` spec (no-op when
    empty), over the ``REPRO_IMPL`` ambient, as the JAX launchers do."""
    if spec:
        impl, variants = policy.parse_impl_spec(spec)
        policy.install(policy.ambient().with_(impl=impl, variants=variants))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="serve the arch's smoke config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--impl", default="",
                    help="execution-policy impl map, op=backend[:knob=value][,...] "
                         "(see the module docstring)")
    ap.add_argument("--windowed-decode-cache", action="store_true",
                    help="decode a windowed arch (the hybrid) from a ring cache of "
                         "window slots")
    args = ap.parse_args(argv)
    install_impl(args.impl)

    cfg = get_smoke_config(args.arch) if args.reduced else get_config(args.arch)
    init_from_env(args.device)
    mesh = make_debug_mesh(tp=2, device=args.device)
    server = Server(cfg, mesh=mesh, max_batch=args.batch, max_len=128,
                    opts=RunOptions(windowed_decode_cache=args.windowed_decode_cache))
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(3, cfg.vocab_size, rng.integers(4, 20)).astype(np.int32),
                    max_new=args.max_new) for i in range(args.batch)]
    out = server.run_batch(reqs)
    print(f"served {out['tokens']} tokens in {out['wall_s']:.2f}s "
          f"({out['tok_per_s']:.1f} tok/s) on {server.device}, mesh {axis_sizes(mesh)}")
    for r in reqs[:2]:
        print(f"req {r.uid}: {r.out[:8]}...")


if __name__ == "__main__":
    main()
