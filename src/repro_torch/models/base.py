"""Model API shared by the port's families: the counterpart of
``repro/models/base.py``.

A model is an ``nn.Module`` that owns its parameters, so the JAX methods'
``params`` argument goes away.  ``RunOptions`` has every field of the JAX
dataclass, with its names, order and defaults, so a JAX ``RunOptions``
carries across; its docstring says what each knob does in the port.
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import policy


@dataclass(frozen=True)
class RunOptions:
    """Execution options (JAX ``base.py:37-69``: the same fields, order and
    defaults).  What each does in the port:

    * ``remat``, ``ce_chunk``, ``microbatches``: the training path's.
    * ``moe_dispatch``, ``moe_groups``: the MoE layers'.
    * ``windowed_decode_cache``: the hybrid's ring cache for local layers.
    * ``attention_impl``, ``matmul_impl``: the backend of the model's
      ``attention`` / ``matmul`` dispatches, bound by ``Model.__init__`` as
      a policy scope around ``loss``, ``prefill``, ``prefill_chunk`` and
      ``decode_step`` (``policy.from_run_options``, as in JAX).  ``auto``
      and ``pallas`` take the kernel (its plain version on a CPU tensor);
      ``jnp`` and ``ref`` take the plain version on a CPU tensor and raise
      on a CUDA one (``registry.route``).
    * ``fused_qkv``: the matmul op's ``qkv_fused`` variant in that scope:
      each attention block's three input projections become one product
      over ``cat([wq, wk, wv], 1)`` (``common.qkv_project``), one K2 launch
      where there were three.
    * ``autotune``: the measured autotune's mode in that scope
      (``kernels/autotune.py``): ``"off"`` runs the planner's plans,
      ``"replay"`` overlays the device's tuned table, ``"search"`` also
      measures each call the table misses and records it.  ``None``
      defers to the process mode; the ``Server``, ``Engine`` and trainer
      resolve it first (``planner.resolve_run_options``: ``REPRO_AUTOTUNE``,
      else ``replay``) and pin it process-wide (``autotune.startup``), as
      JAX's do.
    * ``use_banded_local``, ``causal_block_skip``: in JAX these leave the
      attention kernel for jnp routes that compute the same attention.  The
      port has no jnp route on the card, so attention stays on K1, which
      already skips fully masked tiles; they change nothing.
    * ``q_block``, ``kv_block``: in JAX they size only those jnp routes'
      tiles and thresholds; K1, K1q and K3 fix their own blocks, so they
      change nothing (``resolve_run_options`` fills them as JAX's does).
    """

    remat: str = "full"  # "none" | "full": recompute each layer in backward
    ce_chunk: int = 512  # sequence chunk of the cross-entropy
    q_block: Optional[int] = None  # JAX's jnp-route tiles: no effect here
    kv_block: Optional[int] = None
    attention_impl: str = "auto"  # "auto" | "pallas" | "jnp" | "ref"
    matmul_impl: str = "auto"
    autotune: Optional[str] = None  # None | "off" | "replay" | "search"
    use_banded_local: bool = False  # JAX's jnp routes: attention stays on K1
    causal_block_skip: bool = False
    windowed_decode_cache: bool = False  # ring-buffer cache for local layers
    moe_dispatch: str = "sort"  # "sort" (prod) | "onehot" (reference)
    moe_groups: int = 1  # dispatch groups (set to dp size by the planner)
    fused_qkv: bool = False  # one QKV product per attention block
    microbatches: int = 1  # gradient-accumulation microbatches


class TensorSpec(NamedTuple):
    """Shape and dtype of a modality input (JAX's ``ShapeDtypeStruct`` in
    ``batch_extras_specs``)."""

    shape: tuple
    dtype: torch.dtype


class UnsupportedFamilyError(TypeError):
    """A model family (or a feature of one) is not available in the port;
    carries the family and the first missing piece as structured fields."""

    def __init__(self, family: str, missing: str):
        self.family = family
        self.missing = missing
        super().__init__(f"model family {family!r} is not supported by "
                         f"repro_torch: missing {missing!r}")


class Model(nn.Module):
    """Family-agnostic interface used by the server and the trainer."""

    def __init__(self, cfg: ModelConfig, opts: Optional[RunOptions] = None):
        super().__init__()
        self.cfg = cfg
        self.opts = opts or RunOptions()
        # RunOptions' backend knobs -> a policy scope around the entry points
        # (JAX base.py:90-94); building the scope's policy once here raises on
        # a knob the port refuses (an unknown autotune mode) when the model is
        # built
        self._policy_updates = policy.from_run_options(self.opts)
        if self._policy_updates is not None:
            policy.ExecutionPolicy().with_(**self._policy_updates)
            for name in ("loss", "prefill", "prefill_chunk", "decode_step"):
                setattr(self, name, policy.bind(self._policy_updates, getattr(self, name)))

    def init(self, generator: torch.Generator) -> None:
        """Fill every parameter in place from ``generator``."""
        raise NotImplementedError

    def loss(self, batch: dict) -> torch.Tensor:
        """batch: ``tokens`` and ``labels`` (b, s), and the family's
        modality inputs (:meth:`batch_extras_specs`).  Returns the mean
        loss, an f32 scalar that carries the graph back to the parameters."""
        raise NotImplementedError

    def init_cache(self, batch_size: int, max_len: int):
        raise NotImplementedError

    def prefill(self, batch: dict, max_len: int):
        """batch: ``tokens`` (b, s) and the family's modality inputs, each
        with b rows (:meth:`batch_extras_specs`).  Returns (last-token
        logits (b, V) f32, cache)."""
        raise NotImplementedError

    def prefill_chunk(self, tokens: torch.Tensor, offset: torch.Tensor, cache, *,
                      first: bool = False, lens: Optional[torch.Tensor] = None,
                      extras: Optional[dict] = None):
        """One padded prefill chunk over the full cache batch.

        tokens: (b, s); offset: int32 scalar or per-row (b,) context depths
        already in the cache; lens: optional (b,) valid-token counts (None =
        the whole chunk is valid on every row; 0 parks a row, whose cache
        state must come through unchanged).  ``first`` marks each request's
        first chunk (scale calibration runs there, and a modality family
        reads ``extras``, its full-batch inputs, to fill each live row's
        cross-attention cache).  Returns (per-row last-valid-token logits
        (b, V) f32, cache)."""
        raise NotImplementedError

    def decode_step(self, tokens: torch.Tensor, pos: torch.Tensor, cache):
        """tokens: (b, 1); pos: scalar or per-row (b,) int32 tensor.
        Returns (logits (b, V) f32, cache)."""
        raise NotImplementedError

    def batch_extras_specs(self, batch_size: int, seq_len: int) -> dict[str, TensorSpec]:
        """Shapes and dtypes of modality-frontend inputs (VLM/audio), keyed
        by name; none for a text-only family."""
        return {}


def maybe_remat(fn, opts: RunOptions):
    """``fn`` recomputed in the backward when ``opts.remat == "full"``
    (``torch.utils.checkpoint``, the non-reentrant form): only its inputs
    are kept between forward and backward.  The layers draw no random
    numbers, so no RNG state is stashed for the recomputation.  The
    recomputation runs under the policy the forward ran under (the backward
    runs outside the model's policy scope), so it dispatches the same
    products (fused QKV or not) and saves the same tensors, and under the
    sharding rules the forward ran under (``core/sharding_hints.py``)."""
    if opts.remat != "full":
        return fn

    def remat(*args, **kwargs):
        from repro_torch.core import sharding_hints

        pol, rules = policy.current(), sharding_hints.current()

        @contextlib.contextmanager
        def recompute():
            with policy.apply(pol), sharding_hints.restore(rules):
                yield

        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                          context_fn=lambda: (contextlib.nullcontext(), recompute()),
                          **kwargs)

    return functools.wraps(fn)(remat)


def right_shift(tokens: torch.Tensor, bos: int = 1) -> torch.Tensor:
    """Teacher-forcing input from target tokens."""
    return torch.cat([torch.full_like(tokens[:, :1], bos), tokens[:, :-1]], dim=1)
