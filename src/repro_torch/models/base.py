"""Model API shared by the port's families: the counterpart of
``repro/models/base.py``.

A model is an ``nn.Module`` that owns its parameters, so the JAX methods'
``params`` argument goes away.  ``RunOptions`` keeps the fields the
training path reads (``remat``, ``ce_chunk``, ``microbatches``), the MoE
dispatch's (``moe_dispatch``, ``moe_groups``) and the hybrid's decode-cache
layout (``windowed_decode_cache``), with the JAX names and defaults; the
rest of the JAX dataclass chooses attention tiles and jnp routes, and the
port's kernels pick their own tiles and have no jnp route.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class RunOptions:
    """Execution options the training path, the MoE layers and the
    hybrid's cache read (JAX ``base.py:37-69``)."""

    remat: str = "full"  # "none" | "full": recompute each layer in backward
    ce_chunk: int = 512  # sequence chunk of the cross-entropy
    microbatches: int = 1  # gradient-accumulation microbatches
    moe_dispatch: str = "sort"  # "sort" (prod) | "onehot" (reference)
    moe_groups: int = 1  # dispatch groups (set to dp size by the planner)
    windowed_decode_cache: bool = False  # ring-buffer cache for local layers


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
    numbers, so no RNG state is stashed for the recomputation."""
    if opts.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 preserve_rng_state=False)
    return fn


def right_shift(tokens: torch.Tensor, bos: int = 1) -> torch.Tensor:
    """Teacher-forcing input from target tokens."""
    return torch.cat([torch.full_like(tokens[:, :1], bos), tokens[:, :-1]], dim=1)
