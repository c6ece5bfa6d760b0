"""Model API shared by the port's families: the counterpart of
``repro/models/base.py``.

A model is an ``nn.Module`` that owns its parameters, so the JAX methods'
``params`` argument goes away.  The JAX ``RunOptions`` has no counterpart
yet: the fields its dense serving path reads are attention tile sizes and
the jnp-route choices (banded local attention, causal block skip), and the
port's kernels pick their own tiles and have no jnp route.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig


class UnsupportedFamilyError(TypeError):
    """A model family (or a feature of one) is not available in the port;
    carries the family and the first missing piece as structured fields."""

    def __init__(self, family: str, missing: str):
        self.family = family
        self.missing = missing
        super().__init__(f"model family {family!r} is not supported by "
                         f"repro_torch: missing {missing!r}")


class Model(nn.Module):
    """Family-agnostic interface used by the server."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg

    def init(self, generator: torch.Generator) -> None:
        """Fill every parameter in place from ``generator``."""
        raise NotImplementedError

    def init_cache(self, batch_size: int, max_len: int):
        raise NotImplementedError

    def prefill(self, tokens: torch.Tensor, max_len: int):
        """tokens: (b, s).  Returns (last-token logits (b, V) f32, cache)."""
        raise NotImplementedError

    def decode_step(self, tokens: torch.Tensor, pos: torch.Tensor, cache):
        """tokens: (b, 1); pos: scalar or per-row (b,) int32 tensor.
        Returns (logits (b, V) f32, cache)."""
        raise NotImplementedError
