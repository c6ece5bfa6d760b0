"""Model configuration: the port's own copy of ``repro.configs.base``.

``ModelConfig`` keeps every field of the JAX package's dataclass, with the
same names and defaults, so that a configuration means the same on both
sides (a test holds the two field lists equal).  ``activation_dtype`` is a
``torch.dtype``.  Only the architectures this slice serves are registered.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell: seq_len x global_batch + step kind."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The four assigned LM shapes (identical across the architectures).
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.  Fields default to 'absent'."""

    name: str
    family: str  # dense | moe | vlm | hybrid | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    scale_embeddings: bool = False

    sliding_window: Optional[int] = None
    global_every: Optional[int] = None

    n_experts: int = 0
    experts_per_token: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    cross_attn_every: Optional[int] = None
    n_image_tokens: int = 0

    block_pattern: tuple[str, ...] = ()
    lru_width: int = 0
    conv1d_width: int = 4

    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: Optional[int] = 256

    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_len_ratio: float = 0.25

    dtype: str = "bfloat16"

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // max(self.n_heads, 1)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim_

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim_

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


_REGISTRY: dict[str, ModelConfig] = {}
_SMOKE_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    _SMOKE_REGISTRY[cfg.name] = smoke
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def get_smoke_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _SMOKE_REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_SMOKE_REGISTRY)}")
    return _SMOKE_REGISTRY[name]


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    return dataclasses.replace(cfg, **overrides)


def _ensure_loaded() -> None:
    from repro_torch.configs import qwen3_1_7b  # noqa: F401  (registers itself)
