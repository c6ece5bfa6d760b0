"""Model configuration: the port's own copy of ``repro.configs.base``.

``ModelConfig`` keeps every field of the JAX package's dataclass, with the
same names and defaults, so that a configuration means the same on both
sides (a test holds the two field lists equal).  ``activation_dtype`` is a
``torch.dtype``.  ``param_count`` and ``active_param_count`` are the JAX
package's analytic counts.  Every architecture of the JAX package is
registered: the dense family (``qwen3-1.7b``, ``qwen3-32b``,
``qwen2.5-14b``, ``gemma3-1b``) and its MoE configs (``olmoe-1b-7b``,
``qwen3-moe-30b-a3b``), the hybrid ``recurrentgemma-2b``, the SSM
``mamba2-370m``, the encoder-decoder ``seamless-m4t-large-v2`` and the VLM
``llama-3.2-vision-90b``; ``list_archs`` names them.
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

    @property
    def is_attention_free(self) -> bool:
        """JAX's property, mirrored for the parity tests; no port code
        reads it."""
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True if attention cost is sub-quadratic in context (SSM / hybrid /
        mostly-sliding-window).  JAX's property, mirrored for the parity
        tests: JAX picks its long-context cells by it; the port has no such
        cell and no port code reads it."""
        if self.family in ("ssm", "hybrid"):
            return True
        # mostly-local attention (Gemma3 5:1) bounds the full-attention layers
        return self.sliding_window is not None and (self.global_every or 0) > 1

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count N (JAX ``configs/base.py:131-193``)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim_
        emb = v * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            p = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qkv_bias:
                p += self.q_dim + 2 * self.kv_dim
            if self.qk_norm:
                p += 2 * hd
            return p

        def mlp_params(f: int) -> int:
            return 3 * d * f  # gated (SwiGLU-style): up, gate, down

        def norm_params() -> int:
            return 2 * d

        total = emb + d  # final norm
        if self.family in ("dense", "vlm"):
            per_layer = attn_params() + mlp_params(ff) + norm_params()
            total += self.n_layers * per_layer
            if self.cross_attn_every:
                n_cross = self.n_layers // self.cross_attn_every
                total += n_cross * (attn_params() + norm_params())
        elif self.family == "moe":
            per_layer = attn_params() + norm_params()
            per_layer += d * self.n_experts  # router
            per_layer += self.n_experts * 3 * d * self.expert_d_ff
            total += self.n_layers * per_layer
        elif self.family == "hybrid":
            w = self.lru_width or d
            n_attn = sum(1 for b in self._layer_kinds() if b == "attn")
            n_rec = self.n_layers - n_attn
            rec = d * w * 2 + w * self.conv1d_width + 2 * w + w * d
            total += n_rec * (rec + norm_params()) + n_attn * (attn_params() + norm_params())
            total += self.n_layers * mlp_params(ff)
        elif self.family == "ssm":
            di, ds = self.ssm_d_inner, self.ssm_state
            nh = self.ssm_n_heads
            per_layer = d * (2 * di + 2 * ds + nh)
            per_layer += di * self.conv1d_width + nh + nh
            per_layer += di * d + norm_params()
            total += self.n_layers * per_layer
        elif self.family == "audio":
            per_enc = attn_params() + mlp_params(ff) + norm_params()
            per_dec = 2 * attn_params() + mlp_params(ff) + norm_params()
            total += self.encoder_layers * per_enc + self.n_layers * per_dec
        return total

    def active_param_count(self) -> int:
        """Active params per token (== param_count for dense)."""
        if self.family != "moe":
            return self.param_count()
        inactive = (self.n_layers * (self.n_experts - self.experts_per_token) * 3
                    * self.d_model * self.expert_d_ff)
        return self.param_count() - inactive

    def _layer_kinds(self) -> list[str]:
        """Per-layer kind sequence for pattern archs (hybrid)."""
        if not self.block_pattern:
            return ["attn"] * self.n_layers
        kinds: list[str] = []
        while len(kinds) < self.n_layers:
            kinds.extend(self.block_pattern)
        return kinds[: self.n_layers]


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


def list_archs() -> list[str]:
    """The architectures the port registers."""
    _ensure_loaded()
    return sorted(_REGISTRY)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    return dataclasses.replace(cfg, **overrides)


def _ensure_loaded() -> None:
    from repro_torch.configs import (  # noqa: F401  (each registers itself)
        gemma3_1b,
        llama_3_2_vision_90b,
        mamba2_370m,
        olmoe_1b_7b,
        qwen2_5_14b,
        qwen3_1_7b,
        qwen3_32b,
        qwen3_moe_30b_a3b,
        recurrentgemma_2b,
        seamless_m4t_large_v2,
    )
