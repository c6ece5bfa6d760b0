"""Model zoo: build a ported architecture from its config."""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models.base import Model, RunOptions, UnsupportedFamilyError


def build_model(cfg: ModelConfig, opts: Optional[RunOptions] = None, *,
                device=None) -> Model:
    """The family's model on ``device`` (CUDA unless told otherwise), with
    uninitialised parameters: call ``init`` or ``load_state_dict``.  Every
    family of the JAX package is ported: the dense family and its MoE
    configs (whose layers live inside ``DenseLM``, as in JAX), the hybrid,
    the SSM, the encoder-decoder (``audio``) and the VLM.  An unknown
    family raises ``ValueError``, as JAX's ``build_model`` does."""
    if cfg.family in ("dense", "moe"):
        from repro_torch.models.dense import DenseLM as cls
    elif cfg.family == "hybrid":
        from repro_torch.models.hybrid import HybridLM as cls
    elif cfg.family == "ssm":
        from repro_torch.models.ssm import SSMLM as cls
    elif cfg.family == "audio":
        from repro_torch.models.encdec import EncDecLM as cls
    elif cfg.family == "vlm":
        from repro_torch.models.vlm import VisionLM as cls
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return cls(cfg, opts, device=device)


__all__ = ["Model", "RunOptions", "UnsupportedFamilyError", "build_model"]
