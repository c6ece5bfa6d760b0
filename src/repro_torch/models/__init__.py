"""Model zoo: build a ported architecture from its config."""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models.base import Model, RunOptions, UnsupportedFamilyError


def build_model(cfg: ModelConfig, opts: Optional[RunOptions] = None, *,
                device=None) -> Model:
    """The family's model on ``device`` (CUDA unless told otherwise), with
    uninitialised parameters: call ``init`` or ``load_state_dict``.  The
    dense family and its MoE configs (whose layers live inside ``DenseLM``,
    as in JAX), the hybrid and the SSM are ported; ``audio`` and ``vlm``
    raise."""
    if cfg.family in ("dense", "moe"):
        from repro_torch.models.dense import DenseLM as cls
    elif cfg.family == "hybrid":
        from repro_torch.models.hybrid import HybridLM as cls
    elif cfg.family == "ssm":
        from repro_torch.models.ssm import SSMLM as cls
    else:
        raise UnsupportedFamilyError(cfg.family, "model class")
    return cls(cfg, opts, device=device)


__all__ = ["Model", "RunOptions", "UnsupportedFamilyError", "build_model"]
