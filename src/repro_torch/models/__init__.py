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
    as in JAX) are ported; any other family raises."""
    if cfg.family not in ("dense", "moe"):
        raise UnsupportedFamilyError(cfg.family, "model class")
    from repro_torch.models.dense import DenseLM

    return DenseLM(cfg, opts, device=device)


__all__ = ["Model", "RunOptions", "UnsupportedFamilyError", "build_model"]
