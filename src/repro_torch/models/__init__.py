"""Model zoo: build a ported architecture from its config."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.base import Model, UnsupportedFamilyError


def build_model(cfg: ModelConfig, *, device=None) -> Model:
    """The family's model on ``device`` (CUDA unless told otherwise), with
    uninitialised parameters: call ``init`` or ``load_state_dict``.  Only the
    dense family is ported; any other family raises."""
    if cfg.family != "dense":
        raise UnsupportedFamilyError(cfg.family, "model class")
    from repro_torch.models.dense import DenseLM

    return DenseLM(cfg, device=device)


__all__ = ["Model", "UnsupportedFamilyError", "build_model"]
