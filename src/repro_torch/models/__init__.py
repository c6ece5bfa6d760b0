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


def check_sharded(cfg: ModelConfig, mesh) -> None:
    """Raise ``NotImplementedError`` naming the family, the config or the
    option when ``cfg`` cannot yet execute sharded on ``mesh`` (a real mesh
    of more than one rank): the dense family runs sharded when the
    tensor-parallel axis divides its query and KV heads; MoE layers, the
    hybrid, SSM, encoder-decoder and VLM families are the next slices
    (``ROADMAP.md`` queue 1).  Nothing is replicated quietly.  A no-op on a
    mesh of one device."""
    from repro_torch.launch.mesh import axis_sizes, is_sharded, refuse

    if not is_sharded(mesh):
        return
    if cfg.family != "dense" or cfg.n_experts:
        refuse(f"the {cfg.family} family ({cfg.name}"
               f"{', MoE layers' if cfg.n_experts else ''})", mesh)
    tp = axis_sizes(mesh).get("model", 1)
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        refuse(f"{cfg.name}'s {cfg.n_heads} query / {cfg.n_kv_heads} KV heads over "
               f"model={tp} (replicated KV heads)", mesh)


__all__ = ["Model", "RunOptions", "UnsupportedFamilyError", "build_model", "check_sharded"]
