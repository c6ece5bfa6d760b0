"""Int8 gradient compression with error feedback: the port's copy of
``repro/optim/compression.py``, for data-parallel gradient sync where link
bandwidth binds (no caller on one device yet).

Per-tensor symmetric int8 quantization, ``q = round(g / s)`` with ``s =
max|g| / 127``, and an error-feedback residual carried between steps so
that the quantization error does not bias the update (Karimireddy et al.,
2019).  Gradient trees are dicts of tensors keyed by parameter name.
"""
from __future__ import annotations

import torch


def compress_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (q int8, scale f32)."""
    g32 = g.float()
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compress_tree(grads: dict) -> tuple[dict, dict]:
    pairs = {n: compress_int8(g) for n, g in grads.items()}
    return {n: q for n, (q, _) in pairs.items()}, {n: s for n, (_, s) in pairs.items()}


def ef_compress(grads: dict, residual: dict) -> tuple[dict, dict, dict]:
    """Error-feedback compression: returns (q, scales, new residual)."""
    qs, ss, rs = {}, {}, {}
    for n, g in grads.items():
        x = g.float() + residual[n]
        qs[n], ss[n] = compress_int8(x)
        rs[n] = x - decompress_int8(qs[n], ss[n])
    return qs, ss, rs
