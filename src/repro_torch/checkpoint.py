"""Carry ``repro``'s parameters into the port, without JAX.

``repro`` keeps a dense model's parameters as a pytree whose per-layer
leaves are stacked along a leading layer axis (``layers/wq`` is
``(L, d, q_dim)``).  The port's ``DenseLM`` holds one module per layer
(``layers.<i>.wq``).  :func:`params_from_numpy` converts the pytree, as
numpy arrays, into the port's state dict by unstacking the layer axis;
:func:`load_repro_checkpoint` does the same from a checkpoint directory
written by ``repro.checkpoint.save_checkpoint``: one ``.npy`` per
``/``-joined leaf name, bf16 stored as uint16 with the logical dtype and a
SHA-256 per leaf in ``manifest.json``.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch


def _to_tensor(arr: np.ndarray, dtype_name: Optional[str] = None) -> torch.Tensor:
    """numpy -> torch, keeping bf16 bit-exact: a bf16 array (ml_dtypes, or
    raw uint16 bits with ``dtype_name == "bfloat16"``) goes through uint16."""
    if dtype_name == "bfloat16" or str(arr.dtype) == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _unstack(flat: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """``/``-joined pytree names -> the port's state dict: ``layers/<x>``
    of shape (L, ...) becomes ``layers.<i>.<x>`` for each layer i."""
    out = {}
    for name, t in flat.items():
        parts = name.split("/")
        if parts[0] == "layers":
            if len(parts) != 2:
                raise ValueError(f"unexpected layer leaf {name!r}")
            for i in range(t.shape[0]):
                out[f"layers.{i}.{parts[1]}"] = t[i].clone()
        else:
            out[".".join(parts)] = t
    return out


def _flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        flat = {}
        for key, sub in tree.items():
            flat.update(_flatten(sub, f"{prefix}{key}/"))
        return flat
    return {prefix[:-1]: tree}


def params_from_numpy(tree: dict) -> dict[str, torch.Tensor]:
    """``repro``'s parameter pytree (nested dicts of numpy arrays,
    layer-stacked) -> the port's state dict, on the CPU."""
    return _unstack({name: _to_tensor(np.asarray(leaf))
                     for name, leaf in _flatten(tree).items()})


def load_repro_checkpoint(directory, step: Optional[int] = None) -> dict[str, torch.Tensor]:
    """Read ``<directory>/step_<step>`` (default: the latest step) as written
    by ``repro.checkpoint.save_checkpoint`` for a parameter pytree, verify
    every leaf's checksum, and return the port's state dict (CPU tensors)."""
    directory = Path(directory)
    if step is None:
        steps = [int(p.name.split("_")[1]) for p in directory.glob("step_*")
                 if not p.name.endswith(".tmp")]
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        step = max(steps)
    d = directory / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat = {}
    for leaf in manifest["leaves"]:
        raw = (d / leaf["file"]).read_bytes()
        if hashlib.sha256(raw).hexdigest() != leaf["sha256"]:
            raise IOError(f"checksum mismatch for {leaf['name']}")
        arr = np.load(d / leaf["file"])
        if list(arr.shape) != list(leaf["shape"]):
            raise ValueError(f"shape mismatch {leaf['name']}: {arr.shape} vs {leaf['shape']}")
        flat[leaf["name"]] = _to_tensor(arr, leaf["dtype"])
    return _unstack(flat)
