"""PyTorch/CUDA port of ``repro``, slice by slice (see ROADMAP.md).

The JAX package ``repro`` is the reference and stays as it is; this package
imports ``torch`` and nothing of JAX or ``repro``.  Its kernels are written
by hand in CUDA C++ for the H100 (``repro_torch.kernels``).  Entry points run
on CUDA unless the caller passes ``device="cpu"``, where every kernel takes
its plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` names
    another.  Raises when CUDA is wanted and absent, rather than carrying on
    quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return dev
