"""Decode-cache state: the counterpart of the ``LinearKV`` layout and its
helpers in ``repro/models/cache.py``.

``LinearKV`` holds contiguous k/v slabs with the batch at axis ``b_axis``
and the sequence right after it, and a per-row ``(b,)`` int32 ``pos``: each
row's context depth and next write position, the same vector the attention
kernel reads as its per-row lanes.

Where JAX donates the cache to the jitted step and gets a new one back, the
port writes the slabs in place (:func:`linear_write`): a full-width cache
would otherwise be copied on every step.  A ``LinearKV`` returned by a step
therefore shares its slabs with the one passed in.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Union

import torch


@dataclass(frozen=True)
class LinearKV:
    """Contiguous k/v slabs; batch at axis ``b_axis``, sequence at
    ``b_axis + 1``."""

    k: torch.Tensor                   # (*lead, b, S, kvh, hd)
    v: torch.Tensor
    pos: torch.Tensor                 # (b,) int32
    b_axis: int

    @classmethod
    def create(cls, lead, batch, seq, kv_heads, head_dim, dtype, *,
               device) -> "LinearKV":
        """Zeroed slabs of shape (*lead, batch, seq, kv_heads, head_dim)."""
        shape = tuple(lead) + (batch, seq, kv_heads, head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   pos=torch.zeros((batch,), dtype=torch.int32, device=device),
                   b_axis=len(lead))

    @property
    def capacity(self) -> int:
        return self.k.shape[self.b_axis + 1]

    def replace(self, **kw) -> "LinearKV":
        return dataclasses.replace(self, **kw)

    def reset_row(self, i: int) -> "LinearKV":
        # slabs need no zeroing: writes are position-exact and nothing
        # attends past the row's pos (the per-row kv_len masks it)
        pos = self.pos.clone()
        pos[i] = 0
        return self.replace(pos=pos)

    def lengths(self) -> torch.Tensor:
        return self.pos


def linear_write(slab: torch.Tensor, new: torch.Tensor,
                 write_at: Union[int, torch.Tensor]) -> torch.Tensor:
    """Write ``new`` (b, s, kvh, hd) into ``slab`` (b, S, kvh, hd) at
    sequence offset ``write_at``, in place, and return ``slab``.

    ``write_at`` is a Python int, or an int tensor holding a scalar (lockstep)
    or one offset per row (continuous batching).  As JAX's
    ``dynamic_update_slice`` does, each start is clamped to ``[0, S - s]``,
    so a write past the end lands on the last ``s`` slots instead of
    writing short.  A tensor offset stays on the device: no host sync."""
    b, s = new.shape[:2]
    cap = slab.shape[1]
    if s > cap:
        raise ValueError(f"linear_write: {s} tokens into a {cap}-slot slab")
    if isinstance(write_at, int):
        start = min(max(write_at, 0), cap - s)
        slab[:, start:start + s] = new
        return slab
    start = write_at.reshape(-1).long().clamp(0, cap - s)            # (1,) or (b,)
    idx = start[:, None] + torch.arange(s, device=slab.device)       # (1|b, s)
    idx = idx.expand(b, s)[:, :, None, None].expand_as(new)
    return slab.scatter_(1, idx, new)


def pick_last(x: torch.Tensor, lens: Optional[torch.Tensor]) -> torch.Tensor:
    """Each row's features at its last valid token: ``x`` (b, s, d),
    ``lens`` (b,) valid counts (None = the full chunk) -> (b, d)."""
    if lens is None:
        return x[:, -1]
    row = (lens.long() - 1).clamp(0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), row]
