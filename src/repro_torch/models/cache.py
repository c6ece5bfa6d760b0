"""Decode-cache state: the counterpart of the ``LinearKV`` layout and the
composite helpers of ``repro/models/cache.py``.

``LinearKV`` holds contiguous k/v slabs with the batch at axis ``b_axis``
and the sequence right after it, an optional int8 quantization (per-(batch,
kv-head) f32 scales ride alongside, ``(*lead, b, kvh)``), and a per-row
``(b,)`` int32 ``pos``: each row's context depth and next write position,
the same vector the attention kernel reads as its per-row lanes.  The
serving engine talks to a cache only through the module-level helpers
(:func:`slot`, :func:`set_slot`, :func:`reset_row`, :func:`set_row_valid`,
:func:`lengths`, :func:`snapshot_row`, :func:`restore_row`), which take a
layout or a dict/tuple of layouts, as in JAX.

Where JAX donates the cache to the jitted step and gets a new one back, the
port writes the slabs and scales in place (:func:`linear_write`,
:meth:`LinearKV.set_slot`): a full-width cache would otherwise be copied on
every step.  A ``LinearKV`` returned by a step therefore shares its slabs
with the one passed in, and :meth:`LinearKV.slot` returns views.  Only
``pos`` is replaced rather than written, so a step that fails part way
leaves the cursors where they were.  A snapshot must not follow later
writes, so :func:`snapshot_row` copies (``.to("cpu")`` alone returns the
same storage for a CPU tensor).
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
    k_scale: Optional[torch.Tensor]   # (*lead, b, kvh) f32 | None
    v_scale: Optional[torch.Tensor]
    b_axis: int

    @classmethod
    def create(cls, lead, batch, seq, kv_heads, head_dim, dtype, *,
               device, quantized: bool = False) -> "LinearKV":
        """Zeroed slabs of shape (*lead, batch, seq, kv_heads, head_dim);
        with ``quantized``, ``dtype`` is int8 and the scales start at 1."""
        shape = tuple(lead) + (batch, seq, kv_heads, head_dim)

        def scale():
            return (torch.ones(tuple(lead) + (batch, kv_heads), dtype=torch.float32,
                               device=device) if quantized else None)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   pos=torch.zeros((batch,), dtype=torch.int32, device=device),
                   k_scale=scale(), v_scale=scale(), b_axis=len(lead))

    @property
    def capacity(self) -> int:
        return self.k.shape[self.b_axis + 1]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def replace(self, **kw) -> "LinearKV":
        return dataclasses.replace(self, **kw)

    def _rows(self, t: Optional[torch.Tensor], i: int) -> Optional[torch.Tensor]:
        return None if t is None else t.narrow(self.b_axis, i, 1)

    def slot(self, i: int) -> "LinearKV":
        """Row ``i`` as a b=1 cache whose slabs and scales are VIEWS of this
        cache's (``pos`` is a copy)."""
        return self.replace(k=self._rows(self.k, i), v=self._rows(self.v, i),
                            pos=self.pos[i:i + 1].clone(),
                            k_scale=self._rows(self.k_scale, i),
                            v_scale=self._rows(self.v_scale, i))

    def set_slot(self, i: int, sub: "LinearKV") -> "LinearKV":
        """Write the b=1 cache ``sub`` into row ``i``: slabs and scales in
        place, through :meth:`slot`'s views; ``pos`` in a new vector."""
        dst = self.slot(i)
        for name in ("k", "v", "k_scale", "v_scale"):
            t = getattr(dst, name)
            if t is not None:
                t.copy_(getattr(sub, name))
        pos = self.pos.clone()
        pos[i:i + 1] = sub.pos.to(pos.device)
        return self.replace(pos=pos)

    def reset_row(self, i: int) -> "LinearKV":
        # slabs need no zeroing: writes are position-exact and nothing
        # attends past the row's pos (the per-row kv_len masks it)
        pos = self.pos.clone()
        pos[i] = 0
        return self.replace(pos=pos)

    def lengths(self) -> torch.Tensor:
        return self.pos


_LAYOUTS = (LinearKV,)


# ---------------------------------------------------------------------------
# composite helpers: a cache is a layout, or a dict/tuple of caches
# ---------------------------------------------------------------------------

def _map_layouts(cache, fn):
    if isinstance(cache, _LAYOUTS):
        return fn(cache)
    if isinstance(cache, dict):
        return {k: _map_layouts(v, fn) for k, v in cache.items()}
    if isinstance(cache, (tuple, list)):
        return type(cache)(_map_layouts(v, fn) for v in cache)
    raise TypeError(f"not a DecodeCache composite: {type(cache)!r}")


def _leaves(cache) -> list:
    """Every tensor of a composite (None where a layout has no scales), in
    a fixed order, with the layout fields that name them."""
    out = []
    _map_layouts(cache, lambda lo: out.extend(
        (f.name, getattr(lo, f.name)) for f in dataclasses.fields(lo)
        if f.name != "b_axis") or lo)
    return out


def slot(cache, i: int):
    """The b=1 slice of every layout for engine slot ``i`` (views)."""
    return _map_layouts(cache, lambda lo: lo.slot(i))


def set_slot(cache, i: int, sub):
    """Write a b=1 sub-cache back into slot ``i`` of every layout."""
    if isinstance(cache, _LAYOUTS):
        return cache.set_slot(i, sub)
    if isinstance(cache, dict):
        return {k: set_slot(v, i, sub[k]) for k, v in cache.items()}
    return type(cache)(set_slot(v, i, s) for v, s in zip(cache, sub))


def reset_row(cache, i: int):
    """Row ``i`` leaves its request: cursors to zero.  The engine calls this
    at admission so a reused slot never sees its predecessor's context."""
    return _map_layouts(cache, lambda lo: lo.reset_row(i))


def set_row_valid(cache, i: int, flag: bool):
    """Flip row ``i``'s recurrent-state validity.  Only recurrent-state
    layouts carry one, and the port has none yet: ``LinearKV`` rows are
    already row-exact through their cursors, so this returns ``cache``."""
    return cache


def snapshot_row(cache, i: int):
    """Host-staged COPY of slot ``i`` across every layout: the b=1 slice of
    the composite with every tensor copied to host memory, so it costs no
    device memory and later writes to the row (which land in place) never
    reach it.  It is the resume point for fault recovery and pressure
    eviction; restore with :func:`restore_row`, into the same or a
    DIFFERENT slot (row slices carry no slot identity)."""
    def copy(lo):
        return lo.replace(**{name: None if t is None else t.to("cpu", copy=True)
                             for name, t in _leaves(lo)})
    return _map_layouts(slot(cache, i), copy)


def restore_row(cache, i: int, snap):
    """Write a :func:`snapshot_row` back into slot ``i``: slabs, cursor and
    int8 scales all land, so the row resumes exactly at its snapshot
    point."""
    return set_slot(cache, i, snap)


def snapshot_compatible(cache, snap) -> None:
    """Validate that a :func:`snapshot_row` can restore into ``cache``: the
    same composite structure, every tensor matching the cache's own b=1 row
    in shape and dtype.  A mismatch (another ``max_len``, quantization or
    family) raises ``ValueError`` naming it, rather than corrupting a
    row."""
    try:
        ref = _leaves(slot(cache, 0))
        got = _leaves(snap)
    except TypeError as e:
        raise ValueError(f"snapshot layout mismatch: {e}") from e
    if [n for n, _ in ref] != [n for n, _ in got]:
        raise ValueError(f"snapshot layout mismatch: cache rows have "
                         f"{[n for n, _ in ref]}, snapshot {[n for n, _ in got]}")
    for (name, r), (_, s) in zip(ref, got):
        if (r is None) != (s is None):
            raise ValueError(f"snapshot layout mismatch: {name} is "
                             f"{'absent' if r is None else 'present'} in the cache rows")
        if r is None:
            continue
        if tuple(r.shape) != tuple(s.shape):
            raise ValueError(f"snapshot row shape mismatch: cache row {name} "
                             f"{tuple(r.shape)} vs snapshot {tuple(s.shape)}")
        if r.dtype != s.dtype:
            raise ValueError(f"snapshot row dtype mismatch: cache row {name} "
                             f"{r.dtype} vs snapshot {s.dtype}")


def lengths(cache):
    """Per-row context depth: the elementwise max over every layout's
    lengths."""
    found = []
    _map_layouts(cache, lambda lo: found.append(lo.lengths()) or lo)
    out = found[0]
    for x in found[1:]:
        out = torch.maximum(out, x)
    return out


# ---------------------------------------------------------------------------
# mutation helpers
# ---------------------------------------------------------------------------

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


def masked_rows(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor,
                axis: int = 0) -> torch.Tensor:
    """Per-row select ``where(mask, new, old)`` with ``mask`` (b,) aligned
    to the batch ``axis`` and broadcast over every other dim (a first-chunk
    launch keeps a parked row's stored scales: mask = lens > 0)."""
    shape = [1] * new.dim()
    shape[axis] = mask.shape[0]
    return torch.where(mask.reshape(shape), new, old)


def pick_last(x: torch.Tensor, lens: Optional[torch.Tensor]) -> torch.Tensor:
    """Each row's features at its last valid token: ``x`` (b, s, d),
    ``lens`` (b,) valid counts (None = the full chunk) -> (b, d)."""
    if lens is None:
        return x[:, -1]
    row = (lens.long() - 1).clamp(0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), row]
