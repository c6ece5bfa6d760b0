"""Decode-cache state: the counterpart of ``repro/models/cache.py``: the
``LinearKV``, ``RingKV``, ``CrossKV`` and ``StateCarry`` layouts and the
composite helpers.

``LinearKV`` holds contiguous k/v slabs with the batch at axis ``b_axis``
and the sequence right after it, an optional int8 quantization (per-(batch,
kv-head) f32 scales ride alongside, ``(*lead, b, kvh)``), and a per-row
``(b,)`` int32 ``pos``: each row's context depth and next write position,
the same vector the attention kernel reads as its per-row lanes; its
``lead`` may have several axes (the VLM's ``(n_super, n_self)``).
``RingKV`` is the hybrid's windowed decode buffer: ``C`` slots, position
``p`` in slot ``p % C``, attended with ``q_offset = pos`` and ``kv_len =
min(pos + 1, C)`` (:meth:`RingKV.attend_lens`).  ``CrossKV`` holds the
cross-attention k/v of the encoder-decoder and the VLM: written for a
row at its request's first prefill chunk and frozen for the request's
lifetime, position-free.  ``StateCarry`` holds the
recurrent families' state (conv tails, the RG-LRU's hidden state, the SSD
state), every tensor with the batch at axis 1, and a per-row ``valid``
flag.  The serving engine talks to a cache only through the module-level
helpers (:func:`slot`, :func:`set_slot`, :func:`reset_row`,
:func:`set_row_valid`, :func:`lengths`, :func:`snapshot_row`,
:func:`restore_row`), which take a layout or a dict/tuple of layouts, as in
JAX.

Where JAX donates the cache to the jitted step and gets a new one back, the
port writes the k/v slabs and scales in place (:func:`linear_write`,
:func:`ring_write`, ``set_slot``): a full-width cache would otherwise be
copied on every step.  A ``LinearKV`` or ``RingKV`` returned by a step
therefore shares its slabs with the one passed in, and ``slot`` returns
views.  Only ``pos`` is replaced rather than written, so a step that fails
part way leaves the cursors where they were.  A step returns NEW recurrent
state tensors (the old ones are read, never written), so a step that fails
part way leaves a ``StateCarry`` as it was and a retried step starts from
the same state; ``set_slot`` and ``reset_row`` write a ``StateCarry``'s
rows in place, as they do the slabs, and replace ``valid``.  A snapshot
must not follow later writes, so :func:`snapshot_row` copies
(``.to("cpu")`` alone returns the same storage for a CPU tensor).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Union

import torch


class _Slabs:
    """The row logic the positional layouts share: k/v slabs (and
    ``LinearKV``'s scales, the fields named in ``_ROWS``) with the batch at
    axis ``b_axis`` and the slots right after it, and a (b,) int32 cursor
    ``pos``."""

    _ROWS = ("k", "v")

    @property
    def capacity(self) -> int:
        return self.k.shape[self.b_axis + 1]

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def slot(self, i: int):
        """Row ``i`` as a b=1 cache whose slabs and scales are VIEWS of this
        cache's (``pos`` is a copy)."""
        rows = {n: None if (t := getattr(self, n)) is None else t.narrow(self.b_axis, i, 1)
                for n in self._ROWS}
        return self.replace(pos=self.pos[i:i + 1].clone(), **rows)

    def set_slot(self, i: int, sub):
        """Write the b=1 cache ``sub`` into row ``i``: slabs and scales in
        place, through :meth:`slot`'s views; ``pos`` in a new vector."""
        dst = self.slot(i)
        for name in self._ROWS:
            t = getattr(dst, name)
            if t is not None:
                t.copy_(getattr(sub, name))
        pos = self.pos.clone()
        pos[i:i + 1] = sub.pos.to(pos.device)
        return self.replace(pos=pos)

    def reset_row(self, i: int):
        # slabs need no zeroing: writes are position-exact and nothing
        # attends past the row's pos (the per-row kv_len masks it)
        pos = self.pos.clone()
        pos[i] = 0
        return self.replace(pos=pos)

    def map_tensors(self, fn):
        """This layout with ``fn`` applied to each of its tensors."""
        rows = {n: None if (t := getattr(self, n)) is None else fn(t) for n in self._ROWS}
        return self.replace(pos=fn(self.pos), **rows)


@dataclass(frozen=True)
class LinearKV(_Slabs):
    """Contiguous k/v slabs; batch at axis ``b_axis``, sequence at
    ``b_axis + 1``."""

    k: torch.Tensor                   # (*lead, b, S, kvh, hd)
    v: torch.Tensor
    pos: torch.Tensor                 # (b,) int32
    k_scale: Optional[torch.Tensor]   # (*lead, b, kvh) f32 | None
    v_scale: Optional[torch.Tensor]
    b_axis: int

    _ROWS = ("k", "v", "k_scale", "v_scale")

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
    def quantized(self) -> bool:
        return self.k_scale is not None

    def lengths(self) -> torch.Tensor:
        return self.pos

    def lanes(self, offset: torch.Tensor, s: int):
        """The attention kernel's lanes for ``s`` query rows at ``offset``
        (an int32 scalar or (b,) tensor) over this cache: ``q_offset``, and
        ``kv_len`` the keys up to the last query row, clipped to the
        capacity (JAX ``_attention_via_kernel``)."""
        q_offset = offset.reshape(-1)
        return q_offset, (q_offset + s).clamp(max=self.capacity)


@dataclass(frozen=True)
class RingKV(_Slabs):
    """Windowed ring buffer: capacity ``C`` slots at axis ``b_axis + 1``,
    absolute position ``p`` in slot ``p % C``.  ``pos`` (b,) int32 counts
    the tokens written to each row (the absolute cursor)."""

    k: torch.Tensor                   # (*lead, b, C, kvh, hd)
    v: torch.Tensor
    pos: torch.Tensor                 # (b,) int32
    b_axis: int

    @classmethod
    def create(cls, lead, batch, capacity, kv_heads, head_dim, dtype, *,
               device) -> "RingKV":
        shape = tuple(lead) + (batch, capacity, kv_heads, head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   pos=torch.zeros((batch,), dtype=torch.int32, device=device),
                   b_axis=len(lead))

    def lengths(self) -> torch.Tensor:
        return self.pos.clamp(max=self.capacity)

    # -- the per-row wrap-aware mapping onto the attention kernel's lanes --
    def attend_lens(self, pos: torch.Tensor) -> torch.Tensor:
        """``kv_len`` for a decode at absolute positions ``pos``: ``min(pos
        + 1, C)`` slots are live.  With ``q_offset = pos`` and causal
        masking the kernel attends exactly those: an unwrapped row's
        contiguous prefix, or (wrapped) the whole ring, every slot of which
        is inside the window since ``C <= window``."""
        return (pos.to(torch.int32) + 1).clamp(max=self.capacity)

    def slot_positions(self, pos: torch.Tensor) -> torch.Tensor:
        """The true position each slot holds, per row: slot ``j`` holds
        ``pos - ((pos - j) mod C)``; a never-written slot gets ``2^30``, so
        causal masking drops it.  (b, C) int32.  JAX's method, mirrored:
        the decode step attends through :meth:`attend_lens` instead, and
        only the parity tests read this."""
        c = self.capacity
        pos = pos.to(torch.int32).reshape(-1, 1)
        idx = torch.arange(c, dtype=torch.int32, device=pos.device)[None, :]
        ring_pos = pos - torch.remainder(pos - idx, c)
        return torch.where(ring_pos >= 0, ring_pos, 1 << 30)


@dataclass(frozen=True)
class CrossKV:
    """Cross-attention k/v (JAX ``cache.py:217-250``): slabs of the
    encoder's or the image's ``E`` keys with the batch at axis ``b_axis``,
    written at a request's first prefill chunk and frozen for its lifetime.
    Position-free: no cursor, and a reset leaves the slabs alone (the next
    first chunk overwrites the row whole)."""

    k: torch.Tensor                   # (*lead, b, E, kvh, hd)
    v: torch.Tensor
    b_axis: int

    @classmethod
    def create(cls, lead, batch, enc, kv_heads, head_dim, dtype, *,
               device) -> "CrossKV":
        shape = tuple(lead) + (batch, enc, kv_heads, head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   b_axis=len(lead))

    def replace(self, **kw) -> "CrossKV":
        return dataclasses.replace(self, **kw)

    def write(self, li, k: torch.Tensor, v: torch.Tensor,
              live: Optional[torch.Tensor] = None) -> None:
        """Write layer ``li``'s k/v (b, E, kvh, hd) into its slabs, in place;
        with ``live`` (b,) bool only those rows, the others keeping theirs
        (a first-chunk launch and its parked rows)."""
        for slab, new in ((self.k[li], k), (self.v[li], v)):
            slab.copy_(new if live is None else masked_rows(live, new, slab))

    def slot(self, i: int) -> "CrossKV":
        """Row ``i`` as a b=1 cache whose slabs are VIEWS of this one's."""
        return self.replace(k=self.k.narrow(self.b_axis, i, 1),
                            v=self.v.narrow(self.b_axis, i, 1))

    def set_slot(self, i: int, sub: "CrossKV") -> "CrossKV":
        dst = self.slot(i)
        dst.k.copy_(sub.k)
        dst.v.copy_(sub.v)
        return self

    def reset_row(self, i: int) -> "CrossKV":
        return self  # overwritten whole at the row's next first chunk

    def lengths(self):
        return None

    def map_tensors(self, fn) -> "CrossKV":
        return self.replace(k=fn(self.k), v=fn(self.v))


@dataclass(frozen=True)
class StateCarry:
    """Recurrent per-row state: a dict of tensors, each with the batch at
    axis 1 (layers stacked in front).  ``valid`` (b,) bool marks rows whose
    carried state belongs to a live decode: a decode step carries a row
    that is not valid through unchanged, and a reused slot resets its row
    independently of its neighbours."""

    states: dict
    valid: torch.Tensor               # (b,) bool

    @classmethod
    def create(cls, states: dict) -> "StateCarry":
        first = next(iter(states.values()))
        return cls(states=dict(states),
                   valid=torch.ones((first.shape[1],), dtype=torch.bool,
                                    device=first.device))

    def replace(self, **kw) -> "StateCarry":
        return dataclasses.replace(self, **kw)

    def slot(self, i: int) -> "StateCarry":
        """Row ``i`` as a b=1 carry whose states are VIEWS of this one's."""
        return StateCarry(states={k: a.narrow(1, i, 1) for k, a in self.states.items()},
                          valid=self.valid[i:i + 1].clone())

    def set_slot(self, i: int, sub: "StateCarry") -> "StateCarry":
        for k, a in self.states.items():
            a.narrow(1, i, 1).copy_(sub.states[k])
        valid = self.valid.clone()
        valid[i:i + 1] = sub.valid.to(valid.device)
        return self.replace(valid=valid)

    def reset_row(self, i: int) -> "StateCarry":
        for a in self.states.values():
            a.narrow(1, i, 1).zero_()
        return self.set_row_valid(i, False)

    def set_row_valid(self, i: int, flag: bool) -> "StateCarry":
        valid = self.valid.clone()
        valid[i] = bool(flag)
        return self.replace(valid=valid)

    def lengths(self):
        return None

    def map_tensors(self, fn) -> "StateCarry":
        return StateCarry(states={k: fn(a) for k, a in self.states.items()},
                          valid=fn(self.valid))


_LAYOUTS = (LinearKV, RingKV, CrossKV, StateCarry)


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


def _fields(lo) -> list:
    """A layout's tensors (None where a ``LinearKV`` has no scales) with
    the names of their fields, a ``StateCarry``'s as ``states.<key>``."""
    if isinstance(lo, StateCarry):
        return ([(f"states.{k}", a) for k, a in sorted(lo.states.items())]
                + [("valid", lo.valid)])
    return [(f.name, getattr(lo, f.name)) for f in dataclasses.fields(lo)
            if f.name != "b_axis"]


def _leaves(cache) -> list:
    """Every tensor of a composite, in a fixed order, each named by its
    layout and field (``LinearKV.k``, ``StateCarry.states.conv``)."""
    out = []
    _map_layouts(cache, lambda lo: out.extend(
        (f"{type(lo).__name__}.{name}", t) for name, t in _fields(lo)) or lo)
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
    """Row ``i`` leaves its request: cursors to zero, recurrent state zeroed
    and invalidated.  The engine calls this at admission so a reused slot
    never sees its predecessor's context."""
    return _map_layouts(cache, lambda lo: lo.reset_row(i))


def set_row_valid(cache, i: int, flag: bool):
    """Flip row ``i``'s recurrent-state validity (``StateCarry`` layouts
    only; positional layouts are already row-exact through their cursors
    and come back as they are)."""
    return _map_layouts(
        cache, lambda lo: lo.set_row_valid(i, flag) if isinstance(lo, StateCarry) else lo)


def snapshot_row(cache, i: int):
    """Host-staged COPY of slot ``i`` across every layout: the b=1 slice of
    the composite with every tensor copied to host memory, so it costs no
    device memory and later writes to the row (which land in place) never
    reach it.  It is the resume point for fault recovery and pressure
    eviction; restore with :func:`restore_row`, into the same or a
    DIFFERENT slot (row slices carry no slot identity)."""
    return _map_layouts(slot(cache, i),
                        lambda lo: lo.map_tensors(lambda t: t.to("cpu", copy=True)))


def restore_row(cache, i: int, snap):
    """Write a :func:`snapshot_row` back into slot ``i``: slabs, cursors,
    int8 scales, recurrent state and its validity all land, so the row
    resumes exactly at its snapshot point."""
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
    """Per-row context depth: the elementwise max over every positional
    layout's lengths, or None if the cache is position-free (a pure state
    carry)."""
    found = []
    _map_layouts(cache, lambda lo: found.append(lo.lengths()) or lo)
    vecs = [x for x in found if x is not None]
    if not vecs:
        return None
    out = vecs[0]
    for x in vecs[1:]:
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


def ring_write(slab: torch.Tensor, new: torch.Tensor,
               write_at: Union[int, torch.Tensor]) -> torch.Tensor:
    """Write ``new`` (b, s, kvh, hd) into the ring ``slab`` (b, C, kvh, hd)
    at absolute offset ``write_at`` (an int, or an int tensor holding a
    scalar or one offset per row), in place, and return ``slab``: position
    ``p`` lands in slot ``p % C``.  When ``s >= C`` only the last ``C``
    tokens survive (unique slots: no scatter-order hazard)."""
    b, s = new.shape[:2]
    c = slab.shape[1]
    wa = torch.as_tensor(write_at, device=slab.device).reshape(-1).long().expand(b)
    if s >= c:
        new = new[:, s - c:]
        wa = wa + (s - c)
        s = c
    idx = torch.remainder(wa[:, None] + torch.arange(s, device=slab.device), c)
    return slab.scatter_(1, idx[:, :, None, None].expand_as(new), new)


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


def conv_tail(xp: torch.Tensor, lens: torch.Tensor, width: int) -> torch.Tensor:
    """Per-row causal-conv state after consuming ``lens`` valid tokens of a
    padded chunk.  ``xp`` (b, s + width, dim) is the conv input with the
    previous state prepended; row ``r``'s new state is ``xp[r, lens[r] :
    lens[r] + width]``: ``lens = 0`` returns the old state untouched, ``lens
    = s`` the true tail."""
    b, xp_len, dim = xp.shape
    start = lens.reshape(-1).long().expand(b).clamp(0, xp_len - width)
    idx = start[:, None] + torch.arange(width, device=xp.device)
    return torch.gather(xp, 1, idx[:, :, None].expand(b, width, dim))


def token_mask(lens: Optional[torch.Tensor], s: int) -> Optional[torch.Tensor]:
    """(b, s) bool valid-token mask from per-row counts; None = all valid
    (the lockstep full-sequence path takes no masking at all)."""
    if lens is None:
        return None
    return torch.arange(s, device=lens.device)[None, :] < lens.reshape(-1, 1)
