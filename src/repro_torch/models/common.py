"""Shared model blocks on the serving and training paths: the counterpart
of the main-path subset of ``repro/models/common.py``.

Every matrix product and every attention call goes through the kernel
registry's ``dispatch``, as the JAX models do: on a CUDA tensor the
``matmul`` op runs K2 (or K4 for a square product past the planner's
cutoff), forward and backward, the MoE experts' products one batched K2
launch each (forward only), and the ``attention`` op K1
forward and K3 backward, or K1q over an int8 cache; on a CPU tensor each
runs its plain version.  A policy that asks for a plain version on the card
raises (``registry.route``).  The JAX package's jnp routes (dense,
blockwise, banded attention, einsum projections) have no counterpart.  The
int8 cache's scales and quantizer (``kv_scale``, ``quantize_kv``) are
bit-equal to JAX's.  Norms, RoPE and the SwiGLU gate keep the JAX numerics:
f32 inside, cast back to the activation dtype.

On a mesh of more than one rank the blocks here read the
:class:`~repro_torch.core.planner.Placement` of the weight they are given
(``planner.place`` tags each block) and insert the collectives around the
registry's kernels (``core/collectives.py``): each weight is all-gathered
over the FSDP axis before use (its gradient comes back reduce-scattered);
a product whose output columns are split over the tensor-parallel axis is
column-parallel (its input enters through ``copy_to``), one whose
contraction rows are split is row-parallel (its f32 partial sums leave
through an all-reduce); the embedding and the tied head split the
vocabulary (a masked lookup summed over ranks; logits of this rank's
columns; a vocabulary-parallel log-sum-exp and target pick); a replicated
weight whose work is split over an axis gets its gradient all-reduced
over it.
A model keeps no rank and no world size: the blocks read the weights.
Without a placement every block runs exactly as on one device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import collectives, planner, sharding_hints
from repro_torch.kernels import policy, registry
from repro_torch.models import cache as dcache


# ---------------------------------------------------------------------------
# initialization helpers
# ---------------------------------------------------------------------------

def param(*shape, dtype, device) -> nn.Parameter:
    """An uninitialised parameter of ``shape``: a model's ``init`` (or a
    loaded state dict) fills it."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def dense_init(t: torch.Tensor, generator: torch.Generator,
               scale: Optional[float] = None) -> torch.Tensor:
    """Fill ``t`` in place with the JAX ``dense_init`` distribution: a
    standard normal truncated to [-2, 2], times ``scale`` (default
    1/sqrt(fan-in)), drawn in f32 and cast to ``t``'s dtype.  A block of a
    sharded tensor draws the whole tensor, in the same order as on one
    device, and keeps its own block, so the sharded model is bit-equal to
    the one-device model."""
    pl = planner.placement(t)
    shape = tuple(t.shape) if pl is None else pl.full
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    f = torch.empty(shape, dtype=torch.float32, device=t.device)
    torch.nn.init.trunc_normal_(f, 0.0, 1.0, -2.0, 2.0, generator=generator)
    f.mul_(std)
    return t.copy_(f if pl is None else pl.cut(f))


# ---------------------------------------------------------------------------
# sharded weights
# ---------------------------------------------------------------------------

def _tp_axis(pl) -> Optional[str]:
    """The tensor-parallel axis a placement's mesh names, where it has
    more than one rank."""
    tp = planner.axes_for(pl.mesh).tp
    return tp if collectives.axis_size(pl.mesh, tp) > 1 else None


def tp_dim(w: torch.Tensor) -> Optional[int]:
    """The dim of ``w`` split over the tensor-parallel axis (None: ``w`` is
    whole over it, or not sharded)."""
    pl = planner.placement(w)
    tp = None if pl is None else _tp_axis(pl)
    return None if tp is None else pl.dim_of(tp)


def tp_axes(w: torch.Tensor) -> tuple:
    """``(tensor-parallel axis,)`` where it splits ``w``, else ``()``: the
    ``split`` of a replicated weight that acts on ``w``'s output block
    (qk-norm on the local heads)."""
    return () if tp_dim(w) is None else (_tp_axis(planner.placement(w)),)


def weight(w: torch.Tensor, keep: Optional[int] = None, split: tuple = ()) -> torch.Tensor:
    """``w`` as its product uses it: all-gathered over every mesh axis it is
    split over but the tensor-parallel split of dim ``keep``.  Its gradient
    is summed over each data axis and each axis of ``split`` that the work
    is split over and ``w`` is whole along (``copy_to``); over the axes it
    was gathered on it comes back reduce-scattered.  ``w`` itself without a
    placement."""
    pl = planner.placement(w)
    if pl is None:
        return w
    mesh, tp = pl.mesh, _tp_axis(pl)
    held = pl.split_axes()
    for a in held:
        dim = pl.dim_of(a)
        if not (a == tp and dim == keep):
            w = collectives.all_gather(w, mesh, a, dim)
    work = tuple(a for a in planner.axes_for(mesh).dp) + tuple(split)
    red = tuple(a for a in work if a not in held and collectives.axis_size(mesh, a) > 1)
    return collectives.copy_to(w, mesh, red) if red else w


def kept_width(w: torch.Tensor, dim: int) -> int:
    """The extent of ``w``'s dim ``dim`` after :func:`weight` gathers it:
    this rank's block of it where the tensor-parallel axis splits it, else
    the whole."""
    pl = planner.placement(w)
    if pl is None:
        return w.shape[dim]
    return pl.shape[dim] if tp_dim(w) == dim else pl.full[dim]


def vocab_block(table: torch.Tensor):
    """``(mesh, axis, offset)`` of this rank's rows of an embedding table
    (V, d) whose vocabulary is split over the tensor-parallel axis, else
    None."""
    if tp_dim(table) != 0:
        return None
    pl = planner.placement(table)
    return pl.mesh, _tp_axis(pl), pl.offset(0)


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``embed[tokens]``.  Over a vocabulary split over the tensor-parallel
    axis each rank looks up the tokens in its rows (zeros elsewhere) and
    the rows are summed over the axis: one rank holds each token, so the
    sum is exact (JAX gathers the vocabulary first, ``common.py:42``)."""
    block = vocab_block(embed)
    table = weight(embed, keep=0)
    if block is None:
        return table[tokens]
    mesh, axis, off = block
    local = tokens.long() - off
    mine = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                          device=rows.device))
    return collectives.reduce_from(rows, mesh, axis)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm scaling by ``1 + weight`` (zero-initialised weights), in f32."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * (1.0 + weight.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (half-split, not interleaved)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of the RoPE angles for ``positions`` (..., seq), shaped
    (..., seq, 1, head_dim / 2) to broadcast over heads.  Computed once per
    step and shared by every layer with the same theta."""
    inv = rope_freqs(head_dim, theta, positions.device)
    ang = positions[..., :, None].float() * inv
    return torch.cos(ang)[..., :, None, :], torch.sin(ang)[..., :, None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Apply precomputed RoPE angles to x (..., seq, heads, head_dim) in f32,
    cast back to x's dtype."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# attention and projections: the kernel route
# ---------------------------------------------------------------------------

def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              q_offset: Optional[torch.Tensor] = None,
              kv_len: Optional[torch.Tensor] = None,
              k_scale: Optional[torch.Tensor] = None,
              v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (b, sq, h, hd) against k, v (b, sk, kvh, hd) at their native head
    count, through the registry's ``attention`` op.  Fresh self-attention
    passes no ``q_offset``/``kv_len``; attention over a cache passes each
    row's position and valid length as int32 device tensors (scalar or
    (b,)).  Differentiable in q, k, v (K3 backward); without a gradient to
    record it launches the forward kernel alone.  ``k_scale``/``v_scale``
    (f32 (b, kvh)) go with an int8 k/v: K1q dequantizes them at its block
    load, forward only, as the JAX kernel's quantized path."""
    return registry.dispatch("attention", q, k, v, causal=causal,
                             window=window, q_offset=q_offset, kv_len=kv_len,
                             k_scale=k_scale, v_scale=v_scale)


def cached_self_attention(q, k, v, cache=None, li=None, write_at=None, q_offset=None,
                          kv_len=None, chunked: bool = False) -> torch.Tensor:
    """Causal self-attention of fresh q/k/v (the encoder-decoder's and the
    VLM's).  With a ``LinearKV`` ``cache`` the fresh k/v are first written
    into layer ``li``'s slabs at ``write_at``; decode (one query row) and
    continuation chunks (``chunked``) then attend the cache through the
    lanes ``q_offset``/``kv_len``, prefill and first chunks their fresh
    k/v, as training does."""
    if cache is not None:
        kc, vc = cache.k[li], cache.v[li]
        dcache.linear_write(kc, k, write_at)
        dcache.linear_write(vc, v, write_at)
        if q.shape[1] == 1 or chunked:
            return attention(q, kc, vc, causal=True, q_offset=q_offset, kv_len=kv_len)
    return attention(q, k, v, causal=True)


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ w (d, f) -> (..., f) through the registry's ``matmul``
    op: the leading dims fold into the rows of one product.  A ``w`` whose
    output columns are split over the tensor-parallel axis makes the
    product column-parallel (``x`` enters through ``copy_to``, the output
    holds this rank's columns); one whose rows are split makes it
    row-parallel (``x`` holds this rank's part of the contraction; one
    classical K2 call writes its partial sums in f32, they are all-reduced
    over the axis in f32 and rounded to ``x``'s dtype once, as the one
    device's K2 rounds its f32 sums once)."""
    lead = x.shape[:-1]
    pl = planner.placement(w)
    if pl is None:
        out = registry.dispatch("matmul", x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*lead, w.shape[-1])
    tp = tp_dim(w)
    if tp == w.dim() - 1:
        x = collectives.copy_to(x, pl.mesh, _tp_axis(pl))
    ww = weight(w, keep=tp)
    if tp != w.dim() - 2:
        out = registry.dispatch("matmul", x.reshape(-1, x.shape[-1]), ww)
        return out.reshape(*lead, ww.shape[-1])
    out = registry.dispatch("matmul", x.reshape(-1, x.shape[-1]), ww, backend="classical",
                            out_dtype=torch.float32)
    out = collectives.reduce_from(out.reshape(*lead, ww.shape[-1]), pl.mesh, _tp_axis(pl))
    return out.to(x.dtype)


def qkv_project(x, wq, wk, wv):
    """The attention block's input projections (JAX ``common.py:610``).
    Under the matmul op's ``qkv_fused`` variant (``--impl
    'matmul=pallas:qkv_fused=true'`` or ``RunOptions.fused_qkv``) the three
    collapse into ONE product over ``cat([wq, wk, wv], 1)``, one K2 launch
    streaming ``x`` once instead of three, split back into views; the
    weights are concatenated per call, as in JAX (on a sharded mesh, this
    rank's columns of each, after the FSDP gather).  Without it, three
    :func:`project` calls."""
    if policy.current().variant_for("matmul").get("qkv_fused"):
        ws = [weight(w, keep=tp_dim(w)) for w in (wq, wk, wv)]
        pl = planner.placement(wq)
        if tp_dim(wq) == 1:
            x = collectives.copy_to(x, pl.mesh, _tp_axis(pl))
        lead = x.shape[:-1]
        fused = registry.dispatch("matmul", x.reshape(-1, x.shape[-1]),
                                  torch.cat(ws, dim=1)).reshape(*lead, -1)
        return fused.split([w.shape[1] for w in ws], dim=-1)
    return project(x, wq), project(x, wk), project(x, wv)


def attn_out_project(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(b, s, h, hd) heads -> (b, s, d); the head fold into the contraction
    is a view of the kernel's contiguous output.  Over this rank's heads
    (``wo``'s rows split over the tensor-parallel axis) the product is
    row-parallel (:func:`project`)."""
    b, s, h, hd = o.shape
    return project(o.reshape(b, s, h * hd), wo)


def expert_project(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-expert product h (..., E, C, d) @ w (E, d, f) -> (..., E, C, f),
    the MoE experts' FFN products (JAX ``common.py:648-659``): ONE
    ``matmul`` dispatch of (E, rows, d) @ (E, d, f), a batched K2 launch on
    the card, as Pallas batching makes the JAX expert axis one more grid
    dimension.  Leading dims fold into each expert's rows (a copy only when
    there are some, under ``moe_groups`` > 1), in the order the JAX vmap of
    :func:`project` gives them."""
    e, c, d = h.shape[-3:]
    lead = h.shape[:-3]
    if math.prod(lead) == 1:
        out = registry.dispatch("matmul", h.reshape(e, c, d), w)
        return out.reshape(*lead, e, c, w.shape[-1])
    hh = h.movedim(-3, 0).reshape(e, -1, d)
    out = registry.dispatch("matmul", hh, w)
    return out.reshape(e, *lead, c, w.shape[-1]).movedim(0, -3)


def gated_mlp(x, w_gate, w_up, w_down):
    """SwiGLU MLP: silu in f32, cast back, times the up projection; the
    three products dispatch through :func:`project` (column-parallel
    gate and up, row-parallel down on a sharded mesh)."""
    g = project(x, w_gate)
    u = project(x, w_up)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return project(h, w_down)


def logits_matmul(h: torch.Tensor, embed_out: torch.Tensor) -> torch.Tensor:
    """h (..., d) @ embed_out (V, d)ᵀ: computed in the activation dtype, as
    the JAX kernel route does, then cast to f32.  ``embed_out.T`` is a view;
    the kernel reads the table in place.  Over a vocabulary split over the
    tensor-parallel axis the logits are this rank's columns
    (:func:`vocab_block` gives their offset)."""
    block = vocab_block(embed_out)
    if block is not None:
        h = collectives.copy_to(h, block[0], block[1])
    table = weight(embed_out, keep=0)
    lead = h.shape[:-1]
    out = registry.dispatch("matmul", h.reshape(-1, h.shape[-1]), table.T)
    return out.reshape(*lead, table.shape[0]).float()


@torch.no_grad()
def greedy(logits: torch.Tensor, embed_out: torch.Tensor) -> torch.Tensor:
    """The greedy tokens (int32) of ``logits`` from :func:`logits_matmul`
    over ``embed_out``: the first maximum, over a split vocabulary the
    lowest global index among the ranks' maxima (``jnp.argmax``)."""
    block = vocab_block(embed_out)
    if block is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return collectives.argmax(logits, *block).to(torch.int32)


@torch.no_grad()
def whole_vocab(logits: torch.Tensor, embed_out: torch.Tensor) -> torch.Tensor:
    """``logits`` over the whole vocabulary: the ranks' columns gathered
    where :func:`logits_matmul` split them, else ``logits``."""
    block = vocab_block(embed_out)
    if block is None:
        return logits
    return collectives.all_gather_rows(logits.movedim(-1, 0), block[0], block[1]) \
        .movedim(0, -1).contiguous()


# ---------------------------------------------------------------------------
# quantized KV cache (the attention kv_dtype variant)
# ---------------------------------------------------------------------------

def kv_cache_dtype(default: torch.dtype) -> tuple[torch.dtype, bool]:
    """The serving KV-cache dtype under the current policy: the attention
    ``kv_dtype`` variant (``--impl 'attention=pallas:kv_dtype=int8'``)
    selects the int8 cache; anything else keeps ``default``.  Returns
    ``(dtype, quantized)``."""
    name = policy.current().variant_for("attention").get("kv_dtype")
    if name in ("int8", "i8"):
        return torch.int8, True
    return default, False


def kv_scale(x: torch.Tensor, valid=None) -> torch.Tensor:
    """Per-(batch, kv_head) symmetric int8 scale of a (b, s, kvh, hd) k or v
    slab: absmax / 127, floored at 1e-8 so an all-zero head still divides
    cleanly.  ``valid`` (an int, or an int tensor holding a scalar or one
    count per row) restricts the absmax to the first ``valid`` positions,
    so the pad of a zero-padded chunk never widens the scales."""
    ax = x.float().abs()
    if valid is not None:
        v = torch.as_tensor(valid, device=x.device)
        v = v.reshape(-1, 1, 1, 1) if v.dim() == 1 else v
        ok = torch.arange(x.shape[1], device=x.device)[None, :, None, None] < v
        ax = torch.where(ok, ax, 0.0)
    return (ax.amax(dim=(1, 3)) / 127.0).clamp_min(1e-8)


def quantize_kv(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize a (b, s, kvh, hd) slab to int8 with the per-(b, kvh)
    ``scale``: round half to even (as ``jnp.round``), clipped to ±127."""
    q = torch.round(x.float() / scale[:, None, :, None])
    return q.clamp(-127, 127).to(torch.int8)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _xent_chunk(h, embed_out, labels):
    """(sum of the chunk's nll, count of its labels >= 0), both f32.  Over
    a vocabulary split over the tensor-parallel axis the log-sum-exp takes
    the ranks' maximum and sums their exponentials, and the target's logit
    is picked by the rank that holds it and summed over the axis."""
    logits = logits_matmul(h, embed_out)
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    block = vocab_block(embed_out)
    if block is None:
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, safe[..., None])[..., 0]
    else:
        mesh, axis, off = block
        top = collectives.all_max(logits.detach().amax(dim=-1), mesh, axis)
        sumexp = torch.exp(logits - top[..., None]).sum(dim=-1)
        lse = torch.log(collectives.reduce_from(sumexp, mesh, axis)) + top
        local = safe - off
        mine = (local >= 0) & (local < logits.shape[-1])
        at = logits.gather(-1, local.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
        picked = collectives.reduce_from(torch.where(mine, at, 0.0), mesh, axis)
    nll = torch.where(valid, lse - picked, 0.0)
    return nll.sum(), valid.sum(dtype=torch.float32)


def chunked_softmax_xent(hidden, embed_out, labels, *, chunk: int = 512):
    """Mean cross-entropy of ``hidden`` (b, s, d) against the tied table
    ``embed_out`` (V, d), the counterpart of JAX ``chunked_softmax_xent``
    (``common.py:692-725``): the sequence is cut into chunks (one chunk when
    ``chunk`` does not divide it) and each chunk is checkpointed, so its
    f32 (b, chunk, V) logits never outlive it.  Labels < 0 (the -100 pad)
    are masked.  Returns ``sum(nll) / max(count, 1)``, an f32 scalar.
    Where the bound rules split the batch over data axes
    (``sharding_hints.split_axes("batch")``) the sum and the count are
    summed over them first, so every rank returns the global mean."""
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    if s % chunk != 0:
        chunk = s
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, chunk):
        t, c = checkpoint(_xent_chunk, hidden[:, i:i + chunk], embed_out,
                          labels[:, i:i + chunk], use_reentrant=False,
                          preserve_rng_state=False)
        tot, cnt = tot + t, cnt + c
    axes = sharding_hints.split_axes("batch")
    if axes is not None:
        mesh = sharding_hints.current()["mesh"]
        tot = collectives.reduce_from(tot, mesh, axes)
        cnt = collectives.all_sum(cnt, mesh, axes)
    return tot / cnt.clamp_min(1.0)
