"""Mixture-of-Experts FFN with *gapped* capacity dispatch: the counterpart
of ``repro/models/moe_layer.py``.

Each expert's token slab is padded to a multiple of the gapping quantum
(``SUBLANE`` = 8 rows), so no two experts' slabs share a tile, and the
dispatch offsets come from a prefix sum.  Capacity is per call
(:func:`gapped_capacity` of the call's rows): tokens past an expert's
capacity are dropped, exactly as in JAX, so the port routes every row JAX
routes (idle engine slots and padding included) in the same order.

Two dispatch implementations, as in JAX:

* ``sort``: argsort by expert id, gathers into the (E, C, d) slabs, the
  three expert products (each ONE batched K2 launch through
  ``common.expert_project``), a gather back;
* ``onehot``: the dense one-hot dispatch einsum, the reference.

The index math (the stable argsort, the per-expert counts as a segment sum,
the prefix sum, the gathers) and the router's f32 ``(N, d) @ (d, E)``
product stay plain PyTorch: JAX computes them outside any Pallas kernel
too.  None of it reads a value back to the host (the counts are a
``scatter_add``, not ``torch.bincount``, which sizes its output from the
data), so a decode step stays capturable in a CUDA graph.  Ties in the router keep JAX's order: ``lax.top_k``
puts the lower expert first, so the top k come from a stable descending
sort.  The sharding hints (``constrain``) have no counterpart on one
device.  ``aux=False`` skips the load-balance term where the caller drops
it (serving), as XLA drops the unused value from the JAX step.

In training the expert products' backward is the batched K2's (two
launches a product, ``strassen_matmul._Matmul``), and the gathers' backward
is a float ``scatter_add`` that sums each token's expert contributions by
atomics on the card, in no fixed order: the card's MoE gradients repeat
only to a tolerance.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

SUBLANE = 8  # f32 sublane tile; the 'gap' quantum


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def gapped_capacity(n_tokens: int, n_experts: int, k: int, capacity_factor: float) -> int:
    c = int(-(-n_tokens * k * capacity_factor // n_experts))  # ceil
    return max(round_up(c, SUBLANE), SUBLANE)


def _segment_count(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` of ones: how many entries of ``idx`` hold
    each value in [0, n), without a host read."""
    flat = idx.reshape(-1)
    return torch.zeros(n, dtype=torch.long, device=idx.device).scatter_add_(
        0, flat, torch.ones_like(flat))


def router(x: torch.Tensor, w_router: torch.Tensor, k: int, *, aux: bool = True):
    """x: (N, d); returns (weights (N, k) f32, experts (N, k) int64, aux
    loss: an f32 scalar, or None when ``aux`` is False)."""
    logits = x.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k's order: descending, the lower expert first on ties
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    if not aux:
        return top_p, top_e, None
    # load-balance auxiliary loss (Switch-style)
    n_experts = w_router.shape[-1]
    me = probs.mean(dim=0)  # (E,)
    ce = _segment_count(top_e, n_experts).float() / x.shape[0]
    return top_p, top_e, n_experts * (me * ce).sum()


def expert_ffn(h, e_gate, e_up, e_down):
    """h: (E, C, d); expert weights (E, d, f) / (E, f, d).  Each product is
    one ``common.expert_project`` dispatch."""
    from repro_torch.models import common

    g = common.expert_project(h, e_gate)
    u = common.expert_project(h, e_up)
    a = F.silu(g.float()).to(h.dtype) * u
    return common.expert_project(a, e_down)


def moe_ffn_sort(x, w_router, e_gate, e_up, e_down, *, k: int, capacity_factor: float,
                 n_groups: int = 1, aux: bool = True):
    """Sort-based gapped dispatch (JAX ``moe_layer.py:62-138``).

    ``n_groups`` partitions the tokens into independent dispatch groups,
    each with its own gapped capacity; a count that does not divide the
    rows falls back to one group, as in JAX.  x: (N, d) -> (y (N, d), aux).
    """
    n, d = x.shape
    n_experts = e_gate.shape[0]
    if n % n_groups != 0 or n_groups < 1:
        n_groups = 1
    g = n_groups
    nl = n // g  # tokens per group
    cap = gapped_capacity(nl, n_experts, k, capacity_factor)
    dev = x.device

    top_p, top_e, aux_loss = router(x, w_router, k, aux=aux)  # (N, k)
    flat_e = top_e.reshape(g, nl * k)
    flat_p = top_p.reshape(g, nl * k)

    # per-group dispatch indices: slot_src (g, E*cap), the source flat entry
    # of each expert slot (sentinel nl*k = padding); dest (g, nl*k), the slot
    # of each flat entry (sentinel E*cap = dropped)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(1, order)
    group_of = torch.arange(g, device=dev)[:, None] * n_experts
    counts = _segment_count(flat_e + group_of, g * n_experts).reshape(g, n_experts)
    offsets = torch.cumsum(counts, dim=-1) - counts  # exclusive prefix sum
    rank = torch.arange(nl * k, device=dev) - offsets.gather(1, se)
    dest_sorted = torch.where(rank < cap, se * cap + rank, n_experts * cap)
    # slot -> sorted position -> original flat entry; duplicates land only in
    # the sentinel slot, which is cut off
    slot_src = torch.full((g, n_experts * cap + 1), nl * k, dtype=torch.long, device=dev)
    slot_src = slot_src.scatter(1, dest_sorted, order)[:, :n_experts * cap]
    # original flat entry -> slot (order is a permutation: one writer each)
    dest = torch.empty_like(dest_sorted).scatter_(1, order, dest_sorted)

    # data plane: gathers only.  Flat entry i is token i // k
    xg = x.reshape(g, nl, d)
    tok_of_slot = torch.clamp(slot_src // k, max=nl - 1)
    pad_mask = (slot_src >= nl * k)[..., None]
    h = xg.gather(1, tok_of_slot[..., None].expand(-1, -1, d))
    h = torch.where(pad_mask, torch.zeros((), dtype=h.dtype, device=dev), h)
    h = h.reshape(g, n_experts, cap, d)

    y_e = expert_ffn(h, e_gate, e_up, e_down)

    y_flat = torch.cat([y_e.reshape(g, n_experts * cap, d),
                        torch.zeros((g, 1, d), dtype=y_e.dtype, device=dev)], dim=1)
    contrib = y_flat.gather(1, dest[..., None].expand(-1, -1, d))  # (g, nl*k, d)
    contrib = contrib.reshape(g, nl, k, d) * flat_p.reshape(g, nl, k, 1).to(contrib.dtype)
    y = contrib.sum(dim=2).reshape(n, d)
    return y.to(x.dtype), aux_loss


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def moe_ffn_onehot(x, w_router, e_gate, e_up, e_down, *, k: int, capacity_factor: float,
                   aux: bool = True):
    """Reference dense one-hot dispatch (JAX ``moe_layer.py:141-159``; the
    oracle of the tests, tiny shapes only)."""
    n, d = x.shape
    n_experts = e_gate.shape[0]
    cap = gapped_capacity(n, n_experts, k, capacity_factor)

    top_p, top_e, aux_loss = router(x, w_router, k, aux=aux)
    # position of token within each expert's buffer
    sel = _one_hot(top_e, n_experts, torch.int32).sum(dim=1)  # (N, E) 0/1
    pos = torch.cumsum(sel, dim=0) - 1  # (N, E) rank within expert
    keep = (sel > 0) & (pos < cap)
    disp = (keep[:, :, None] & (_one_hot(pos, cap, torch.int32) > 0)).to(x.dtype)
    h = torch.einsum("nec,nd->ecd", disp, x)
    y_e = expert_ffn(h, e_gate, e_up, e_down)
    weight_ne = torch.zeros((n, n_experts), dtype=torch.float32, device=x.device)
    weight_ne = weight_ne.scatter_add(1, top_e, top_p)
    y = torch.einsum("nec,ecd->nd", disp.float() * weight_ne[:, :, None], y_e.float())
    return y.to(x.dtype), aux_loss


def moe_ffn(x, w_router, e_gate, e_up, e_down, *, k: int, capacity_factor: float,
            dispatch: str = "sort", n_groups: int = 1, aux: bool = True):
    """``dispatch`` selects the token-dispatch algorithm (``"sort"``, the
    production path, or ``"onehot"``, the reference) -- an algorithm
    choice, not a kernel backend.  Returns (y (N, d), aux loss or None)."""
    if dispatch == "sort":
        return moe_ffn_sort(x, w_router, e_gate, e_up, e_down, k=k,
                            capacity_factor=capacity_factor, n_groups=n_groups, aux=aux)
    return moe_ffn_onehot(x, w_router, e_gate, e_up, e_down, k=k,
                          capacity_factor=capacity_factor, aux=aux)
