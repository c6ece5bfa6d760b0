"""K1, the flash-attention forward: online-softmax attention that emits the
output and the f32 log-sum-exp.

Replaces ``src/repro/kernels/flash_attention.py:_flash_kernel`` (launched by
``_fwd_call``, entry ``flash_attention``).  The kernel is
``csrc/flash_attention.cu``, CUDA C++ for ``sm_90a``; its header says what
bounds it on the H100 (bytes) and what the design does about it (one pass
over each row's valid KV prefix, dead tiles skipped, no copy of the head
fold or of a GQA repeat).

Contract, as the JAX kernel's, in the model's layout:

* ``q`` ``(b, sq, h, hd)``; ``k``, ``v`` ``(b, sk, kvh, hd)`` with ``kvh``
  dividing ``h``, read through their strides (unit stride on ``hd``).
  Query head ``hi`` of batch row ``bi`` attends KV head ``hi // (h // kvh)``:
  the JAX fold ``b_ = bi * h + hi`` with head = kv_head * n_rep + rep.
* ``q_offset`` places query row ``i`` at position ``q_offset + i`` (keys at
  ``0 .. sk-1``); ``kv_len`` masks keys at positions ``>= kv_len``.  Each is
  ``None`` (0 and ``sk``) or an int32 tensor of ``rows`` entries, ``rows``
  dividing ``b``: lane ``bi // (b // rows)`` (the JAX ``(rows,)`` lanes,
  whose lane is ``b_ // (bh // rows)``).  On the card they stay on the
  device, so no decode step waits on the host.
* ``causal``, and ``window > 0`` keeps keys with ``k_pos > q_pos - window``.
* The scale is ``1/sqrt(hd)``.  A query row with no visible key, and every
  row of a ``kv_len == 0`` lane, gives exact zeros.
* Returns ``(out, lse)``: ``out`` ``(b, sq, h, hd)`` in ``q``'s dtype, ``lse``
  f32 ``(b, h, sq)`` (the JAX kernel's ``(bh, sq)``).

A tensor on the CPU takes :func:`flash_attention_ref`, the plain version; a
CUDA tensor launches the kernel (``hd`` in 16, 32, 64, 128) or raises.
``flash_attention.launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, q_offset, kv_len):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; expected (b, s, heads, hd)")
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2] != 0:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)} (same b and hd, kv heads dividing h)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    for name, x in (("q_offset", q_offset), ("kv_len", kv_len)):
        if x is None:
            continue
        if x.dtype != torch.int32 or x.device != q.device:
            raise TypeError(f"flash_attention: {name} must be int32 on {q.device}, "
                            f"got {x.dtype} on {x.device}")
        if x.dim() > 1 or x.numel() == 0 or b % x.numel() != 0:
            raise ValueError(f"flash_attention: {name} of shape {tuple(x.shape)}; "
                             f"expected a scalar or (rows,) with rows dividing b={b}")
    for x in (q, k, v):
        if x.device != q.device:
            raise ValueError("flash_attention: q, k, v on different devices")


def _per_batch(x: Optional[torch.Tensor], b: int, default: int, device) -> torch.Tensor:
    """A lane vector fanned out to one entry per batch row."""
    if x is None:
        return torch.full((b,), default, dtype=torch.int64, device=device)
    x = x.reshape(-1).long()
    return x.repeat_interleave(b // x.numel())


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset=None, kv_len=None):
    """Plain version of :func:`flash_attention`, in f32, with the same
    contract (the port's twin of ``repro.kernels.ref.flash_attention_ref``,
    in the unfolded layout, also returning the lse)."""
    _check(q, k, v, q_offset, kv_len)
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    n_rep = h // kvh
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(b, sq, kvh, n_rep, hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * scale
    qp = (_per_batch(q_offset, b, 0, q.device)[:, None]
          + torch.arange(sq, device=q.device))[:, :, None]          # (b, sq, 1)
    kp = torch.arange(sk, device=q.device)[None, None, :]          # (1, 1, sk)
    ok = (kp < _per_batch(kv_len, b, sk, q.device)[:, None, None]).expand(b, sq, sk)
    if causal:
        ok = ok & (kp <= qp)
    if window > 0:
        ok = ok & (kp > qp - window)
    ok = ok[:, None, None]                                         # (b,1,1,sq,sk)
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
    l_safe = p.sum(dim=-1).clamp_min(1e-30)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p / l_safe[..., None], v.float())
    lse = (m + torch.log(l_safe)).reshape(b, h, sq)
    return out.reshape(b, sq, h, hd).to(q.dtype), lse


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                       L, L, L, L, L, L, L, L, L, I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: Optional[torch.Tensor] = None,
                    kv_len: Optional[torch.Tensor] = None):
    """Attention forward; returns ``(out, lse)``.  See the module docstring."""
    _check(q, k, v, q_offset, kv_len)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: q, k, v need unit stride on head_dim")
    # one lane count for both vectors: a scalar beside a (rows,) vector fans out
    rows = max(1 if x is None else x.numel() for x in (q_offset, kv_len))
    lanes = [None if x is None else x.reshape(-1).expand(rows).contiguous()
             for x in (q_offset, kv_len)]
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(),
                 *(None if x is None else x.data_ptr() for x in lanes),
                 rows, b, sq, sk, h, kvh, hd,
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 int(causal), int(window), _DTYPE_CODES[q.dtype], stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0
