"""K1, the flash-attention forward: online-softmax attention that emits the
output and the f32 log-sum-exp; K1q, the same over an int8 KV cache; and
K3, the backward.

Replaces ``src/repro/kernels/flash_attention.py:_flash_kernel`` (launched by
``_fwd_call``, entry ``flash_attention``).  The kernel is
``csrc/flash_attention.cu``, CUDA C++ for ``sm_90a``; its header says what
bounds it on the H100 (latency at the training shape, bytes in decode) and
what the design does about it (one pass over each row's valid KV prefix,
dead tiles skipped, no copy of the head fold or of a GQA repeat, a KV
head's query heads sharing each K/V tile).

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

K1q, :func:`flash_attention_int8`, replaces the same kernel with
``quantized=True`` (``flash_attention.py:141-169``, operands ``:356-358``):
``k``/``v`` are int8 with f32 scales per (batch row, KV head), ``k_scale``
and ``v_scale`` of shape ``(b, kvh)``.  It is forward only, as the TPU
kernel is.  :func:`flash_attention` takes the scales too and hands an int8
call to it; int8 ``k``/``v`` need both scales, and scales need int8
``k``/``v``.

K3, :func:`flash_attention_bwd`, replaces ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` (launched by ``_bwd_call``) with
``csrc/flash_attention_bwd.cu``: from the forward's ``out`` and ``lse`` and
the output's gradient it recomputes the probabilities and returns ``(dq, dk,
dv)``, ``dk``/``dv`` at the native ``kvh`` with the GQA group already summed.
:class:`FlashAttention` ties the two together as the counterpart of
``_flash_fn``'s custom VJP.  :func:`attention` (output only, K1q for int8
``k``/``v``) and :func:`attention_ref` are the registry's ``attention``
kernel entry and oracle.

A tensor on the CPU takes the plain version (:func:`flash_attention_ref`,
:func:`flash_attention_bwd_ref`); a CUDA tensor launches the kernel (``hd``
in 16, 32, 64, 128, 256) or raises.  Each kernel has two instances, picked by
the dtype of ``q`` (:func:`fwd_path`, :func:`bwd_path`).  bf16 ``q`` runs
on the tensor cores ("mma": ``mma.sync`` with f32 accumulation): K1 rounds
P to bf16 where it feeds P V; K1q widens its int8 tiles exactly in shared
memory (K to bf16, V to f16), folds the scales into S and O with one
multiply each (``S = (q·k_int)·(k_scale/√hd)``, ``O = (P·v_int)·v_scale/l``;
the JAX kernel dequantizes first, ``k * k_scale``, and the two orders differ
by f32 rounding), rounds P to f16 where it feeds P V, and in decode splits
the keys over the warps of each query head and over a thread-block cluster
that :func:`kv_splits` plans; K3 feeds P and dS to its products as hi + lo bf16
pairs (16 bits) and forms delta = rowsum(dO * O) in its dq pass.  f32 ``q``
runs the FMA template ("fma", f32 throughout, K1q dequantizing at the block
load in the JAX order, delta from this wrapper), which the f32 gates
(identical card and CPU tokens) need.  The mma instances stage tiles with
16-byte copies, so they raise on a ``q``/``k``/``v`` whose pointer is not
16-byte aligned or whose (batch, seq, head) strides are not whole 16-byte
steps (8 bf16 or 16 int8 elements); no model path makes one (``out`` and
the gradient are copied when they are not so).

``flash_attention.launches`` (K1), ``flash_attention_int8.launches`` (K1q)
and ``flash_attention_bwd.launches`` (K3) count the kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, q_offset, kv_len, k_scale=None, v_scale=None):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; expected (b, s, heads, hd)")
    b, _, h, hd = q.shape
    kvh = k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or h % kvh != 0:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)} (same b and hd, kv heads dividing h)")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("flash_attention: k_scale and v_scale must be passed together")
    quantized = k_scale is not None
    if q.dtype not in _DTYPE_CODES or k.dtype != v.dtype or (
            k.dtype != (torch.int8 if quantized else q.dtype)):
        want = "int8" if quantized else "the dtype of q"
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype} "
                        f"with{'' if quantized else 'out'} scales; expected q in "
                        f"float32 or bfloat16 and k, v in {want}")
    if quantized:
        for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
            if x.shape != (b, kvh) or x.dtype != torch.float32 or x.device != q.device:
                raise ValueError(f"flash_attention: {name} {tuple(x.shape)} {x.dtype} on "
                                 f"{x.device}; expected float32 {(b, kvh)} on {q.device}")
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


def _visible(b, sq, sk, causal, window, q_offset, kv_len, device):
    """(b, 1, 1, sq, sk) bool: which keys each query row sees, broadcasting
    over the (kv head, rep) axes of the grouped scores."""
    qp = (_per_batch(q_offset, b, 0, device)[:, None]
          + torch.arange(sq, device=device))[:, :, None]            # (b, sq, 1)
    kp = torch.arange(sk, device=device)[None, None, :]            # (1, 1, sk)
    ok = (kp < _per_batch(kv_len, b, sk, device)[:, None, None]).expand(b, sq, sk)
    if causal:
        ok = ok & (kp <= qp)
    if window > 0:
        ok = ok & (kp > qp - window)
    return ok[:, None, None]


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset=None, kv_len=None, k_scale=None, v_scale=None):
    """Plain version of :func:`flash_attention` and of K1q, in f32, with the
    same contract (the port's twin of ``repro.kernels.ref.flash_attention_ref``,
    in the unfolded layout, also returning the lse).  An int8 ``k``/``v`` is
    dequantized up front, ``k.float() * k_scale``, as the JAX oracle does
    (``ref.py:48-53``)."""
    _check(q, k, v, q_offset, kv_len, k_scale, v_scale)
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    n_rep = h // kvh
    scale = 1.0 / math.sqrt(hd)
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf = kf * k_scale[:, None, :, None]
        vf = vf * v_scale[:, None, :, None]
    qg = q.float().reshape(b, sq, kvh, n_rep, hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kf) * scale
    ok = _visible(b, sq, sk, causal, window, q_offset, kv_len, q.device)
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
    l_safe = p.sum(dim=-1).clamp_min(1e-30)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p / l_safe[..., None], vf)
    lse = (m + torch.log(l_safe)).reshape(b, h, sq)
    return out.reshape(b, sq, h, hd).to(q.dtype), lse


def flash_attention_bwd_ref(q, k, v, out, lse, g, *, causal: bool = True,
                            window: int = 0, q_offset=None, kv_len=None):
    """Plain version of :func:`flash_attention_bwd`, in f32: the JAX
    kernels' recomputation formula (``flash_attention.py:200-275``).
    ``delta = rowsum(dO * O)``; ``P = exp(S - lse)``, zeroed where masked;
    ``dS = P * (dP - delta) * scale``.  Returns ``(dq, dk, dv)`` in the
    dtypes of ``q``, ``k``, ``v``, with ``dk``/``dv`` group-summed at the
    native ``kvh``."""
    _check(q, k, v, q_offset, kv_len)
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    n_rep = h // kvh
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(b, sq, kvh, n_rep, hd)
    gg = g.float().reshape(b, sq, kvh, n_rep, hd)
    kf, vf = k.float(), v.float()
    ok = _visible(b, sq, sk, causal, window, q_offset, kv_len, q.device)
    s = torch.where(ok, torch.einsum("bqgrd,bkgd->bgrqk", qg, kf) * scale, NEG_INF)
    p = torch.where(ok, torch.exp(s - lse.reshape(b, kvh, n_rep, sq, 1)), 0.0)
    delta = (gg * out.float().reshape(b, sq, kvh, n_rep, hd)).sum(-1)  # (b,sq,g,r)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", gg, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None]) * scale
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds, kf).reshape(b, sq, h, hd)
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds, qg)
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p, gg)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def fwd_path(q) -> str:
    """The K1 or K1q instance a CUDA call with this ``q`` runs: ``"mma"``
    for bf16 ``q`` over a bf16 or an int8 cache (decode too), ``"fma"`` for
    f32."""
    return "mma" if q.dtype == torch.bfloat16 else "fma"


def bwd_path(q) -> str:
    """The K3 instance a CUDA call with this ``q`` runs: ``"mma"`` for bf16,
    ``"fma"`` for f32."""
    return "mma" if q.dtype == torch.bfloat16 else "fma"


@functools.lru_cache(maxsize=None)
def mma_kv_tile(hd: int) -> int:
    """Keys per K/V tile of the tensor-core forward instance at ``hd``, as
    the built kernel gives it (``mma_bk`` in ``csrc/flash_attention.cu``:
    64, and 32 at hd 256)."""
    return _build.load("flash_attention").flash_mma_kv_tile(hd)


@functools.lru_cache(maxsize=None)
def kv_splits(b: int, sq: int, h: int, kvh: int, sk: int, sms: int, kv_tile: int) -> int:
    """The cluster over which K1q's tensor-core instance splits each block's
    K/V tiles: doubled, up to 8 and to the cache's tiles of ``kv_tile`` keys
    (:func:`mma_kv_tile`), while the split grid still fits the ``sms`` SMs
    once (one block per SM: a decode block holds ~150 KB of shared memory at
    hd 128 and ~165 KB at hd 256).  Its blocks are csrc's: four warps, one
    KV head's ``rg`` query heads (4, 2 or 1, whichever divides the group
    first) times 16-row groups.  The engine's decode (8 rows x 8 KV heads: 64
    blocks on 132 SMs) splits in two; its 64-row chunks do not split;
    ``gemma3-1b``'s decode (8 rows x 1 KV head: 8 blocks) splits in eight."""
    n_rep = h // kvh
    rg = 4 if n_rep % 4 == 0 else 2 if n_rep % 2 == 0 else 1
    rows = 16 * (4 // rg)
    blocks = b * kvh * (n_rep // rg) * (-(-sq // rows))
    splits = 1
    while (splits < 8 and 2 * splits * blocks <= sms
           and 2 * splits <= -(-sk // kv_tile)):
        splits *= 2
    return splits


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


SPLITS = (1, 2, 4, 8)  # K1q's cluster sizes (csrc: 1-8 blocks, doubled by the plan)


def kv_tile(hd: int, device) -> int:
    """Keys per K/V tile of the tensor-core instance at ``hd``: the built
    kernel's (:func:`mma_kv_tile`) on the card, its rule (``mma_bk``: 32
    past hd 128, else 64) for a CPU tensor."""
    if torch.device(device).type == "cuda":
        return mma_kv_tile(hd)
    return 32 if hd > 128 else 64


def takes_splits(q, k) -> bool:
    """Whether a call reads ``splits``: K1q's tensor-core instance (bf16
    ``q`` over an int8 cache); K1, K3 and the FMA template ignore it."""
    return k.dtype == torch.int8 and fwd_path(q) == "mma"


def plan_splits(q, k) -> int:
    """The cluster split :func:`kv_splits` plans for this K1q call, on the
    card's SMs (a CPU tensor: ``hbp_matmul.NOMINAL_SMS``)."""
    from repro_torch.kernels.hbp_matmul import sm_count

    b, sq, h, hd = q.shape
    return kv_splits(b, sq, h, k.shape[2], k.shape[1], sm_count(q.device),
                     kv_tile(hd, q.device))


def check_splits(q, k, splits) -> None:
    """Validate a ``splits`` override as :func:`kv_splits` bounds its own
    plan: K1q's tensor-core instance only (:func:`takes_splits`), a size in
    :data:`SPLITS`, and no more blocks than the cache has K/V tiles.
    Raises ``ValueError``."""
    if not takes_splits(q, k):
        raise ValueError(f"flash_attention: splits={splits!r} on a {q.dtype} q over a "
                         f"{k.dtype} cache; only K1q's tensor-core instance (bfloat16 q, "
                         "int8 k/v) reads it")
    if isinstance(splits, bool) or splits not in SPLITS:
        raise ValueError(f"flash_attention: splits={splits!r}; expected one of {SPLITS}")
    hd = q.shape[3]
    tiles = -(-k.shape[1] // kv_tile(hd, q.device)) if hd in HEAD_DIMS else 1
    if splits > max(tiles, 1):
        raise ValueError(f"flash_attention: splits={splits} over {k.shape[1]} keys, "
                         f"{tiles} K/V tile(s) of the tensor-core instance")


def _tensor_core_layout(x) -> bool:
    """Whether the mma instances can stage ``x`` with 16-byte copies: a
    16-byte aligned pointer and (batch, seq, head) strides that are
    multiples of 16 bytes (8 bf16 or 16 int8 elements)."""
    step = 16 // x.element_size()
    return x.data_ptr() % 16 == 0 and all(s % step == 0 for s in x.stride()[:3])


def _require_tensor_core_layout(what, **tensors):
    for name, x in tensors.items():
        if not _tensor_core_layout(x):
            raise ValueError(
                f"{what}: {name} has pointer {x.data_ptr():#x} and strides {x.stride()}; "
                f"the tensor-core kernel needs a 16-byte aligned pointer and "
                f"strides that are multiples of {16 // x.element_size()} elements")


def _lanes(q_offset, kv_len):
    """(rows, [q_offset, kv_len] as contiguous (rows,) vectors or None): one
    lane count for both, a scalar beside a (rows,) vector fanned out."""
    rows = max(1 if x is None else x.numel() for x in (q_offset, kv_len))
    return rows, [None if x is None else x.reshape(-1).expand(rows).contiguous()
                  for x in (q_offset, kv_len)]


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                       L, L, L, L, L, L, L, L, L, I, I, I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def _meta_fwd(q):
    """The forward's outputs as shapes alone, what the kernel allocates
    (``out`` like ``q``, an f32 ``lse`` (b, h, sq)): the dry run's trace."""
    b, sq, h, _ = q.shape
    return torch.empty_like(q), torch.empty((b, h, sq), dtype=torch.float32, device="meta")


def _launch_fwd(q, k, v, causal, window, q_offset, kv_len, k_scale, v_scale, what,
                splits=None):
    """One launch of K1 (``k_scale`` None) or K1q on CUDA tensors that
    :func:`_check` passed; returns ``(out, lse)``.  ``splits``: K1q's
    cluster split (None: :func:`kv_splits`' plan)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {q.device}")
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {hd} not in {HEAD_DIMS}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError(f"{what}: q, k, v need unit stride on head_dim")
    if fwd_path(q) == "mma":
        _require_tensor_core_layout(what, q=q, k=k, v=v)
    rows, lanes = _lanes(q_offset, kv_len)
    scales = [None if x is None else x.contiguous() for x in (k_scale, v_scale)]
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    if splits is None:
        splits = (kv_splits(b, sq, h, kvh, sk, _sm_count(q.device.index or 0),
                            mma_kv_tile(hd))
                  if k_scale is not None and fwd_path(q) == "mma" else 1)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(),
                 *(None if x is None else x.data_ptr() for x in lanes + scales),
                 rows, b, sq, sk, h, kvh, hd,
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 int(causal), int(window), _DTYPE_CODES[q.dtype],
                 int(k_scale is not None), splits, stream)
    _build.check(err, what)
    return out, lse


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: Optional[torch.Tensor] = None,
                    kv_len: Optional[torch.Tensor] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    splits: Optional[int] = None):
    """Attention forward; returns ``(out, lse)``.  With ``k_scale`` and
    ``v_scale`` the int8 ``k``/``v`` go to K1q (:func:`flash_attention_int8`),
    with ``splits`` (its cluster split; any other call raises on it).  See
    the module docstring."""
    _check(q, k, v, q_offset, kv_len, k_scale, v_scale)
    if k_scale is not None:
        return flash_attention_int8(q, k, v, k_scale, v_scale, causal=causal,
                                    window=window, q_offset=q_offset, kv_len=kv_len,
                                    splits=splits)
    if splits is not None:
        check_splits(q, k, splits)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, kv_len=kv_len)
    if q.device.type == "meta":
        return _meta_fwd(q)
    out, lse = _launch_fwd(q, k, v, causal, window, q_offset, kv_len, None, None,
                           "flash_attention")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


def flash_attention_int8(q, k, v, k_scale, v_scale, *, causal: bool = True,
                         window: int = 0, q_offset: Optional[torch.Tensor] = None,
                         kv_len: Optional[torch.Tensor] = None,
                         splits: Optional[int] = None):
    """K1q: attention forward over int8 ``k``/``v`` (``(b, sk, kvh, hd)``)
    with f32 ``k_scale``/``v_scale`` of shape ``(b, kvh)``; ``q`` f32 or
    bf16.  Returns ``(out, lse)`` as :func:`flash_attention`.  Forward only.
    ``splits`` overrides the tensor-core instance's cluster split
    (:func:`check_splits`, on a CPU tensor too; None: :func:`kv_splits`)."""
    if k_scale is None or v_scale is None:
        raise ValueError("flash_attention_int8: needs both k_scale and v_scale")
    _check(q, k, v, q_offset, kv_len, k_scale, v_scale)
    if splits is not None:
        check_splits(q, k, splits)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, kv_len=kv_len,
                                   k_scale=k_scale, v_scale=v_scale)
    if q.device.type == "meta":
        return _meta_fwd(q)
    out, lse = _launch_fwd(q, k, v, causal, window, q_offset, kv_len, k_scale, v_scale,
                           "flash_attention_int8", splits)
    flash_attention_int8.launches += 1
    return out, lse


flash_attention_int8.launches = 0


def _bwd_lib():
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                       ctypes.POINTER(ctypes.c_longlong), I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd(q, k, v, out, lse, g, *, causal: bool = True,
                        window: int = 0, q_offset: Optional[torch.Tensor] = None,
                        kv_len: Optional[torch.Tensor] = None):
    """Attention backward; returns ``(dq, dk, dv)``.  ``out`` and ``lse`` are
    the forward's; ``g`` is the gradient of ``out`` (``(b, sq, h, hd)``,
    read through its strides).  ``dq`` comes back ``(b, sq, h, hd)``,
    ``dk``/``dv`` ``(b, sk, kvh, hd)``; a key no query sees gets zeros.  See
    the module docstring."""
    _check(q, k, v, q_offset, kv_len)
    if g.shape != q.shape or out.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, g "
                         f"{tuple(g.shape)} {g.dtype}; expected q's shape "
                         f"{tuple(q.shape)} and dtype {q.dtype}")
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} {lse.dtype}; "
                         f"expected float32 {(b, h, sq)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, g, causal=causal,
                                       window=window, q_offset=q_offset,
                                       kv_len=kv_len)
    if q.device.type == "meta":  # the shapes alone: the dry run's trace
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for device {q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head_dim {hd} not in {HEAD_DIMS}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention_bwd: q, k, v need unit stride on head_dim")
    mma = bwd_path(q) == "mma"
    if mma:
        _require_tensor_core_layout("flash_attention_bwd", q=q, k=k, v=v)
    # g (from autograd) and out come in whatever layout; the kernel reads a
    # copy when it cannot read one itself
    if g.stride(3) != 1 or (mma and not _tensor_core_layout(g)):
        g = g.clone(memory_format=torch.contiguous_format)
    if out.stride(3) != 1 or (mma and not _tensor_core_layout(out)):
        out = out.clone(memory_format=torch.contiguous_format)
    rows, lanes = _lanes(q_offset, kv_len)
    # delta = rowsum(dO * O), (b, h, sq): the bf16 kernel's dq pass forms it
    # (and writes it here); the f32 kernel takes it from this reduction
    delta = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if mma else
             (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous())
    lse = lse.contiguous()
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((b, sk, kvh, hd), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, kvh, hd), dtype=v.dtype, device=q.device)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    strides = (ctypes.c_longlong * 15)(*(x.stride(i) for x in (q, k, v, g, out)
                                          for i in range(3)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), out.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                     dv.data_ptr(), *(None if x is None else x.data_ptr() for x in lanes),
                     rows, b, sq, sk, h, kvh, hd, strides, int(causal), int(window),
                     _DTYPE_CODES[q.dtype], stream)
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable attention: K1 forward, K3 backward, the counterpart of
    ``_flash_fn``'s custom VJP (``flash_attention.py:484-516``).

    ``FlashAttention.apply(q, k, v, q_offset, kv_len, causal, window)``
    returns ``out``; the forward saves ``(q, k, v, q_offset, kv_len, out,
    lse)`` as the JAX residuals, nothing O(sq * sk), so under a per-layer
    checkpoint the recomputation keeps nothing the checkpoint meant to drop.
    ``q_offset`` and ``kv_len`` get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, kv_len, causal, window):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, kv_len=kv_len)
        ctx.save_for_backward(q, k, v, q_offset, kv_len, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_offset, kv_len, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g, causal=ctx.causal,
                                         window=ctx.window, q_offset=q_offset,
                                         kv_len=kv_len)
        return dq, dk, dv, None, None, None, None


def attention(q, k, v, *, causal: bool = True, window=0,
              q_offset: Optional[torch.Tensor] = None,
              kv_len: Optional[torch.Tensor] = None,
              k_scale: Optional[torch.Tensor] = None,
              v_scale: Optional[torch.Tensor] = None,
              splits: Optional[int] = None) -> torch.Tensor:
    """The registry's ``attention`` entry: the output alone, differentiable
    in q, k, v through :class:`FlashAttention` (K1 forward, K3 backward);
    with ``k_scale``/``v_scale`` the int8 ``k``/``v`` go to K1q, forward
    only, as the JAX kernel's quantized path.  ``splits``: K1q's cluster
    split, its one tunable knob (:func:`check_splits`).  Without a gradient
    to record it calls the forward directly, past the autograd Function."""
    window = 0 if window is None else int(window)
    if k_scale is not None or not (torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad)):
        return flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                               kv_len=kv_len, k_scale=k_scale, v_scale=v_scale,
                               splits=splits)[0]
    if splits is not None:
        check_splits(q, k, splits)
    return FlashAttention.apply(q, k, v, q_offset, kv_len, causal, window)


def attention_ref(q, k, v, *, causal: bool = True, window=0, q_offset=None,
                  kv_len=None, k_scale=None, v_scale=None) -> torch.Tensor:
    """The registry's attention oracle: :func:`flash_attention_ref`'s
    output, differentiable by autograd."""
    return flash_attention_ref(q, k, v, causal=causal,
                               window=0 if window is None else int(window),
                               q_offset=q_offset, kv_len=kv_len, k_scale=k_scale,
                               v_scale=v_scale)[0]
