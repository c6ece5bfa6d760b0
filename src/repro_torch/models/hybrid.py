"""Hybrid RG-LRU + local-attention LM (``recurrentgemma-2b``): the
counterpart of ``repro/models/hybrid.py``.

Block pattern (rec, rec, attn): 26 layers are 8 superblocks of (rec, rec,
attn) and 2 trailing rec blocks.  The JAX model scans each group over
stacked parameters; here the groups are ``nn.ModuleList``s walked by a
Python loop, named after the JAX tree (``groups.rec1.<i>.<leaf>``,
``groups.rec2.<i>``, ``groups.attn.<i>``, ``tail_rec.<i>``), so
``repro_torch.checkpoint`` carries parameters across by unstacking each
group's leading axis.

Routes, as in JAX: the attention blocks' QKV, output and MLP products, the
rec blocks' MLP products and the tied logits go through the registry's
``matmul`` op (K2 on the card), and their attention through its
``attention`` op (K1 forward, K3 backward); the rec block's ``w_x``,
``w_gate_branch`` and ``w_out`` products and its block-diagonal gates are
``jnp.einsum`` in JAX, outside the registry, and plain PyTorch products
here (full f32 where the model is f32: TF32 stays off, PyTorch's default).
No Pallas kernel computes the RG-LRU recurrence ``h_t = a_t * h_{t-1} +
b_t`` in JAX either: :func:`rglru_scan` mirrors ``jax.lax.associative_scan``'s
recursion in tensor ops (log depth, no loop over tokens), pairing elements
as it does.  The hybrid has no int8 cache in JAX (``init_cache`` ignores
the ``kv_dtype`` variant), and none here.

A decode step launches 111 K2 (3 MLP products in each of the 18 rec
blocks, 3 QKV + 1 output + 3 MLP in each of the 8 attention blocks, the
logits) and 8 K1.  ``RunOptions.windowed_decode_cache`` serves decode from
a ``RingKV`` of ``min(max_len, window)`` slots, attended with ``q_offset =
pos`` and ``kv_len = min(pos + 1, C)`` and no window mask; chunked prefill
(the engine) needs the linear layout, where the window is the mask's.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import cache as dcache
from repro_torch.models import common
from repro_torch.models.base import Model, RunOptions, maybe_remat, right_shift

LRU_C = 8.0  # RG-LRU exponent constant from Griffin
_ZEROS = ("ln1", "ln2", "final_norm")


def _combine(x, y):
    (a1, b1), (a2, b2) = x, y
    return a1 * a2, a2 * b1 + b2


def _interleave(e: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """Evens ``e`` and odds ``o`` interleaved along axis 1 (``e`` as long
    as ``o`` or one longer)."""
    n = o.shape[1]
    pairs = torch.stack([e[:, :n], o], dim=2).flatten(1, 2)
    return pairs if e.shape[1] == n else torch.cat([pairs, e[:, n:]], dim=1)


def _associative_scan(a: torch.Tensor, b: torch.Tensor):
    """``jax.lax.associative_scan(_combine, (a, b), axis=1)``, the same
    recursion: combine adjacent pairs, scan the half, then fix up the evens
    from the odds."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2]))
    oa, ob = _associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t by the associative (BP) scan.  a, b:
    (batch, seq, width) f32; ``h0`` (batch, width) is folded into the first
    step.  Returns h (batch, seq, width)."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    return _associative_scan(a, b)[1]


def block_diag_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., nh, wb); w: (nh, wb, wb) block-diagonal linear."""
    return torch.einsum("...hi,hij->...hj", x, w)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor] = None,
                  lens: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x: (b, s, w); w: (k, w); ``state`` (b, k-1,
    w) the previous inputs (decode).  ``lens`` (b,) restricts the new state
    to each row's valid prefix (``lens = 0`` keeps the old state).  Returns
    (y, new_state)."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (b, s + k - 1, w)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    if k <= 1:
        new_state = None
    elif lens is None:
        new_state = xp[:, -(k - 1):]
    else:
        new_state = dcache.conv_tail(xp, lens, k - 1)
    return y, new_state


class RecBlock(nn.Module):
    """A recurrent block's parameters, with the JAX names and shapes
    (``hybrid.py:85-100``); the LRU gates and ``lru_a_param`` are f32."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, w, nh = cfg.d_model, cfg.lru_width, cfg.n_heads
        p = lambda *shape, dt=dtype: common.param(*shape, dtype=dt, device=device)  # noqa: E731
        self.ln1, self.ln2 = p(d), p(d)
        self.w_x, self.w_gate_branch = p(d, w), p(d, w)
        self.conv_w = p(cfg.conv1d_width, w)
        self.lru_a_gate = p(nh, w // nh, w // nh, dt=torch.float32)
        self.lru_i_gate = p(nh, w // nh, w // nh, dt=torch.float32)
        self.lru_a_param = p(w, dt=torch.float32)
        self.w_out = p(w, d)
        self.w_mlp_gate, self.w_mlp_up = p(d, cfg.d_ff), p(d, cfg.d_ff)
        self.w_mlp_down = p(cfg.d_ff, d)


class AttnBlock(nn.Module):
    """A local-attention block's parameters (``hybrid.py:102-114``)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        p = lambda *shape: common.param(*shape, dtype=dtype, device=device)  # noqa: E731
        self.ln1, self.ln2 = p(d), p(d)
        self.wq, self.wk, self.wv = p(d, cfg.q_dim), p(d, cfg.kv_dim), p(d, cfg.kv_dim)
        self.wo = p(cfg.q_dim, d)
        self.w_mlp_gate, self.w_mlp_up = p(d, cfg.d_ff), p(d, cfg.d_ff)
        self.w_mlp_down = p(cfg.d_ff, d)


class HybridLM(Model):
    def __init__(self, cfg: ModelConfig, opts: Optional[RunOptions] = None, *,
                 device=None):
        super().__init__(cfg, opts)
        self.device = resolve_device(device)
        dt, dev = cfg.activation_dtype, self.device
        self.n_super = cfg.n_layers // len(cfg.block_pattern)            # 8
        self.n_tail = cfg.n_layers - self.n_super * len(cfg.block_pattern)  # 2
        self.embed = common.param(cfg.vocab_size, cfg.d_model, dtype=dt, device=dev)
        self.groups = nn.ModuleDict({
            "rec1": nn.ModuleList(RecBlock(cfg, dt, dev) for _ in range(self.n_super)),
            "rec2": nn.ModuleList(RecBlock(cfg, dt, dev) for _ in range(self.n_super)),
            "attn": nn.ModuleList(AttnBlock(cfg, dt, dev) for _ in range(self.n_super)),
        })
        self.tail_rec = nn.ModuleList(RecBlock(cfg, dt, dev) for _ in range(self.n_tail))
        self.final_norm = common.param(cfg.d_model, dtype=dt, device=dev)

    # -- params ------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The JAX ``init``'s distributions (``hybrid.py:77-125``): truncated
        normal over fan-in for the products and the LRU gates, scale 0.3
        for the conv, 0.02 for the embedding, zeros for the norms, and
        ``lru_a_param = log(expm1(linspace(0.9, 0.999, w)))``.  The numbers
        differ from a JAX init with any seed."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _ZEROS:
                p.zero_()
            elif leaf == "lru_a_param":
                w = torch.linspace(0.9, 0.999, p.shape[0], dtype=torch.float32,
                                   device=p.device)
                p.copy_(torch.log(torch.expm1(w)))
            elif leaf == "embed":
                common.dense_init(p, generator, scale=0.02)
            elif leaf == "conv_w":
                common.dense_init(p, generator, scale=0.3)
            else:
                common.dense_init(p, generator)

    # -- blocks ----------------------------------------------------------------
    def _rec_block(self, blk: RecBlock, x, lru_state=None, conv_state=None, lens=None):
        """Returns (x, new_lru_state, new_conv_state) (JAX ``hybrid.py:128-171``).

        ``lens`` (b,) restricts the state update to each row's valid prefix
        (a padded chunk, a parked engine row): pad steps carry the LRU
        identity (a = 1, b = 0: ``h`` holds) and the conv state is sliced at
        the valid tail, so a ``lens = 0`` row's state passes through bit
        for bit."""
        cfg = self.cfg
        b, s, _ = x.shape
        w, nh = cfg.lru_width, cfg.n_heads
        h = common.rms_norm(x, blk.ln1, cfg.norm_eps)
        branch = h @ blk.w_x
        gate = F.gelu((h @ blk.w_gate_branch).float(), approximate="tanh")
        y, new_conv = causal_conv1d(branch, blk.conv_w, conv_state, lens=lens)

        # RG-LRU gates (block-diagonal linears, f32)
        yf = y.float()
        yh = yf.reshape(b, s, nh, w // nh)
        r = torch.sigmoid(block_diag_linear(yh, blk.lru_a_gate)).reshape(b, s, w)
        i = torch.sigmoid(block_diag_linear(yh, blk.lru_i_gate)).reshape(b, s, w)
        log_a = -LRU_C * F.softplus(blk.lru_a_param) * r
        bterm = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (i * yf)
        tok = dcache.token_mask(lens, s)
        if tok is not None:
            # pad tokens are scan identities: a = exp(0) = 1, b = 0
            log_a = torch.where(tok[..., None], log_a, 0.0)
            bterm = torch.where(tok[..., None], bterm, 0.0)
        a = torch.exp(log_a)

        if s == 1 and lru_state is not None:
            hseq = a * lru_state[:, None] + bterm  # one decode step
        else:
            hseq = rglru_scan(a, bterm, h0=lru_state)
        new_state = hseq[:, -1]  # (b, w)

        out = (hseq * gate).to(x.dtype)
        x = x + out @ blk.w_out
        h2 = common.rms_norm(x, blk.ln2, cfg.norm_eps)
        x = x + common.gated_mlp(h2, blk.w_mlp_gate, blk.w_mlp_up, blk.w_mlp_down)
        return x, new_state, new_conv

    def _attn_block(self, blk: AttnBlock, x, rope, kv=None, li=None, write_at=None,
                    chunked=False, q_offset=None, kv_len=None):
        """The local-attention block (JAX ``hybrid.py:173-221``).  With the
        cache ``kv`` it writes the fresh k/v into superblock ``li``'s slabs
        at ``write_at``; decode and continuation chunks then attend the
        cache at ``q_offset``/``kv_len`` (a ring without the window mask),
        prefill and first chunks the fresh k/v."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim_
        h = common.rms_norm(x, blk.ln1, cfg.norm_eps)
        q, k, v = common.qkv_project(h, blk.wq, blk.wk, blk.wv)
        q = common.rotate(q.reshape(b, s, cfg.n_heads, hd), *rope)
        k = common.rotate(k.reshape(b, s, cfg.n_kv_heads, hd), *rope)
        v = v.reshape(b, s, cfg.n_kv_heads, hd)
        window = cfg.sliding_window
        if kv is None:
            o = common.attention(q, k, v, causal=True, window=window)
        else:
            ring = isinstance(kv, dcache.RingKV)
            kc, vc = kv.k[li], kv.v[li]
            write = dcache.ring_write if ring else dcache.linear_write
            write(kc, k, write_at)
            write(vc, v, write_at)
            if s == 1 or chunked:
                # attend the cache; a ring holds only in-window slots, so
                # its mask is causal over the slots alone
                o = common.attention(q, kc, vc, causal=True, window=None if ring else window,
                                     q_offset=q_offset, kv_len=kv_len)
            else:
                o = common.attention(q, k, v, causal=True, window=window)
        x = x + common.attn_out_project(o, blk.wo)
        h2 = common.rms_norm(x, blk.ln2, cfg.norm_eps)
        return x + common.gated_mlp(h2, blk.w_mlp_gate, blk.w_mlp_up, blk.w_mlp_down)

    # -- forward ------------------------------------------------------------------
    def _backbone(self, tokens, q_pos, cache=None, write_at=None, lens=None,
                  chunked=False, q_offset=None, kv_len=None):
        """The block stack (JAX ``hybrid.py:224-287``).  Without a cache
        (training) each superblock and each tail block is rematerialised
        per ``opts.remat``; with one it returns the cache with new
        recurrent state (the k/v written in place)."""
        cfg = self.cfg
        x = common.embed_lookup(self.embed, tokens).to(cfg.activation_dtype)
        if cfg.scale_embeddings:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
        rope = common.rope_cos_sin(q_pos, cfg.head_dim_, cfg.rope_theta)
        g = self.groups
        if cache is None:
            def superblock(x, i):
                x = self._rec_block(g["rec1"][i], x)[0]
                x = self._rec_block(g["rec2"][i], x)[0]
                return self._attn_block(g["attn"][i], x, rope)

            def tail_block(x, i):
                return self._rec_block(self.tail_rec[i], x)[0]

            sb, tb = maybe_remat(superblock, self.opts), maybe_remat(tail_block, self.opts)
            for i in range(self.n_super):
                x = sb(x, i)
            for i in range(self.n_tail):
                x = tb(x, i)
            return common.rms_norm(x, self.final_norm, cfg.norm_eps), None

        st, kv = cache["state"].states, cache["kv"]
        new = {key: [] for key in st}
        for i in range(self.n_super):
            for n in ("1", "2"):
                x, lru, conv = self._rec_block(g["rec" + n][i], x, st["lru" + n][i],
                                               st["conv" + n][i], lens=lens)
                new["lru" + n].append(lru)
                new["conv" + n].append(conv)
            x = self._attn_block(g["attn"][i], x, rope, kv, i, write_at, chunked,
                                 q_offset, kv_len)
        for i in range(self.n_tail):
            x, lru, conv = self._rec_block(self.tail_rec[i], x, st["tail_lru"][i],
                                           st["tail_conv"][i], lens=lens)
            new["tail_lru"].append(lru)
            new["tail_conv"].append(conv)
        # (a group of no blocks, as the smoke config's tail, keeps its empty state)
        state = cache["state"].replace(states={k: torch.stack(v) if v else st[k]
                                               for k, v in new.items()})
        x = common.rms_norm(x, self.final_norm, cfg.norm_eps)
        return x, {"state": state, "kv": kv}

    def loss(self, batch: dict) -> torch.Tensor:
        tokens, labels = batch["tokens"], batch["labels"]
        pos = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
        x, _ = self._backbone(right_shift(tokens), pos)
        return common.chunked_softmax_xent(x, self.embed, labels, chunk=self.opts.ce_chunk)

    # -- inference -------------------------------------------------------------------
    @property
    def ring_mode(self) -> bool:
        # local attention never looks back further than the window
        return bool(self.opts.windowed_decode_cache and self.cfg.sliding_window)

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        """``{"state": StateCarry, "kv": LinearKV | RingKV}`` (JAX
        ``hybrid.py:303-324``): the LRU states in f32, the conv tails and
        k/v in the activation dtype; the ring under
        ``windowed_decode_cache``."""
        cfg = self.cfg
        dt, dev = cfg.activation_dtype, self.device
        w, tail = cfg.lru_width, cfg.conv1d_width - 1

        def zeros(n, *shape, dtype=dt):
            return torch.zeros((n, batch_size, *shape), dtype=dtype, device=dev)

        state = dcache.StateCarry.create({
            "lru1": zeros(self.n_super, w, dtype=torch.float32),
            "conv1": zeros(self.n_super, tail, w),
            "lru2": zeros(self.n_super, w, dtype=torch.float32),
            "conv2": zeros(self.n_super, tail, w),
            "tail_lru": zeros(self.n_tail, w, dtype=torch.float32),
            "tail_conv": zeros(self.n_tail, tail, w),
        })
        if self.ring_mode:
            kv = dcache.RingKV.create((self.n_super,), batch_size,
                                      min(max_len, cfg.sliding_window), cfg.n_kv_heads,
                                      cfg.head_dim_, dt, device=dev)
        else:
            kv = dcache.LinearKV.create((self.n_super,), batch_size, max_len, cfg.n_kv_heads,
                                        cfg.head_dim_, dt, device=dev)
        return {"state": state, "kv": kv}

    @torch.no_grad()
    def prefill(self, batch: dict, max_len: int):
        tokens = batch["tokens"]
        b, s = tokens.shape
        q_pos = torch.arange(s, dtype=torch.int32, device=self.device)
        x, cache = self._backbone(tokens, q_pos, self.init_cache(b, max_len), write_at=0)
        logits = common.logits_matmul(x[:, -1], self.embed)
        pos = torch.full((b,), s, dtype=torch.int32, device=self.device)
        return logits, {"state": cache["state"], "kv": cache["kv"].replace(pos=pos)}

    @torch.no_grad()
    def prefill_chunk(self, tokens: torch.Tensor, offset: torch.Tensor, cache: dict, *,
                      first: bool = False, lens: Optional[torch.Tensor] = None,
                      extras: Optional[dict] = None):
        """Chunked prefill against the linear layout (the engine's path; JAX
        ``hybrid.py:337-362``).  The ring is decode-only: a windowed chunked
        prefill would have to wrap-attend mid-prompt, so the engine serves
        the hybrid with the linear layout, the window enforced by the
        mask."""
        if isinstance(cache["kv"], dcache.RingKV):
            raise NotImplementedError(
                "chunked prefill over the RingKV layout: serve hybrid with "
                "windowed_decode_cache=False (window enforced by masking)")
        b, s = tokens.shape
        offset = offset.to(torch.int32)
        q_pos = (offset[:, None] if offset.dim() else offset) + torch.arange(
            s, dtype=torch.int32, device=self.device)
        q_offset = offset.reshape(-1)
        kv_len = (q_offset + s).clamp(max=cache["kv"].capacity)
        x, cache = self._backbone(tokens, q_pos, cache, write_at=offset, lens=lens,
                                  chunked=not first, q_offset=q_offset, kv_len=kv_len)
        logits = common.logits_matmul(dcache.pick_last(x, lens), self.embed)
        new_pos = offset + (s if lens is None else lens.to(torch.int32))
        return logits, {"state": cache["state"],
                        "kv": cache["kv"].replace(pos=new_pos.expand(b).contiguous())}

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, pos: torch.Tensor, cache: dict):
        """One token per row at ``pos`` (a scalar or (b,)).  The ring
        attends ``min(pos + 1, C)`` slots at ``q_offset = pos``; the linear
        cache the first ``pos + 1`` under the window.  Rows that are not
        ``valid`` (parked engine rows) carry their state through."""
        b = tokens.shape[0]
        kv = cache["kv"]
        pos = pos.to(torch.int32)
        q_pos = pos[:, None] if pos.dim() else pos.reshape(1)
        q_offset = pos.reshape(-1)
        if isinstance(kv, dcache.RingKV):
            kv_len = kv.attend_lens(q_offset)
        else:
            kv_len = (q_offset + 1).clamp(max=kv.capacity)
        lens = cache["state"].valid.to(torch.int32)
        x, cache = self._backbone(tokens, q_pos, cache, write_at=pos, lens=lens,
                                  q_offset=q_offset, kv_len=kv_len)
        logits = common.logits_matmul(x[:, -1], self.embed)
        return logits, {"state": cache["state"],
                        "kv": cache["kv"].replace(pos=(pos + 1).expand(b).contiguous())}
