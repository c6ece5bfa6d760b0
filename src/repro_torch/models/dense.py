"""Dense decoder-only LM without MoE: the counterpart of
``repro/models/dense.py``.

The JAX model scans one program over layer-stacked parameters; here an
``nn.ModuleList`` of layers and a Python loop take its place, and the
per-layer window and RoPE theta are plain Python values.  Parameter names
follow the JAX pytree (``embed``, ``final_norm``, ``layers.<i>.<name>``),
so ``repro_torch.checkpoint`` carries JAX parameters across by unstacking
the layer axis.  Every matrix product runs on ``hbp_matmul`` and every
attention call on ``flash_attention``; in training their backward runs on
``hbp_matmul`` and ``flash_attention_bwd``.  Over an int8 KV cache (the
policy's attention ``kv_dtype=int8`` variant) decode and continuation
chunks attend through ``flash_attention_int8`` (K1q).  The parameters are
trainable; ``prefill``, ``prefill_chunk`` and ``decode_step`` run under
``torch.no_grad``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import cache as dcache
from repro_torch.models import common
from repro_torch.models.base import (Model, RunOptions, UnsupportedFamilyError,
                                     maybe_remat, right_shift)

_NORMS = ("ln1", "ln2", "q_norm", "k_norm", "final_norm")


def layer_windows(cfg: ModelConfig) -> list[Optional[int]]:
    """Per-layer attention window; None = full causal (a global layer)."""
    win = []
    for i in range(cfg.n_layers):
        if cfg.sliding_window is None:
            win.append(None)
        elif cfg.global_every and (i % cfg.global_every == cfg.global_every - 1):
            win.append(None)  # every k-th layer is global
        else:
            win.append(cfg.sliding_window)
    return win


def layer_thetas(cfg: ModelConfig) -> list[float]:
    """Gemma3 uses a small RoPE base for local layers, large for global."""
    return [10_000.0 if w is not None else cfg.rope_theta
            for w in layer_windows(cfg)]


def _param(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class DenseLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim_
        p = lambda *shape: _param(*shape, dtype=dtype, device=device)  # noqa: E731
        self.ln1, self.ln2 = p(d), p(d)
        self.wq, self.wk = p(d, cfg.q_dim), p(d, cfg.kv_dim)
        self.wv, self.wo = p(d, cfg.kv_dim), p(cfg.q_dim, d)
        if cfg.qk_norm:
            self.q_norm, self.k_norm = p(hd), p(hd)
        self.w_gate, self.w_up = p(d, cfg.d_ff), p(d, cfg.d_ff)
        self.w_down = p(cfg.d_ff, d)


class DenseLM(Model):
    def __init__(self, cfg: ModelConfig, opts: Optional[RunOptions] = None, *,
                 device=None):
        super().__init__(cfg, opts)
        for missing, needed in (("MoE layers", cfg.n_experts), ("qkv_bias", cfg.qkv_bias),
                                ("untied lm_head", not cfg.tie_embeddings)):
            if needed:
                raise UnsupportedFamilyError(cfg.family, missing)
        self.device = resolve_device(device)
        dt = cfg.activation_dtype
        self.embed = _param(cfg.vocab_size, cfg.d_model, dtype=dt, device=self.device)
        self.layers = nn.ModuleList(DenseLayer(cfg, dt, self.device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _param(cfg.d_model, dtype=dt, device=self.device)
        self.windows = layer_windows(cfg)
        self.thetas = layer_thetas(cfg)

    # -- params ------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The JAX ``init``'s distributions (``dense.py:57-98``): truncated
        normal over fan-in for the projections, std 0.02 for the embedding,
        zeros for the norms.  ``jax.random`` cannot be reproduced, so the
        numbers differ from a JAX init with any seed."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _NORMS:
                p.zero_()
            elif leaf == "embed":
                common.dense_init(p, generator, scale=0.02)
            else:
                common.dense_init(p, generator)

    # -- layer body ----------------------------------------------------------
    def _attn(self, layer: DenseLayer, x, rope, window, cache=None, li=None,
              write_at=None, q_offset=None, kv_len=None, chunked=False,
              calib_len=None):
        """Attention sub-block (JAX ``dense.py:101-180``).  With ``cache``
        it writes the fresh k/v into layer ``li``'s slabs at ``write_at``.
        Decode (one token) and continuation chunks (``chunked``) then attend
        the cache at ``q_offset``/``kv_len``; prefill, first chunks and
        training attend the fresh k/v.

        An int8 cache carries per-(batch, kv_head) scales: prefill and first
        chunks calibrate them from the fresh k/v over ``calib_len`` valid
        positions (a row with ``calib_len == 0``, parked, keeps its stored
        scales) and attend the exact fp k/v; decode and continuation chunks
        quantize with the stored scales and attend the int8 cache, which
        K1q dequantizes at its block load."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim_
        h = common.rms_norm(x, layer.ln1, cfg.norm_eps)
        q, k, v = common.qkv_project(h, layer.wq, layer.wk, layer.wv)
        q = q.reshape(b, s, cfg.n_heads, hd)
        k = k.reshape(b, s, cfg.n_kv_heads, hd)
        v = v.reshape(b, s, cfg.n_kv_heads, hd)
        if cfg.qk_norm:
            q = common.rms_norm(q, layer.q_norm, cfg.norm_eps)
            k = common.rms_norm(k, layer.k_norm, cfg.norm_eps)
        q = common.rotate(q, *rope)
        k = common.rotate(k, *rope)
        if cache is None:
            o = common.attention(q, k, v, causal=True, window=window)
            return x + common.attn_out_project(o, layer.wo)

        kc, vc = cache.k[li], cache.v[li]
        scales = {}
        if cache.quantized:
            ks, vs = cache.k_scale[li], cache.v_scale[li]
            if s > 1 and not chunked:
                # calibrate on the real k/v, over calib_len valid positions
                ck, cv = common.kv_scale(k, calib_len), common.kv_scale(v, calib_len)
                if isinstance(calib_len, torch.Tensor) and calib_len.dim() == 1:
                    live = calib_len > 0
                    ck = dcache.masked_rows(live, ck, ks)
                    cv = dcache.masked_rows(live, cv, vs)
                ks.copy_(ck)
                vs.copy_(cv)
            dcache.linear_write(kc, common.quantize_kv(k, ks), write_at)
            dcache.linear_write(vc, common.quantize_kv(v, vs), write_at)
            scales = {"k_scale": ks, "v_scale": vs}
        else:
            dcache.linear_write(kc, k, write_at)
            dcache.linear_write(vc, v, write_at)
        if s == 1 or chunked:
            # attend the cache: the fresh rows were just written
            o = common.attention(q, kc, vc, causal=True, window=window,
                                 q_offset=q_offset, kv_len=kv_len, **scales)
        else:
            o = common.attention(q, k, v, causal=True, window=window)
        return x + common.attn_out_project(o, layer.wo)

    def _ffn(self, layer: DenseLayer, x):
        h = common.rms_norm(x, layer.ln2, self.cfg.norm_eps)
        return x + common.gated_mlp(h, layer.w_gate, layer.w_up, layer.w_down)

    def _layer(self, layer: DenseLayer, x, rope, window, *cache_args):
        return self._ffn(layer, self._attn(layer, x, rope, window, *cache_args))

    def _backbone(self, tokens, q_pos, cache: Optional[dcache.LinearKV] = None,
                  write_at=None, q_offset=None, kv_len=None, chunked=False,
                  calib_len=None):
        """The layer stack.  Without a cache (training) each layer is
        rematerialised per ``opts.remat``; with one it writes k/v there."""
        cfg = self.cfg
        x = common.embed_lookup(self.embed, tokens).to(cfg.activation_dtype)
        if cfg.scale_embeddings:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
        ropes = {th: common.rope_cos_sin(q_pos, cfg.head_dim_, th)
                 for th in set(self.thetas)}
        layer_fn = self._layer if cache is not None else maybe_remat(self._layer, self.opts)
        for i, layer in enumerate(self.layers):
            cache_args = (() if cache is None else
                          (cache, i, write_at, q_offset, kv_len, chunked, calib_len))
            x = layer_fn(layer, x, ropes[self.thetas[i]], self.windows[i], *cache_args)
        return common.rms_norm(x, self.final_norm, cfg.norm_eps)

    # -- training ------------------------------------------------------------
    def loss(self, batch: dict) -> torch.Tensor:
        """JAX ``dense.py:250-260``: teacher forcing on ``right_shift``ed
        tokens, the chunked cross-entropy over the tied table, plus the
        router's aux term (0 for a dense model)."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        s = tokens.shape[1]
        pos = torch.arange(s, dtype=torch.int32, device=tokens.device)
        x = self._backbone(right_shift(tokens), pos)
        ce = common.chunked_softmax_xent(x, self.embed, labels, chunk=self.opts.ce_chunk)
        aux = torch.zeros((), dtype=torch.float32, device=ce.device)
        return ce + cfg.router_aux_weight * aux / max(cfg.n_layers, 1)

    # -- inference -----------------------------------------------------------
    def init_cache(self, batch_size: int, max_len: int) -> dcache.LinearKV:
        """``LinearKV`` cache (layer-stacked slabs, per-row positions),
        int8 with per-(layer, batch, kv_head) f32 scales under the policy's
        attention ``kv_dtype=int8`` variant (JAX ``dense.py:263-275``)."""
        cfg = self.cfg
        dtype, quantized = common.kv_cache_dtype(cfg.activation_dtype)
        return dcache.LinearKV.create(
            (cfg.n_layers,), batch_size, max_len, cfg.n_kv_heads, cfg.head_dim_,
            dtype, device=self.device, quantized=quantized)

    @staticmethod
    def _cache_lanes(cache: dcache.LinearKV, q_offset: torch.Tensor, s: int):
        """The kernel's lanes for ``s`` query rows at ``q_offset`` (scalar or
        (b,)) over the cache: keys up to the last query row, clipped to the
        capacity (JAX ``_attention_via_kernel``)."""
        q_offset = q_offset.reshape(-1)
        return q_offset, (q_offset + s).clamp(max=cache.capacity)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int):
        b, s = tokens.shape
        q_pos = torch.arange(s, dtype=torch.int32, device=self.device)
        kv = self.init_cache(b, max_len)
        q_offset, kv_len = self._cache_lanes(
            kv, torch.zeros((), dtype=torch.int32, device=self.device), s)
        x = self._backbone(tokens, q_pos, kv, write_at=0, q_offset=q_offset,
                           kv_len=kv_len)
        logits = common.logits_matmul(x[:, -1], self.embed)
        pos = torch.full((b,), s, dtype=torch.int32, device=self.device)
        return logits, kv.replace(pos=pos)

    @torch.no_grad()
    def prefill_chunk(self, tokens: torch.Tensor, offset: torch.Tensor,
                      cache: dcache.LinearKV, *, first: bool = False,
                      lens: Optional[torch.Tensor] = None):
        """One fixed-size chunk of a chunked prefill (JAX ``dense.py:300-327``):
        write this chunk's k/v at ``offset`` (an int32 tensor, scalar or
        per-row) and attend causally.  The first chunk attends its fresh k/v
        (an int8 cache calibrates its scales there, over the valid tokens
        only); continuation chunks attend the cache prefix.  ``lens`` (b,)
        counts each row's valid tokens; 0 parks a row, whose k/v lands only
        where its own next write lands first.  Returns the per-row
        last-valid-token logits (b, V) and the cache."""
        b, s = tokens.shape
        offset = offset.to(torch.int32)
        q_pos = (offset[:, None] if offset.dim() else offset) + torch.arange(
            s, dtype=torch.int32, device=self.device)
        q_offset, kv_len = self._cache_lanes(cache, offset, s)
        x = self._backbone(tokens, q_pos, cache, write_at=offset, q_offset=q_offset,
                           kv_len=kv_len, chunked=not first,
                           calib_len=s if lens is None else lens)
        logits = common.logits_matmul(dcache.pick_last(x, lens), self.embed)
        new_pos = offset + (s if lens is None else lens.to(torch.int32))
        return logits, cache.replace(pos=new_pos.expand(b).contiguous())

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, pos: torch.Tensor,
                    cache: dcache.LinearKV):
        """One token per row at ``pos``: a scalar (lockstep, every row at one
        depth) or a (b,) vector (each row at its own depth).  ``pos`` stays
        on the device; the kernel reads it as its per-row lanes."""
        b = tokens.shape[0]
        pos = pos.to(torch.int32)
        q_pos = pos[:, None] if pos.dim() else pos.reshape(1)
        q_offset, kv_len = self._cache_lanes(cache, pos, 1)
        x = self._backbone(tokens, q_pos, cache, write_at=pos,
                           q_offset=q_offset, kv_len=kv_len)
        logits = common.logits_matmul(x[:, -1], self.embed)
        return logits, cache.replace(pos=(pos + 1).expand(b).contiguous())
