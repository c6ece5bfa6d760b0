"""Dense decoder-only LM without MoE: the counterpart of
``repro/models/dense.py``.

The JAX model scans one program over layer-stacked parameters; here an
``nn.ModuleList`` of layers and a Python loop take its place, and the
per-layer window and RoPE theta are plain Python values.  Parameter names
follow the JAX pytree (``embed``, ``final_norm``, ``layers.<i>.<name>``),
so ``repro_torch.checkpoint`` carries JAX parameters across by unstacking
the layer axis.  Every matrix product runs on ``hbp_matmul`` and every
attention call on ``flash_attention``; in training their backward runs on
``hbp_matmul`` and ``flash_attention_bwd``.  The parameters are trainable;
``prefill`` and ``decode_step`` run under ``torch.no_grad``.
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
    def _attn(self, layer: DenseLayer, x, rope, window, kc=None, vc=None,
              write_at=None, q_offset=None, kv_len=None):
        """Attention sub-block.  With cache slabs it writes the fresh k/v
        into them at ``write_at``; with ``q_offset`` given it attends over
        the cache (decode), else over the fresh k/v (prefill, training)."""
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
        if kc is not None:
            dcache.linear_write(kc, k, write_at)
            dcache.linear_write(vc, v, write_at)
        if q_offset is not None:
            # decode: attend the cache; the fresh row was just written
            o = common.attention(q, kc, vc, causal=True, window=window,
                                 q_offset=q_offset, kv_len=kv_len)
        else:
            o = common.attention(q, k, v, causal=True, window=window)
        return x + common.attn_out_project(o, layer.wo)

    def _ffn(self, layer: DenseLayer, x):
        h = common.rms_norm(x, layer.ln2, self.cfg.norm_eps)
        return x + common.gated_mlp(h, layer.w_gate, layer.w_up, layer.w_down)

    def _layer(self, layer: DenseLayer, x, rope, window, *cache_args):
        return self._ffn(layer, self._attn(layer, x, rope, window, *cache_args))

    def _backbone(self, tokens, q_pos, cache: Optional[dcache.LinearKV] = None,
                  write_at=None, q_offset=None, kv_len=None):
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
                          (cache.k[i], cache.v[i], write_at, q_offset, kv_len))
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
        cfg = self.cfg
        return dcache.LinearKV.create(
            (cfg.n_layers,), batch_size, max_len, cfg.n_kv_heads, cfg.head_dim_,
            cfg.activation_dtype, device=self.device)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int):
        b, s = tokens.shape
        q_pos = torch.arange(s, dtype=torch.int32, device=self.device)
        kv = self.init_cache(b, max_len)
        x = self._backbone(tokens, q_pos, kv, write_at=0)
        logits = common.logits_matmul(x[:, -1], self.embed)
        pos = torch.full((b,), s, dtype=torch.int32, device=self.device)
        return logits, kv.replace(pos=pos)

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, pos: torch.Tensor,
                    cache: dcache.LinearKV):
        """One token per row at ``pos``: a scalar (lockstep, every row at one
        depth) or a (b,) vector (each row at its own depth).  ``pos`` stays
        on the device; the kernel reads it as its per-row lanes."""
        b = tokens.shape[0]
        pos = pos.to(torch.int32)
        q_pos = pos[:, None] if pos.dim() else pos.reshape(1)
        q_offset = pos.reshape(-1)
        kv_len = (q_offset + 1).clamp(max=cache.capacity)
        x = self._backbone(tokens, q_pos, cache, write_at=pos,
                           q_offset=q_offset, kv_len=kv_len)
        logits = common.logits_matmul(x[:, -1], self.embed)
        return logits, cache.replace(pos=(pos + 1).expand(b).contiguous())
