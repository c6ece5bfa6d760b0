"""Dense decoder-only LM, also hosting MoE layers: the counterpart of
``repro/models/dense.py``.  It serves ``qwen3-1.7b``, ``qwen3-32b``,
``qwen2.5-14b`` (QKV bias), ``gemma3-1b`` (head dim 256, sliding windows
with a local RoPE theta, scaled embeddings) and the MoE configs
``olmoe-1b-7b`` and ``qwen3-moe-30b-a3b``; an untied config reads its
logits from ``lm_head``.

The JAX model scans one program over layer-stacked parameters; here an
``nn.ModuleList`` of layers and a Python loop take its place, and the
per-layer window and RoPE theta are plain Python values.  Parameter names
follow the JAX pytree (``embed``, ``final_norm``, ``layers.<i>.<name>``),
so ``repro_torch.checkpoint`` carries JAX parameters across by unstacking
the layer axis.  Every matrix product runs on ``hbp_matmul`` (an MoE
layer's expert products on its batched launches, ``models/moe_layer.py``)
and every attention call on ``flash_attention``; in training their
backward runs on ``hbp_matmul`` (the expert products' on its batched
launches) and ``flash_attention_bwd``.  Over an int8 KV cache (the
policy's attention ``kv_dtype=int8`` variant) decode and continuation
chunks attend through ``flash_attention_int8`` (K1q).  The parameters are
trainable; ``prefill``, ``prefill_chunk`` and ``decode_step`` run under
``torch.no_grad``.

On a mesh of more than one rank (``launch/mesh.py``) the parameters are
this rank's blocks (``planner.place``), and ``models/common.py``'s blocks
insert the collectives: attention runs on this rank's query heads over its
KV heads (``n_heads / tp`` over ``n_kv_heads / tp``), the MLP on its
columns, the tied head on its vocabulary rows; qk-norm and RoPE act on the
local heads, and the cache holds the local KV heads of the rows it is
given.  The model reads all of that from its weights' shapes and keeps no
rank.  Its ``constrain`` sites hold those local shapes to the bound rules
(``core/sharding_hints.py``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sharding_hints import constrain
from repro_torch.models import cache as dcache
from repro_torch.models import common
from repro_torch.models.base import Model, RunOptions, maybe_remat, right_shift
from repro_torch.models.moe_layer import moe_ffn

# leaves that start at zero: the norms' scales (1 + w) and the QKV biases
_ZEROS = ("ln1", "ln2", "q_norm", "k_norm", "final_norm", "bq", "bk", "bv")


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


class DenseLayer(nn.Module):
    """One layer's parameters, with the JAX names and shapes (``dense.py:63-88``):
    the QKV biases under ``qkv_bias``; under ``n_experts`` an f32 ``router``
    (d, E) and the experts' ``e_gate``/``e_up`` (E, d, f) and ``e_down``
    (E, f, d) in place of the SwiGLU MLP's weights."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim_
        p = lambda *shape: common.param(*shape, dtype=dtype, device=device)  # noqa: E731
        self.ln1, self.ln2 = p(d), p(d)
        self.wq, self.wk = p(d, cfg.q_dim), p(d, cfg.kv_dim)
        self.wv, self.wo = p(d, cfg.kv_dim), p(cfg.q_dim, d)
        if cfg.qkv_bias:
            self.bq, self.bk, self.bv = p(cfg.q_dim), p(cfg.kv_dim), p(cfg.kv_dim)
        if cfg.qk_norm:
            self.q_norm, self.k_norm = p(hd), p(hd)
        if cfg.n_experts:
            e, f = cfg.n_experts, cfg.expert_d_ff
            self.router = common.param(d, e, dtype=torch.float32, device=device)
            self.e_gate, self.e_up, self.e_down = p(e, d, f), p(e, d, f), p(e, f, d)
        else:
            self.w_gate, self.w_up = p(d, cfg.d_ff), p(d, cfg.d_ff)
            self.w_down = p(cfg.d_ff, d)


class DenseLM(Model):
    def __init__(self, cfg: ModelConfig, opts: Optional[RunOptions] = None, *,
                 device=None):
        super().__init__(cfg, opts)
        self.device = resolve_device(device)
        dt = cfg.activation_dtype
        self.embed = common.param(cfg.vocab_size, cfg.d_model, dtype=dt, device=self.device)
        self.layers = nn.ModuleList(DenseLayer(cfg, dt, self.device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = common.param(cfg.d_model, dtype=dt, device=self.device)
        if not cfg.tie_embeddings:
            self.lm_head = common.param(cfg.vocab_size, cfg.d_model, dtype=dt, device=self.device)
        self.windows = layer_windows(cfg)
        self.thetas = layer_thetas(cfg)

    # -- params ------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The JAX ``init``'s distributions (``dense.py:57-98``): truncated
        normal over fan-in (``shape[-2]``) for the projections, the experts
        and the f32 router, std 0.02 for the embedding and ``lm_head``,
        zeros for the norms and the QKV biases.  ``jax.random`` cannot be
        reproduced, so the numbers differ from a JAX init with any seed.
        Each leaf is drawn where it lives, in place."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _ZEROS:
                p.zero_()
            elif leaf in ("embed", "lm_head"):
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
        h = common.rms_norm(x, common.weight(layer.ln1), cfg.norm_eps)
        q, k, v = common.qkv_project(h, layer.wq, layer.wk, layer.wv)
        if cfg.qkv_bias:  # after the product, in the activation dtype
            q, k, v = (t + common.weight(bias, keep=0) for t, bias in
                       ((q, layer.bq), (k, layer.bk), (v, layer.bv)))
        # this rank's heads: all of them on one device
        q = constrain(q.reshape(b, s, -1, hd), "batch", "*", "heads", "*")
        k = constrain(k.reshape(b, s, -1, hd), "batch", "*", "kv_heads", "*")
        v = constrain(v.reshape(b, s, -1, hd), "batch", "*", "kv_heads", "*")
        if cfg.qk_norm:  # on the local heads: their gradient sums over them
            tp = common.tp_axes(layer.wq)
            q = common.rms_norm(q, common.weight(layer.q_norm, split=tp), cfg.norm_eps)
            k = common.rms_norm(k, common.weight(layer.k_norm, split=tp), cfg.norm_eps)
        q = common.rotate(q, *rope)
        k = common.rotate(k, *rope)
        if cache is None:
            o = common.attention(q, k, v, causal=True, window=window)
            return x + constrain(common.attn_out_project(o, layer.wo), "batch", "seq", "*")

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
        return x + constrain(common.attn_out_project(o, layer.wo), "batch", "seq", "*")

    def _ffn(self, layer: DenseLayer, x, aux: bool):
        """The FFN sub-block (JAX ``dense.py:182-194``): the SwiGLU MLP, or
        under ``n_experts`` the MoE layer over the (b * s) rows of the call,
        whose router's load-balance term comes back beside the output (None
        for a dense layer, or when ``aux`` is False)."""
        cfg = self.cfg
        h = common.rms_norm(x, common.weight(layer.ln2), cfg.norm_eps)
        if cfg.n_experts:
            b, s, d = h.shape
            y, a = moe_ffn(h.reshape(b * s, d), layer.router, layer.e_gate, layer.e_up,
                           layer.e_down, k=cfg.experts_per_token,
                           capacity_factor=cfg.capacity_factor,
                           dispatch=self.opts.moe_dispatch, n_groups=self.opts.moe_groups,
                           aux=aux)
            return x + y.reshape(b, s, d), a
        return x + common.gated_mlp(h, layer.w_gate, layer.w_up, layer.w_down), None

    def _layer(self, layer: DenseLayer, x, rope, window, *cache_args):
        # the router's aux term is read by the loss only (no cache)
        return self._ffn(layer, self._attn(layer, x, rope, window, *cache_args),
                         aux=not cache_args)

    def _backbone(self, tokens, q_pos, cache: Optional[dcache.LinearKV] = None,
                  write_at=None, q_offset=None, kv_len=None, chunked=False,
                  calib_len=None):
        """The layer stack.  Without a cache (training) each layer is
        rematerialised per ``opts.remat``; with one it writes k/v there.
        Returns the final-normed hidden states and the router's aux term
        summed over the layers (None for a dense model, and with a cache)."""
        cfg = self.cfg
        x = common.embed_lookup(self.embed, tokens).to(cfg.activation_dtype)
        x = constrain(x, "batch", "seq", "*")
        if cfg.scale_embeddings:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
        ropes = {th: common.rope_cos_sin(q_pos, cfg.head_dim_, th)
                 for th in set(self.thetas)}
        layer_fn = self._layer if cache is not None else maybe_remat(self._layer, self.opts)
        aux = None
        for i, layer in enumerate(self.layers):
            cache_args = (() if cache is None else
                          (cache, i, write_at, q_offset, kv_len, chunked, calib_len))
            x, a = layer_fn(layer, x, ropes[self.thetas[i]], self.windows[i], *cache_args)
            if a is not None:
                aux = a if aux is None else aux + a
        return common.rms_norm(x, common.weight(self.final_norm), cfg.norm_eps), aux

    def output_table(self) -> torch.Tensor:
        """The output table: ``embed`` when tied, else ``lm_head``: what
        ``common.greedy`` and ``common.whole_vocab`` read the logits'
        vocabulary block from."""
        return self.embed if self.cfg.tie_embeddings else self.lm_head

    # -- training ------------------------------------------------------------
    def loss(self, batch: dict) -> torch.Tensor:
        """JAX ``dense.py:250-260``: teacher forcing on ``right_shift``ed
        tokens, the chunked cross-entropy over the output table, plus the
        router's aux term summed over the layers (none for a dense model)."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        s = tokens.shape[1]
        pos = torch.arange(s, dtype=torch.int32, device=tokens.device)
        x, aux = self._backbone(right_shift(tokens), pos)
        ce = common.chunked_softmax_xent(x, self.output_table(), labels,
                                         chunk=self.opts.ce_chunk)
        if aux is None:
            return ce
        return ce + cfg.router_aux_weight * aux / max(cfg.n_layers, 1)

    # -- inference -----------------------------------------------------------
    def init_cache(self, batch_size: int, max_len: int) -> dcache.LinearKV:
        """``LinearKV`` cache (layer-stacked slabs, per-row positions),
        int8 with per-(layer, batch, kv_head) f32 scales under the policy's
        attention ``kv_dtype=int8`` variant (JAX ``dense.py:263-275``)."""
        cfg = self.cfg
        dtype, quantized = common.kv_cache_dtype(cfg.activation_dtype)
        # this rank's KV heads (all of them on one device)
        kv_heads = common.kept_width(self.layers[0].wk, 1) // cfg.head_dim_
        return dcache.LinearKV.create(
            (cfg.n_layers,), batch_size, max_len, kv_heads, cfg.head_dim_,
            dtype, device=self.device, quantized=quantized)

    @torch.no_grad()
    def prefill(self, batch: dict, max_len: int):
        tokens = batch["tokens"]
        b, s = tokens.shape
        q_pos = torch.arange(s, dtype=torch.int32, device=self.device)
        kv = self.init_cache(b, max_len)
        q_offset, kv_len = kv.lanes(torch.zeros((), dtype=torch.int32, device=self.device), s)
        x, _ = self._backbone(tokens, q_pos, kv, write_at=0, q_offset=q_offset,
                              kv_len=kv_len)
        logits = common.logits_matmul(x[:, -1], self.output_table())
        pos = torch.full((b,), s, dtype=torch.int32, device=self.device)
        return logits, kv.replace(pos=pos)

    @torch.no_grad()
    def prefill_chunk(self, tokens: torch.Tensor, offset: torch.Tensor,
                      cache: dcache.LinearKV, *, first: bool = False,
                      lens: Optional[torch.Tensor] = None,
                      extras: Optional[dict] = None):
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
        q_offset, kv_len = cache.lanes(offset, s)
        x, _ = self._backbone(tokens, q_pos, cache, write_at=offset, q_offset=q_offset,
                              kv_len=kv_len, chunked=not first,
                              calib_len=s if lens is None else lens)
        logits = common.logits_matmul(dcache.pick_last(x, lens), self.output_table())
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
        q_offset, kv_len = cache.lanes(pos, 1)
        x, _ = self._backbone(tokens, q_pos, cache, write_at=pos,
                              q_offset=q_offset, kv_len=kv_len)
        logits = common.logits_matmul(x[:, -1], self.output_table())
        return logits, cache.replace(pos=(pos + 1).expand(b).contiguous())
