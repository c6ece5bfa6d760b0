"""Encoder-decoder LM (``seamless-m4t-large-v2``): the counterpart of
``repro/models/encdec.py``.

The speech frontend is a stub, as in JAX: the encoder reads precomputed
frame embeddings ``audio_frames`` (b, enc_len, d_model), cast to the
activation dtype.  Encoder layers: bidirectional self-attention (RoPE) and
a SwiGLU MLP.  Decoder layers: causal self-attention (RoPE), cross-attention
over the encoder output (no RoPE), SwiGLU MLP.  The JAX model scans the
stacked ``encoder`` and ``decoder`` trees; here they are ``nn.ModuleList``s
named after them (``encoder.<i>.attn.wq``, ``decoder.<i>.cross_attn.wv``,
``decoder.<i>.mlp.w_up``), which ``repro_torch.checkpoint`` stacks and
unstacks.

Every product runs on the registry's ``matmul`` op (K2 on the card) and
every attention on its ``attention`` op: K1 forward and K3 backward, the
decoder's self-attention causal over its cache, the encoder's and the
cross-attention non-causal over every key, with no lanes.  JAX serves the
cross-attention through ``attention_dense`` (jnp, ``encdec.py:145``) and
trains it through the kernel route; the port has no jnp route, so both go
to K1 (and K3).  At f32 the two agree to rounding; at bf16 K1 rounds P to
bf16, so bf16 is held to a logits tolerance only.

Serving caches are ``{"self": LinearKV, "cross": CrossKV}``: the encoder
runs at a request's first prefill chunk, which writes the row's
cross-attention k/v, frozen for the request's lifetime (a parked row,
``lens == 0``, keeps its slabs bit for bit); ``CrossKV`` holds
``enc_len(max_len)`` keys.  The self cache stays in the activation dtype
under the int8 ``kv_dtype`` variant, as JAX's ``init_cache`` builds it.

A decode step launches 217 K2 (q, k, v, o, cross q, cross o and three MLP
products in each of the 24 decoder layers, and the head) and 48 K1 (24
self, 24 cross).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import cache as dcache
from repro_torch.models import common
from repro_torch.models.base import Model, RunOptions, TensorSpec, maybe_remat, right_shift

_ZEROS = ("ln1", "ln2", "ln3", "enc_norm", "final_norm")


class AttnParams(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        p = lambda *shape: common.param(*shape, dtype=dtype, device=device)  # noqa: E731
        self.wq, self.wk = p(d, cfg.q_dim), p(d, cfg.kv_dim)
        self.wv, self.wo = p(d, cfg.kv_dim), p(cfg.q_dim, d)


class MLPParams(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        p = lambda *shape: common.param(*shape, dtype=dtype, device=device)  # noqa: E731
        self.w_gate, self.w_up, self.w_down = p(d, f), p(d, f), p(f, d)


class EncLayer(nn.Module):
    """An encoder layer (JAX ``encdec.py:40-43``)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = common.param(cfg.d_model, dtype=dtype, device=device)
        self.ln2 = common.param(cfg.d_model, dtype=dtype, device=device)
        self.attn = AttnParams(cfg, dtype, device)
        self.mlp = MLPParams(cfg, dtype, device)


class DecLayer(nn.Module):
    """A decoder layer (JAX ``encdec.py:45-51``)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        p = lambda: common.param(cfg.d_model, dtype=dtype, device=device)  # noqa: E731
        self.ln1, self.ln2, self.ln3 = p(), p(), p()
        self.self_attn = AttnParams(cfg, dtype, device)
        self.cross_attn = AttnParams(cfg, dtype, device)
        self.mlp = MLPParams(cfg, dtype, device)


class EncDecLM(Model):
    def __init__(self, cfg: ModelConfig, opts: Optional[RunOptions] = None, *,
                 device=None):
        super().__init__(cfg, opts)
        self.device = resolve_device(device)
        dt, dev, d = cfg.activation_dtype, self.device, cfg.d_model
        self.embed = common.param(cfg.vocab_size, d, dtype=dt, device=dev)
        self.encoder = nn.ModuleList(EncLayer(cfg, dt, dev) for _ in range(cfg.encoder_layers))
        self.decoder = nn.ModuleList(DecLayer(cfg, dt, dev) for _ in range(cfg.n_layers))
        self.enc_norm = common.param(d, dtype=dt, device=dev)
        self.final_norm = common.param(d, dtype=dt, device=dev)
        self.lm_head = common.param(cfg.vocab_size, d, dtype=dt, device=dev)

    # -- params ------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The JAX ``init``'s distributions (``encdec.py:19-58``): truncated
        normal over fan-in for the projections, std 0.02 for ``embed`` and
        ``lm_head``, zeros for the norms.  The numbers differ from a JAX
        init with any seed."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _ZEROS:
                p.zero_()
            elif leaf in ("embed", "lm_head"):
                common.dense_init(p, generator, scale=0.02)
            else:
                common.dense_init(p, generator)

    # -- attention helpers ---------------------------------------------------
    def _heads(self, x, n):
        b, s, _ = x.shape
        return x.reshape(b, s, n, self.cfg.head_dim_)

    def _cross_kv(self, pa: AttnParams, enc_out):
        """One decoder layer's cross-attention k/v of the encoder output."""
        cfg = self.cfg
        return (self._heads(common.project(enc_out, pa.wk), cfg.n_kv_heads),
                self._heads(common.project(enc_out, pa.wv), cfg.n_kv_heads))

    def _enc_layer(self, layer: EncLayer, x, rope):
        cfg = self.cfg
        h = common.rms_norm(x, layer.ln1, cfg.norm_eps)
        q, k, v = common.qkv_project(h, layer.attn.wq, layer.attn.wk, layer.attn.wv)
        q = common.rotate(self._heads(q, cfg.n_heads), *rope)
        k = common.rotate(self._heads(k, cfg.n_kv_heads), *rope)
        o = common.attention(q, k, self._heads(v, cfg.n_kv_heads), causal=False)
        x = x + common.attn_out_project(o, layer.attn.wo)
        h = common.rms_norm(x, layer.ln2, cfg.norm_eps)
        return x + common.gated_mlp(h, layer.mlp.w_gate, layer.mlp.w_up, layer.mlp.w_down)

    def _encoder(self, frames):
        """frames (b, enc_len, d) -> the normed encoder output (JAX
        ``encdec.py:84-104``)."""
        cfg = self.cfg
        x = frames.to(self.device, cfg.activation_dtype)
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=self.device)
        rope = common.rope_cos_sin(pos, cfg.head_dim_, cfg.rope_theta)
        fn = maybe_remat(self._enc_layer, self.opts)
        for layer in self.encoder:
            x = fn(layer, x, rope)
        return common.rms_norm(x, self.enc_norm, cfg.norm_eps)

    def _dec_layer(self, layer: DecLayer, x, rope, enc_out=None, cross=None, li=None,
                   cache=None, write_at=None, q_offset=None, kv_len=None, chunked=False):
        """A decoder layer (JAX ``encdec.py:113-156``).  With ``cache`` the
        fresh self k/v go into layer ``li``'s slabs at ``write_at``, decode
        and continuation chunks attend the cache at ``q_offset``/``kv_len``
        and the cross-attention reads ``cross``'s frozen k/v; without one
        (training) it attends the fresh k/v and projects ``enc_out``."""
        cfg = self.cfg
        pa = layer.self_attn
        h = common.rms_norm(x, layer.ln1, cfg.norm_eps)
        q, k, v = common.qkv_project(h, pa.wq, pa.wk, pa.wv)
        q = common.rotate(self._heads(q, cfg.n_heads), *rope)
        k = common.rotate(self._heads(k, cfg.n_kv_heads), *rope)
        o = common.cached_self_attention(q, k, self._heads(v, cfg.n_kv_heads), cache, li,
                                         write_at, q_offset, kv_len, chunked)
        x = x + common.attn_out_project(o, pa.wo)

        pc = layer.cross_attn
        h = common.rms_norm(x, layer.ln2, cfg.norm_eps)
        xq = self._heads(common.project(h, pc.wq), cfg.n_heads)
        xk, xv = (cross.k[li], cross.v[li]) if cross is not None else self._cross_kv(pc, enc_out)
        o = common.attention(xq, xk, xv, causal=False)
        x = x + common.attn_out_project(o, pc.wo)

        h = common.rms_norm(x, layer.ln3, cfg.norm_eps)
        return x + common.gated_mlp(h, layer.mlp.w_gate, layer.mlp.w_up, layer.mlp.w_down)

    def _decoder(self, tokens, q_pos, enc_out=None, cache=None, **cache_kw):
        cfg = self.cfg
        x = common.embed_lookup(self.embed, tokens).to(cfg.activation_dtype)
        rope = common.rope_cos_sin(q_pos, cfg.head_dim_, cfg.rope_theta)
        if cache is None:
            fn = maybe_remat(self._dec_layer, self.opts)
            for layer in self.decoder:
                x = fn(layer, x, rope, enc_out)
        else:
            for i, layer in enumerate(self.decoder):
                x = self._dec_layer(layer, x, rope, cross=cache["cross"], li=i,
                                    cache=cache["self"], **cache_kw)
        return common.rms_norm(x, self.final_norm, cfg.norm_eps)

    def _write_cross(self, cross: dcache.CrossKV, frames, live=None):
        """Run the encoder on ``frames`` and write every decoder layer's
        cross k/v into ``cross``, in place; with ``live`` (b,) bool only
        those rows (JAX ``encdec.py:238-248``: the others keep their
        slabs)."""
        enc_out = self._encoder(frames)
        for i, layer in enumerate(self.decoder):
            cross.write(i, *self._cross_kv(layer.cross_attn, enc_out), live)

    # -- training ------------------------------------------------------------
    def loss(self, batch: dict) -> torch.Tensor:
        """JAX ``encdec.py:173-181``: the encoder over ``audio_frames``, the
        decoder over the ``right_shift``ed tokens, the chunked
        cross-entropy over ``lm_head``."""
        tokens = batch["tokens"]
        pos = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
        enc_out = self._encoder(batch["audio_frames"])
        x = self._decoder(right_shift(tokens), pos, enc_out)
        return common.chunked_softmax_xent(x, self.lm_head, batch["labels"],
                                           chunk=self.opts.ce_chunk)

    # -- inference -----------------------------------------------------------
    def enc_len(self, seq_len: int) -> int:
        return max(int(seq_len * self.cfg.encoder_len_ratio), 16)

    def init_cache(self, batch_size: int, max_len: int, enc_len: Optional[int] = None) -> dict:
        """``{"self": LinearKV, "cross": CrossKV}`` (JAX ``encdec.py:197-207``),
        the cross cache ``enc_len(max_len)`` keys deep unless told."""
        cfg = self.cfg
        dt, dev = cfg.activation_dtype, self.device
        enc = self.enc_len(max_len) if enc_len is None else enc_len
        return {
            "self": dcache.LinearKV.create((cfg.n_layers,), batch_size, max_len,
                                           cfg.n_kv_heads, cfg.head_dim_, dt, device=dev),
            "cross": dcache.CrossKV.create((cfg.n_layers,), batch_size, enc,
                                           cfg.n_kv_heads, cfg.head_dim_, dt, device=dev),
        }

    @torch.no_grad()
    def prefill(self, batch: dict, max_len: int):
        """The whole prompt at once (JAX ``encdec.py:209-227``): the cross
        cache holds as many keys as ``audio_frames`` has frames."""
        tokens, frames = batch["tokens"], batch["audio_frames"]
        b, s = tokens.shape
        cache = self.init_cache(b, max_len, enc_len=frames.shape[1])
        self._write_cross(cache["cross"], frames)
        q_pos = torch.arange(s, dtype=torch.int32, device=self.device)
        x = self._decoder(tokens, q_pos, cache=cache, write_at=0)
        logits = common.logits_matmul(x[:, -1], self.lm_head)
        pos = torch.full((b,), s, dtype=torch.int32, device=self.device)
        return logits, {"self": cache["self"].replace(pos=pos), "cross": cache["cross"]}

    @torch.no_grad()
    def prefill_chunk(self, tokens: torch.Tensor, offset: torch.Tensor, cache: dict, *,
                      first: bool = False, lens: Optional[torch.Tensor] = None,
                      extras: Optional[dict] = None):
        """Chunked prefill (JAX ``encdec.py:229-261``): the first chunk runs
        the encoder over ``extras["audio_frames"]`` and writes each live
        row's cross k/v (``lens == 0`` rows keep theirs); every chunk writes
        its self k/v at the per-row ``offset`` and attends causally, a
        continuation the cache prefix."""
        b, s = tokens.shape
        offset = offset.to(torch.int32)
        if first:
            live = None if lens is None else lens > 0
            self._write_cross(cache["cross"], extras["audio_frames"], live)
        q_pos = (offset[:, None] if offset.dim() else offset) + torch.arange(
            s, dtype=torch.int32, device=self.device)
        q_offset, kv_len = cache["self"].lanes(offset, s)
        x = self._decoder(tokens, q_pos, cache=cache, write_at=offset, q_offset=q_offset,
                          kv_len=kv_len, chunked=not first)
        logits = common.logits_matmul(dcache.pick_last(x, lens), self.lm_head)
        new_pos = offset + (s if lens is None else lens.to(torch.int32))
        return logits, {"self": cache["self"].replace(pos=new_pos.expand(b).contiguous()),
                        "cross": cache["cross"]}

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, pos: torch.Tensor, cache: dict):
        """One token per row at ``pos`` (scalar: lockstep; (b,): per row),
        attending the self cache through the kernel's lanes and the frozen
        cross cache whole (JAX ``encdec.py:263-275``)."""
        b = tokens.shape[0]
        pos = pos.to(torch.int32)
        q_pos = pos[:, None] if pos.dim() else pos.reshape(1)
        q_offset, kv_len = cache["self"].lanes(pos, 1)
        x = self._decoder(tokens, q_pos, cache=cache, write_at=pos, q_offset=q_offset,
                          kv_len=kv_len)
        logits = common.logits_matmul(x[:, -1], self.lm_head)
        return logits, {"self": cache["self"].replace(pos=(pos + 1).expand(b).contiguous()),
                        "cross": cache["cross"]}

    def batch_extras_specs(self, batch_size: int, seq_len: int) -> dict[str, TensorSpec]:
        return {"audio_frames": TensorSpec(
            (batch_size, self.enc_len(seq_len), self.cfg.d_model), self.cfg.activation_dtype)}
