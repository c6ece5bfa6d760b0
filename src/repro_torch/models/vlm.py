"""Vision-language LM (``llama-3.2-vision-90b``): the counterpart of
``repro/models/vlm.py``.

A decoder LM whose layers come in superblocks of ``cross_attn_every - 1``
self-attention layers and one gated cross-attention layer over image patch
embeddings: 100 layers are 20 superblocks of (4 self + 1 cross).  The
vision frontend is a stub, as in JAX: the model reads precomputed
``image_embeds`` (b, n_image_tokens, d_model).  The JAX model scans the
superblocks over ``self_layers`` stacked twice, ``(n_super, n_self, ...)``,
and ``cross_layers`` stacked once; here they are nested ``nn.ModuleList``s
named after them (``self_layers.<s>.<j>.wq``, ``cross_layers.<s>.xgate_attn``),
which ``repro_torch.checkpoint`` stacks and unstacks.

A cross layer: the query (no RoPE) and the image keys each RMS-normed per
head (``q_norm``, ``k_norm``), non-causal attention over every image token,
and the attention and the MLP each added through ``tanh`` of a scalar gate.
The gates start at zero (JAX ``vlm.py:50-51``), so a freshly drawn model
ignores its image.  Every product runs on the registry's ``matmul`` op (K2)
and every attention on its ``attention`` op (K1 forward, K3 backward).  JAX
serves the cross-attention through ``attention_dense`` (jnp,
``vlm.py:109``), which the port has no counterpart of: it goes to K1 with
no lanes.

The image embeddings are cast to the activation dtype before their k/v
projection.  JAX projects them as given: its Server hands them in f32 and
its Engine stages them in the activation dtype, and on the CPU a bf16
model's projection of f32 embeddings gives f32 k/v there.  At f32, where
the CPU tests run, the two are the same; at bf16 the port's image k/v are
rounded once more.

Serving caches are ``{"self": LinearKV with lead (n_super, n_self), "img":
CrossKV}``; a request's first prefill chunk writes its row's image k/v,
frozen for the request's lifetime (a parked row keeps its slabs).  The
self cache stays in the activation dtype under the int8 ``kv_dtype``
variant, as JAX's ``init_cache`` builds it.  A decode step at 10 layers
launches 67 K2 (7 in each self layer, q, o and three MLP products in each
cross layer, the head) and 10 K1.
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

_ZEROS = ("ln1", "ln2", "final_norm", "xgate_attn", "xgate_ffn", "q_norm", "k_norm")


class SelfLayer(nn.Module):
    """A self-attention layer's parameters (JAX ``vlm.py:33-46``)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        p = lambda *shape: common.param(*shape, dtype=dtype, device=device)  # noqa: E731
        self.ln1, self.ln2 = p(d), p(d)
        self.wq, self.wk = p(d, cfg.q_dim), p(d, cfg.kv_dim)
        self.wv, self.wo = p(d, cfg.kv_dim), p(cfg.q_dim, d)
        self.w_gate, self.w_up = p(d, cfg.d_ff), p(d, cfg.d_ff)
        self.w_down = p(cfg.d_ff, d)


class CrossLayer(SelfLayer):
    """A cross-attention layer (JAX ``vlm.py:48-54``): a self layer's
    leaves plus the scalar gates and the per-head query and key norms."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__(cfg, dtype, device)
        p = lambda *shape: common.param(*shape, dtype=dtype, device=device)  # noqa: E731
        self.xgate_attn, self.xgate_ffn = p(), p()
        self.q_norm, self.k_norm = p(cfg.head_dim_), p(cfg.head_dim_)


class VisionLM(Model):
    def __init__(self, cfg: ModelConfig, opts: Optional[RunOptions] = None, *,
                 device=None):
        super().__init__(cfg, opts)
        self.device = resolve_device(device)
        dt, dev, d = cfg.activation_dtype, self.device, cfg.d_model
        self.n_super = cfg.n_layers // cfg.cross_attn_every
        self.n_self = cfg.cross_attn_every - 1
        self.embed = common.param(cfg.vocab_size, d, dtype=dt, device=dev)
        self.self_layers = nn.ModuleList(
            nn.ModuleList(SelfLayer(cfg, dt, dev) for _ in range(self.n_self))
            for _ in range(self.n_super))
        self.cross_layers = nn.ModuleList(CrossLayer(cfg, dt, dev)
                                          for _ in range(self.n_super))
        self.final_norm = common.param(d, dtype=dt, device=dev)
        self.lm_head = common.param(cfg.vocab_size, d, dtype=dt, device=dev)

    # -- params ------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The JAX ``init``'s distributions (``vlm.py:27-66``): truncated
        normal over fan-in for the projections, std 0.02 for ``embed`` and
        ``lm_head``, zeros for the norms and the gates.  The numbers differ
        from a JAX init with any seed."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _ZEROS:
                p.zero_()
            elif leaf in ("embed", "lm_head"):
                common.dense_init(p, generator, scale=0.02)
            else:
                common.dense_init(p, generator)

    # -- blocks --------------------------------------------------------------
    def _heads(self, x, n):
        b, s, _ = x.shape
        return x.reshape(b, s, n, self.cfg.head_dim_)

    def _self_attn_block(self, pl: SelfLayer, x, rope, cache=None, li=None, write_at=None,
                         q_offset=None, kv_len=None, chunked=False):
        """JAX ``vlm.py:69-94``.  With ``cache`` the fresh k/v go into the
        slabs of layer ``li`` = (superblock, index) at ``write_at``; decode
        and continuation chunks attend the cache at ``q_offset``/``kv_len``,
        prefill, first chunks and training the fresh k/v."""
        cfg = self.cfg
        h = common.rms_norm(x, pl.ln1, cfg.norm_eps)
        q, k, v = common.qkv_project(h, pl.wq, pl.wk, pl.wv)
        q = common.rotate(self._heads(q, cfg.n_heads), *rope)
        k = common.rotate(self._heads(k, cfg.n_kv_heads), *rope)
        o = common.cached_self_attention(q, k, self._heads(v, cfg.n_kv_heads), cache, li,
                                         write_at, q_offset, kv_len, chunked)
        x = x + common.attn_out_project(o, pl.wo)
        h = common.rms_norm(x, pl.ln2, cfg.norm_eps)
        return x + common.gated_mlp(h, pl.w_gate, pl.w_up, pl.w_down)

    def _cross_attn_block(self, pl: CrossLayer, x, img_k, img_v):
        """JAX ``vlm.py:96-115``: ``img_k``/``img_v`` (b, n_img, kvh, hd)."""
        cfg = self.cfg
        h = common.rms_norm(x, pl.ln1, cfg.norm_eps)
        q = common.rms_norm(self._heads(common.project(h, pl.wq), cfg.n_heads),
                            pl.q_norm, cfg.norm_eps)
        o = common.attn_out_project(common.attention(q, img_k, img_v, causal=False), pl.wo)
        x = x + torch.tanh(pl.xgate_attn.float()).to(x.dtype) * o
        h = common.rms_norm(x, pl.ln2, cfg.norm_eps)
        m = common.gated_mlp(h, pl.w_gate, pl.w_up, pl.w_down)
        return x + torch.tanh(pl.xgate_ffn.float()).to(x.dtype) * m

    def _image_kv(self, pl: CrossLayer, img):
        """One cross layer's image k/v (JAX ``vlm.py:117-126``); ``k`` is
        RMS-normed per head by ``k_norm``."""
        cfg = self.cfg
        img = img.to(self.device, cfg.activation_dtype)
        k = self._heads(common.project(img, pl.wk), cfg.n_kv_heads)
        v = self._heads(common.project(img, pl.wv), cfg.n_kv_heads)
        return common.rms_norm(k, pl.k_norm, cfg.norm_eps), v

    def _superblock(self, sb: int, x, rope, img=None, cache=None, **cache_kw):
        """The superblock ``sb`` (JAX ``vlm.py:134-156``): its self layers,
        then its cross layer over the image k/v, computed from ``img``
        (training) or read from ``cache["img"]``."""
        for j, pl in enumerate(self.self_layers[sb]):
            if cache is None:
                x = self._self_attn_block(pl, x, rope)
            else:
                x = self._self_attn_block(pl, x, rope, cache["self"], (sb, j), **cache_kw)
        plc = self.cross_layers[sb]
        if cache is None:
            ik, iv = self._image_kv(plc, img)
        else:
            ik, iv = cache["img"].k[sb], cache["img"].v[sb]
        return self._cross_attn_block(plc, x, ik, iv)

    def _backbone(self, tokens, q_pos, img=None, cache=None, **cache_kw):
        cfg = self.cfg
        x = common.embed_lookup(self.embed, tokens).to(cfg.activation_dtype)
        rope = common.rope_cos_sin(q_pos, cfg.head_dim_, cfg.rope_theta)
        if cache is None:
            fn = maybe_remat(self._superblock, self.opts)
            for sb in range(self.n_super):
                x = fn(sb, x, rope, img)
        else:
            for sb in range(self.n_super):
                x = self._superblock(sb, x, rope, cache=cache, **cache_kw)
        return common.rms_norm(x, self.final_norm, cfg.norm_eps)

    def _write_image_kv(self, img_cache: dcache.CrossKV, img, live=None):
        """Every cross layer's image k/v of ``img``, written into
        ``img_cache`` in place; with ``live`` (b,) bool only those rows (JAX
        ``vlm.py:222-232``: the others keep their slabs)."""
        for sb, plc in enumerate(self.cross_layers):
            img_cache.write(sb, *self._image_kv(plc, img), live)

    # -- training ------------------------------------------------------------
    def loss(self, batch: dict) -> torch.Tensor:
        """JAX ``vlm.py:160-167``: teacher forcing on the ``right_shift``ed
        tokens with the image k/v computed in each superblock, the chunked
        cross-entropy over ``lm_head``."""
        tokens = batch["tokens"]
        pos = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
        x = self._backbone(right_shift(tokens), pos, batch["image_embeds"])
        return common.chunked_softmax_xent(x, self.lm_head, batch["labels"],
                                           chunk=self.opts.ce_chunk)

    # -- inference -----------------------------------------------------------
    def init_cache(self, batch_size: int, max_len: int) -> dict:
        """``{"self": LinearKV (n_super, n_self) lead, "img": CrossKV}`` (JAX
        ``vlm.py:170-181``)."""
        cfg = self.cfg
        dt, dev = cfg.activation_dtype, self.device
        return {
            "self": dcache.LinearKV.create((self.n_super, self.n_self), batch_size, max_len,
                                           cfg.n_kv_heads, cfg.head_dim_, dt, device=dev),
            "img": dcache.CrossKV.create((self.n_super,), batch_size, cfg.n_image_tokens,
                                         cfg.n_kv_heads, cfg.head_dim_, dt, device=dev),
        }

    @torch.no_grad()
    def prefill(self, batch: dict, max_len: int):
        """The whole prompt at once (JAX ``vlm.py:188-206``)."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache = self.init_cache(b, max_len)
        self._write_image_kv(cache["img"], batch["image_embeds"])
        q_pos = torch.arange(s, dtype=torch.int32, device=self.device)
        x = self._backbone(tokens, q_pos, cache=cache, write_at=0)
        logits = common.logits_matmul(x[:, -1], self.lm_head)
        pos = torch.full((b,), s, dtype=torch.int32, device=self.device)
        return logits, {"self": cache["self"].replace(pos=pos), "img": cache["img"]}

    @torch.no_grad()
    def prefill_chunk(self, tokens: torch.Tensor, offset: torch.Tensor, cache: dict, *,
                      first: bool = False, lens: Optional[torch.Tensor] = None,
                      extras: Optional[dict] = None):
        """Chunked prefill (JAX ``vlm.py:208-240``): the first chunk writes
        each live row's image k/v from ``extras["image_embeds"]`` (``lens ==
        0`` rows keep theirs); every chunk writes its self k/v at the
        per-row ``offset`` and attends causally, a continuation the cache
        prefix."""
        b, s = tokens.shape
        offset = offset.to(torch.int32)
        if first:
            live = None if lens is None else lens > 0
            self._write_image_kv(cache["img"], extras["image_embeds"], live)
        q_pos = (offset[:, None] if offset.dim() else offset) + torch.arange(
            s, dtype=torch.int32, device=self.device)
        q_offset, kv_len = cache["self"].lanes(offset, s)
        x = self._backbone(tokens, q_pos, cache=cache, write_at=offset, q_offset=q_offset,
                           kv_len=kv_len, chunked=not first)
        logits = common.logits_matmul(dcache.pick_last(x, lens), self.lm_head)
        new_pos = offset + (s if lens is None else lens.to(torch.int32))
        return logits, {"self": cache["self"].replace(pos=new_pos.expand(b).contiguous()),
                        "img": cache["img"]}

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, pos: torch.Tensor, cache: dict):
        """One token per row at ``pos`` (scalar: lockstep; (b,): per row)
        (JAX ``vlm.py:242-258``)."""
        b = tokens.shape[0]
        pos = pos.to(torch.int32)
        q_pos = pos[:, None] if pos.dim() else pos.reshape(1)
        q_offset, kv_len = cache["self"].lanes(pos, 1)
        x = self._backbone(tokens, q_pos, cache=cache, write_at=pos, q_offset=q_offset,
                           kv_len=kv_len)
        logits = common.logits_matmul(x[:, -1], self.lm_head)
        return logits, {"self": cache["self"].replace(pos=(pos + 1).expand(b).contiguous()),
                        "img": cache["img"]}

    def batch_extras_specs(self, batch_size: int, seq_len: int) -> dict[str, TensorSpec]:
        cfg = self.cfg
        return {"image_embeds": TensorSpec((batch_size, cfg.n_image_tokens, cfg.d_model),
                                           cfg.activation_dtype)}
