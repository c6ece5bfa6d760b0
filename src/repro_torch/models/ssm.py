"""Mamba-2 (SSD, state-space duality) attention-free LM (``mamba2-370m``):
the counterpart of ``repro/models/ssm.py``.

The SSD chunked algorithm is a two-pass prefix computation: per-chunk
outputs and chunk states (pass 1), then a scan of the chunk states across
chunks (pass 2), here as in JAX a loop over chunks (``lax.scan`` there).
The mixer's ``w_in`` / ``w_out`` products are ``jnp.einsum`` in JAX,
outside the registry, and plain PyTorch products here; the tied logits go
through the registry's ``matmul`` op (K2 on the card): one K2 launch a
decode step, and no attention.  Parameter names follow the JAX tree
(``layers.<i>.<leaf>``); ``A_log``, ``dt_bias`` and ``D`` are f32.
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
from repro_torch.models.hybrid import causal_conv1d

_ZEROS = ("ln", "gn", "final_norm")


def segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q).  Returns (..., Q, Q) with out[..., q, k] = sum_{i=k+1..q}
    a_i for q >= k, -inf otherwise (the log of the decay matrix L)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(q, q, dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, diff, float("-inf"))


def ssd_chunked(x, a, B, C, chunk: int, initial_state=None):
    """SSD forward.  x: (b, l, h, p) inputs, already times dt; a: (b, l, h)
    log-decay per step (dt * A, A negative); B, C: (b, l, n) the state's
    input and output projections (one group, shared by the heads).
    Returns (y (b, l, h, p), final_state (b, h, p, n))."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    if l % chunk:
        raise ValueError(f"ssd_chunked: length {l} is not a multiple of chunk {chunk}")
    c = l // chunk
    xr = x.reshape(b, c, chunk, h, p)
    ar = a.reshape(b, c, chunk, h)
    Br = B.reshape(b, c, chunk, n)
    Cr = C.reshape(b, c, chunk, n)
    a_cum = torch.cumsum(ar, dim=2)  # (b, c, Q, h)

    # 1. intra-chunk (diagonal block) outputs
    L = torch.exp(segsum(ar.permute(0, 1, 3, 2)))  # (b, c, h, Q, Q)
    cb = torch.einsum("bcqn,bckn->bcqk", Cr, Br)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", cb[:, :, None] * L, xr)

    # 2. each chunk's contribution to its final state
    decay_states = torch.exp(a_cum[:, :, -1:, :] - a_cum)  # (b, c, Q, h)
    states = torch.einsum("bckn,bckhp->bchpn", Br, xr * decay_states[..., None])

    # 3. the recurrence over chunk states: each chunk's entering state
    chunk_decay = torch.exp(a_cum[:, :, -1, :])  # (b, c, h)
    s = (initial_state if initial_state is not None
         else torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device))
    entering = []
    for ci in range(c):
        entering.append(s)
        s = chunk_decay[:, ci, :, None, None] * s + states[:, ci]
    s_prev = torch.stack(entering, dim=1)  # (b, c, h, p, n)

    # 4. inter-chunk (off-diagonal) outputs
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cr, s_prev) * torch.exp(a_cum)[..., None]
    return (y_diag + y_off).reshape(b, l, h, p), s


def ssd_decode_step(x, a, B, C, state):
    """Single-token SSD update.  x: (b, h, p); a: (b, h); B, C: (b, n);
    state: (b, h, p, n).  Returns (y (b, h, p), new_state)."""
    decay = torch.exp(a)[..., None, None]
    new_state = decay * state + x[..., None] * B[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", new_state, C)
    return y, new_state


class SSMLayer(nn.Module):
    """One layer's parameters, with the JAX names and shapes
    (``ssm.py:103-115``)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, di, ds, nh = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads
        p = lambda *shape, dt=dtype: common.param(*shape, dtype=dt, device=device)  # noqa: E731
        self.ln = p(d)
        self.w_in = p(d, 2 * di + 2 * ds + nh)
        self.conv_w = p(cfg.conv1d_width, di + 2 * ds)
        self.A_log = p(nh, dt=torch.float32)
        self.dt_bias = p(nh, dt=torch.float32)
        self.D = p(nh, dt=torch.float32)
        self.gn = p(di)
        self.w_out = p(di, d)


class SSMLM(Model):
    def __init__(self, cfg: ModelConfig, opts: Optional[RunOptions] = None, *,
                 device=None):
        super().__init__(cfg, opts)
        self.device = resolve_device(device)
        dt = cfg.activation_dtype
        self.embed = common.param(cfg.vocab_size, cfg.d_model, dtype=dt, device=self.device)
        self.layers = nn.ModuleList(SSMLayer(cfg, dt, self.device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = common.param(cfg.d_model, dtype=dt, device=self.device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The JAX ``init``'s distributions (``ssm.py:93-121``): truncated
        normal over fan-in for the products, scale 0.3 for the conv, 0.02
        for the embedding, zeros for the norms, ``A_log = log(linspace(1,
        16))``, ``dt_bias`` the inverse softplus of a log-spaced 0.001-0.1,
        ``D = 1``."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _ZEROS:
                p.zero_()
            elif leaf == "A_log":
                p.copy_(torch.log(torch.linspace(1.0, 16.0, p.shape[0], device=p.device)))
            elif leaf == "dt_bias":
                dt = torch.exp(torch.linspace(math.log(0.001), math.log(0.1), p.shape[0],
                                              device=p.device))
                p.copy_(torch.log(torch.expm1(dt)))
            elif leaf == "D":
                p.fill_(1.0)
            elif leaf == "embed":
                common.dense_init(p, generator, scale=0.02)
            elif leaf == "conv_w":
                common.dense_init(p, generator, scale=0.3)
            else:
                common.dense_init(p, generator)

    def _chunk(self, b: int, s: int) -> int:
        """The SSD chunk: ``ssm_chunk`` (or the scan planner's block), cut
        to the largest divisor of ``s`` at or below it (JAX ``ssm.py:159-166``)."""
        if self.cfg.ssm_chunk is None:
            from repro_torch.kernels import planner

            chunk = min(planner.plan_scan((b, s), torch.float32)["block"], s)
        else:
            chunk = min(self.cfg.ssm_chunk, s)
        while s % chunk != 0:
            chunk -= 1
        return chunk

    def _mix(self, layer: SSMLayer, x, conv_state=None, ssm_state=None,
             single_step=False, lens=None):
        """The Mamba2 mixer (JAX ``ssm.py:123-179``).  Returns (y,
        new_conv_state, new_ssm_state).  ``lens`` (b,) restricts the state
        update to each row's valid prefix: pad steps get dt = 0 (decay 1,
        zero input: exact SSD identities) and the conv state is sliced at
        the valid tail, so a ``lens = 0`` row's state passes through bit
        for bit."""
        cfg = self.cfg
        b, s, _ = x.shape
        di, ds, nh, hp = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads, cfg.ssm_head_dim
        z, xbc, dt_raw = torch.split(x @ layer.w_in, [di, di + 2 * ds, nh], dim=-1)
        xbc, new_conv = causal_conv1d(xbc, layer.conv_w, conv_state, lens=lens)
        xbc = F.silu(xbc.float()).to(x.dtype)
        xs, B, C = torch.split(xbc, [di, ds, ds], dim=-1)

        dt_v = F.softplus(dt_raw.float() + layer.dt_bias)  # (b, s, nh)
        tok = dcache.token_mask(lens, s)
        if tok is not None:
            dt_v = torch.where(tok[..., None], dt_v, 0.0)
        A = -torch.exp(layer.A_log)
        xh = xs.reshape(b, s, nh, hp).float()
        x_dt = xh * dt_v[..., None]
        a = dt_v * A

        if single_step:
            y, new_ssm = ssd_decode_step(x_dt[:, 0], a[:, 0], B[:, 0].float(),
                                         C[:, 0].float(), ssm_state)
            y = y[:, None]
        else:
            y, new_ssm = ssd_chunked(x_dt, a, B.float(), C.float(), chunk=self._chunk(b, s),
                                     initial_state=ssm_state)
        y = (y + layer.D[:, None] * xh).reshape(b, s, di)
        # gated RMSNorm (Mamba2): norm(y * silu(z))
        y = y * F.silu(z.float())
        y = common.rms_norm(y.to(x.dtype), layer.gn, cfg.norm_eps)
        return y @ layer.w_out, new_conv, new_ssm

    def _backbone(self, tokens, cache: Optional[dcache.StateCarry] = None,
                  single_step=False, lens=None):
        """The layer stack (JAX ``ssm.py:181-207``); without a cache each
        layer is rematerialised per ``opts.remat``.  Returns the final-normed
        hidden states and the cache with new state (None without one)."""
        cfg = self.cfg
        x = common.embed_lookup(self.embed, tokens).to(cfg.activation_dtype)
        if cache is None:
            def layer_fn(layer, x):
                return x + self._mix(layer, common.rms_norm(x, layer.ln, cfg.norm_eps))[0]

            fn = maybe_remat(layer_fn, self.opts)
            for layer in self.layers:
                x = fn(layer, x)
            return common.rms_norm(x, self.final_norm, cfg.norm_eps), None
        convs, ssms = [], []
        for i, layer in enumerate(self.layers):
            y, nc, ns = self._mix(layer, common.rms_norm(x, layer.ln, cfg.norm_eps),
                                  conv_state=cache.states["conv"][i],
                                  ssm_state=cache.states["ssm"][i],
                                  single_step=single_step, lens=lens)
            x = x + y
            convs.append(nc)
            ssms.append(ns)
        new = cache.replace(states={"conv": torch.stack(convs), "ssm": torch.stack(ssms)})
        return common.rms_norm(x, self.final_norm, cfg.norm_eps), new

    def loss(self, batch: dict) -> torch.Tensor:
        tokens, labels = batch["tokens"], batch["labels"]
        x, _ = self._backbone(right_shift(tokens))
        return common.chunked_softmax_xent(x, self.embed, labels, chunk=self.opts.ce_chunk)

    # -- inference: the state is O(1) in the sequence length -----------------
    def init_cache(self, batch_size: int, max_len: int) -> dcache.StateCarry:
        """A bare ``StateCarry`` (JAX ``ssm.py:216-225``): conv tails in the
        activation dtype, SSD states in f32; ``max_len`` plays no part."""
        cfg = self.cfg
        di, ds = cfg.ssm_d_inner, cfg.ssm_state
        L, dev = cfg.n_layers, self.device
        return dcache.StateCarry.create({
            "conv": torch.zeros((L, batch_size, cfg.conv1d_width - 1, di + 2 * ds),
                                dtype=cfg.activation_dtype, device=dev),
            "ssm": torch.zeros((L, batch_size, cfg.ssm_n_heads, cfg.ssm_head_dim, ds),
                               dtype=torch.float32, device=dev),
        })

    @torch.no_grad()
    def prefill(self, batch: dict, max_len: int):
        tokens = batch["tokens"]
        x, cache = self._backbone(tokens, self.init_cache(tokens.shape[0], max_len))
        return common.logits_matmul(x[:, -1], self.embed), cache

    @torch.no_grad()
    def prefill_chunk(self, tokens: torch.Tensor, offset: torch.Tensor,
                      cache: dcache.StateCarry, *, first: bool = False,
                      lens: Optional[torch.Tensor] = None,
                      extras: Optional[dict] = None):
        """Position-free chunked prefill (JAX ``ssm.py:235-245``): the
        carried state is the context, so ``offset`` is ignored and chunks
        continue the scan.  The engine matches the lockstep path exactly
        when chunk boundaries land on multiples of ``cfg.ssm_chunk``."""
        x, cache = self._backbone(tokens, cache, lens=lens)
        return common.logits_matmul(dcache.pick_last(x, lens), self.embed), cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, pos: torch.Tensor,
                    cache: dcache.StateCarry):
        """One token per row; ``pos`` is unused.  Rows that are not
        ``valid`` (parked engine rows) carry their state through."""
        x, cache = self._backbone(tokens, cache, single_step=True,
                                  lens=cache.valid.to(torch.int32))
        return common.logits_matmul(x[:, -1], self.embed), cache
