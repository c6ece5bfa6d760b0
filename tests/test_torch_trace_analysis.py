"""The port's step analysis (``launch/trace_analysis.py``) against the JAX
package's HLO analysis (``repro.launch.hlo_analysis.analyze`` of the same
step jitted and compiled on the CPU), on ``qwen3-1.7b``'s smoke config
(2 layers, d 64, 4 / 2 heads of 16, FFN 128, vocab 256, bf16) at batch 2
and 64 positions.

The decode and prefill steps' FLOPs must be equal: both count every
product from its shapes and the attention over every key slot (masked ones
included), so each equals the analytic count.  The training step's FLOPs
differ by three terms, each a recomputation that one side makes and the
other does not (see ``test_train_step_flops_differ_from_jax_by_three_terms``).
"""
import importlib

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch import hlo_analysis  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import trace_analysis  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

ARCH, B, S = "qwen3-1.7b", 2, 64


@pytest.fixture(scope="module")
def jax_counts():
    """JAX's FLOPs of the three steps, from the compiled HLO."""
    jm = jax_build(jax_smoke(ARCH))
    params = jm.init(jax.random.key(0))
    toks = jnp.zeros((B, S), jnp.int32)
    decode = jax.jit(jax_steps.make_decode_step(jm)).lower(
        params, jnp.zeros((B, 1), jnp.int32), jnp.int32(5), jm.init_cache(B, S))
    prefill = jax.jit(jax_steps.make_prefill_step(jm, S)).lower(params, {"tokens": toks})
    train = jax.jit(jax_steps.make_train_step(jm)).lower(
        params, jax_adamw_init(params), {"tokens": toks, "labels": toks})
    return {name: hlo_analysis.analyze(low.compile().as_text()).flops
            for name, low in (("decode", decode), ("prefill", prefill), ("train", train))}


@pytest.fixture(scope="module")
def port_model():
    model = build_model(get_smoke_config(ARCH), device="cpu")
    model.init(torch.Generator().manual_seed(0))
    return model


def _decode_stats(model):
    with torch.no_grad():
        cache = model.init_cache(B, S)
        return trace_analysis.analyze(model.decode_step,
                                      torch.zeros((B, 1), dtype=torch.int32,
                                                  device=model.device),
                                      torch.tensor(5, dtype=torch.int32, device=model.device),
                                      cache)


def test_decode_step_flops_equal_jax(jax_counts, port_model):
    stats = _decode_stats(port_model)
    assert stats.flops == jax_counts["decode"] == 425_984
    assert stats.aten_flops == 0 and stats.kernel_flops == stats.flops
    # 2 layers x 7 products + the tied logits, 2 attention calls
    assert stats.ops["matmul"]["count"] == 15 and stats.ops["attention"]["count"] == 2
    assert stats.hbm_bytes > 0 and stats.collective_bytes == 0 and stats.collectives == {}
    d = stats.as_dict()
    assert set(d) == {"flops", "hbm_bytes", "collective_bytes", "collectives", "n_while",
                      "unknown_trip_counts"}


def test_prefill_step_flops_equal_jax(jax_counts, port_model):
    with torch.no_grad():
        stats = trace_analysis.analyze(port_model.prefill,
                                       {"tokens": torch.zeros((B, S), dtype=torch.int32)}, S)
    assert stats.flops == jax_counts["prefill"] == 23_134_208


def test_counts_equal_on_meta(port_model):
    """The dry run traces on ``meta``: the kernel ops' shape-only outputs
    give the same count as the CPU's plain versions."""
    meta = build_model(get_smoke_config(ARCH), device="meta")
    assert _decode_stats(meta).flops == _decode_stats(port_model).flops


def test_train_step_flops_differ_from_jax_by_three_terms(jax_counts, port_model):
    """One training step (batch 2 x 64, T = 128 tokens, per-layer remat as
    both packages default to) counts ``port = JAX + 10,485,760``, three
    recomputations, term by term (L = 2 layers, b h hd = 2 x 4 x 16, d 64,
    FFN f 128, vocab V 256):

    1. K3, the port's attention backward, recomputes the scores ``Q Kᵀ``
       from the saved ``lse`` (``flash_attention_bwd``); JAX's autodiff of
       its rematerialized forward reuses the recomputed probabilities:
       ``2 b h s² hd`` a layer, 2 x 1,048,576 = 2,097,152.
    2. The port checkpoints each cross-entropy chunk, so the tied logits
       product runs again in the backward; XLA keeps the forward's logits:
       ``2 T d V`` = 4,194,304.
    3. ``torch.utils.checkpoint`` recomputes the whole layer, its FFN down
       projection too, whose output no gradient needs; XLA drops that dead
       product from the rematerialized forward: ``2 T f d`` a layer,
       2 x 2,097,152 = 4,194,304.

    (JAX's 100,663,296 is also ~25M over the ~75.5M analytic count of
    forward + 2x backward: the remat's recomputed forward.)"""
    step = make_train_step(port_model)
    opt = adamw_init(dict(port_model.named_parameters()))
    toks = torch.zeros((B, S), dtype=torch.int32)
    stats = trace_analysis.analyze(step, opt, {"tokens": toks, "labels": toks})
    cfg = get_smoke_config(ARCH)
    L, T, d, f, V = cfg.n_layers, B * S, cfg.d_model, cfg.d_ff, cfg.vocab_size
    scores = 2 * B * cfg.n_heads * S * S * cfg.head_dim_ * L
    logits = 2 * T * d * V
    down = 2 * T * f * d * L
    assert (scores, logits, down) == (2_097_152, 4_194_304, 4_194_304)
    assert jax_counts["train"] == 100_663_296
    assert stats.flops == jax_counts["train"] + scores + logits + down


def test_collectives_follow_jax_ring_models():
    """A c10d all-reduce over a one-rank group moves no bytes (ring factor
    (n - 1) / n = 0); the op is counted with its payload."""
    from repro_torch.launch.mesh import make_debug_mesh

    make_debug_mesh(device="cpu")  # the world-size-1 process group
    x = torch.ones(256)
    stats = trace_analysis.analyze(lambda: torch.ops._c10d_functional.wait_tensor(
        torch.ops._c10d_functional.all_reduce(x, "sum", "0")))
    assert stats.collective_bytes == 0
    assert stats.collectives["all-reduce"]["count"] == 1
    assert stats.collectives["all-reduce"]["payload_bytes"] == 1024


def test_roofline_terms():
    stats = trace_analysis.HloStats(flops=989e12, hbm_bytes=3.35e12 * 2, collective_bytes=0)
    r = trace_analysis.roofline(stats, 989e12, 3.35e12, 450e9)
    assert r == {"compute_s": 1.0, "memory_s": 2.0, "collective_s": 0.0, "dominant": "memory_s"}


def test_kernel_entries_are_restored():
    """The analysis wraps the kernels' entry functions for its own call
    only."""
    mods = [importlib.import_module(f"repro_torch.kernels.{m}")
            for m in ("hbp_matmul", "flash_attention")]
    before = (mods[0].hbp_matmul, mods[1].flash_attention, mods[1].flash_attention_bwd)
    n = before[0].launches

    def call():
        out = mods[0].hbp_matmul(torch.ones(2, 3), torch.ones(3, 4))
        # a wrapper counts its launches through its module global, as on the card
        mods[0].hbp_matmul.launches += 1
        return out

    stats = trace_analysis.analyze(call)
    assert stats.ops["matmul"] == {"count": 1, "flops": 48.0, "bytes": 104.0}
    assert (mods[0].hbp_matmul, mods[1].flash_attention, mods[1].flash_attention_bwd) == before
    assert before[0].launches == n + 1
    before[0].launches = n


def test_meta_train_step_tracks_allocations():
    """On ``meta`` the step's own allocations are tracked: the peak holds at
    least the gradients the backward makes (one a parameter, its dtype)."""
    meta = build_model(get_smoke_config(ARCH), device="meta")
    step = make_train_step(meta)
    opt = adamw_init(dict(meta.named_parameters()))
    toks = torch.empty((B, S), dtype=torch.int32, device="meta")
    stats = trace_analysis.analyze(step, opt, {"tokens": toks, "labels": toks},
                                   allocations=True)
    grads = sum(p.numel() * p.element_size() for p in meta.parameters())
    assert stats.peak_alloc_bytes >= grads
