"""The port's model blocks and DenseLM against the JAX package's, on the
CPU (the wrappers run their plain versions there).

Inputs are made from a seed with numpy; the JAX side is computed once per
module.  Model parity runs the ``qwen3-1.7b`` smoke config at f32 with the
JAX parameters carried across by ``params_from_numpy``.  Tolerances: f32,
atol 1e-5 on blocks and 2e-5 on logits (two layers of matmuls summed in a
different order on each side).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import cache as jax_cache  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models.base import RunOptions  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.configs import ModelConfig, get_config, get_smoke_config, reduced  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import cache as pt_cache  # noqa: E402
from repro_torch.models import common as pt_common  # noqa: E402

ATOL = 1e-5
LOGITS_ATOL = 2e-5
B, PLEN, MAX_LEN = 2, 6, 16


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_cfg(jax_cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jax_cfg))


def _jax_model(jcfg, seed):
    """The JAX DenseLM with its params, and its jitted prefill and decode
    (jit compiles the layer scan once instead of dispatching op by op)."""
    jm = jax_build(jcfg, RunOptions(remat="none"))
    params = jax.jit(jm.init)(jax.random.key(seed))
    prefill = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, MAX_LEN))
    return jm, params, prefill, jax.jit(jm.decode_step)


@pytest.fixture(scope="module")
def dense():
    """JAX DenseLM prefill / decode references on the f32 smoke config, and
    the port's DenseLM holding the same parameters."""
    jcfg = dataclasses.replace(jax_smoke("qwen3-1.7b"), dtype="float32")
    jm, params, prefill, decode = _jax_model(jcfg, 0)
    toks = np.random.default_rng(0).integers(3, jcfg.vocab_size, (B, PLEN)).astype(np.int32)
    logits, cache = prefill(params, jnp.asarray(toks))
    nxt = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    dec_logits, _ = decode(params, nxt, jnp.asarray(PLEN, jnp.int32), cache)
    rows = jnp.asarray([PLEN, PLEN - 2], jnp.int32)
    row_logits, row_cache = decode(params, nxt, rows, cache)

    pm = build_model(reduced(get_smoke_config("qwen3-1.7b"), dtype="float32"), device="cpu")
    pm.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    return dict(model=pm, toks=toks, nxt=np.asarray(nxt), logits=np.asarray(logits),
                cache_k=np.asarray(cache.k), dec_logits=np.asarray(dec_logits),
                row_logits=np.asarray(row_logits), row_k=np.asarray(row_cache.k),
                row_pos=np.asarray(row_cache.pos))


def test_configs_match_jax():
    """The port's ModelConfig keeps every field of the JAX one, and the
    registered configs are equal field for field."""
    from repro.configs import ModelConfig as JaxModelConfig
    from repro.configs import get_config as jax_config

    jf = [(f.name, f.default) for f in dataclasses.fields(JaxModelConfig)]
    pf = [(f.name, f.default) for f in dataclasses.fields(ModelConfig)]
    assert pf == jf
    for get_p, get_j in ((get_config, jax_config), (get_smoke_config, jax_smoke)):
        assert dataclasses.asdict(get_p("qwen3-1.7b")) == dataclasses.asdict(get_j("qwen3-1.7b"))
    assert get_config("qwen3-1.7b").activation_dtype == torch.bfloat16


def test_rms_norm_and_rope_match_jax():
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = (0.1 * r.standard_normal(16)).astype(np.float32)
    np.testing.assert_allclose(pt_common.rms_norm(_t(x), _t(w), 1e-6).numpy(),
                               np.asarray(jax_common.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
                               atol=ATOL)
    for pos in (np.arange(5, dtype=np.int32), np.asarray([[7, 8, 9, 10, 11], [0, 1, 2, 3, 4]], np.int32)):
        np.testing.assert_allclose(
            pt_common.apply_rope(_t(x), _t(pos), 1_000_000.0).numpy(),
            np.asarray(jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0)),
            atol=ATOL)


@pytest.mark.parametrize("write_at", [0, 3, 14, 100, "rows"])
def test_linear_write_matches_jax_including_clamp(write_at):
    """Scalar and per-row offsets; a start past S - s is clamped as
    dynamic_update_slice clamps it."""
    r = np.random.default_rng(1)
    slab = r.standard_normal((2, 16, 2, 4)).astype(np.float32)
    new = r.standard_normal((2, 4, 2, 4)).astype(np.float32)
    if write_at == "rows":
        wa = np.asarray([2, 15], np.int32)
        pt_wa = _t(wa)
    else:
        wa = pt_wa = write_at
    want = np.asarray(jax_cache.linear_write(jnp.asarray(slab), jnp.asarray(new),
                                             jnp.asarray(wa, jnp.int32)))
    got = pt_cache.linear_write(_t(slab.copy()), _t(new), pt_wa)
    np.testing.assert_array_equal(got.numpy(), want)
    if write_at != "rows":  # a 0-d tensor offset takes the device path
        got = pt_cache.linear_write(_t(slab.copy()), _t(new), torch.tensor(write_at))
        np.testing.assert_array_equal(got.numpy(), want)


def test_pick_last_and_cache_rows_match_jax():
    x = np.random.default_rng(2).standard_normal((3, 5, 4)).astype(np.float32)
    for lens in (None, np.asarray([5, 1, 0], np.int32)):
        want = np.asarray(jax_cache.pick_last(jnp.asarray(x), None if lens is None else jnp.asarray(lens)))
        got = pt_cache.pick_last(_t(x), None if lens is None else _t(lens))
        np.testing.assert_array_equal(got.numpy(), want)
    kv = pt_cache.LinearKV.create((2,), 3, 8, 2, 4, torch.float32, device="cpu")
    assert kv.capacity == 8 and kv.k.shape == (2, 3, 8, 2, 4)
    kv = kv.replace(pos=torch.tensor([4, 5, 6], dtype=torch.int32))
    assert kv.reset_row(1).lengths().tolist() == [4, 0, 6]
    assert kv.lengths().tolist() == [4, 5, 6]


def test_prefill_matches_jax(dense):
    logits, cache = dense["model"].prefill({"tokens": _t(dense["toks"])}, MAX_LEN)
    np.testing.assert_allclose(logits.numpy(), dense["logits"], atol=LOGITS_ATOL)
    np.testing.assert_allclose(cache.k.numpy(), dense["cache_k"], atol=ATOL)
    assert cache.pos.tolist() == [PLEN] * B


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar_pos", "row_pos"])
def test_decode_step_matches_jax(dense, per_row):
    m = dense["model"]
    _, cache = m.prefill({"tokens": _t(dense["toks"])}, MAX_LEN)
    pos = (torch.tensor([PLEN, PLEN - 2], dtype=torch.int32) if per_row
           else torch.tensor(PLEN, dtype=torch.int32))
    logits, new = m.decode_step(_t(dense["nxt"]), pos, cache)
    want = dense["row_logits"] if per_row else dense["dec_logits"]
    np.testing.assert_allclose(logits.numpy(), want, atol=LOGITS_ATOL)
    if per_row:
        np.testing.assert_allclose(new.k.numpy(), dense["row_k"], atol=ATOL)
        assert new.pos.tolist() == dense["row_pos"].tolist()


def test_init_distributions():
    """init draws the JAX init's distributions: zero norms, truncated
    normals within two standard deviations."""
    cfg = reduced(get_smoke_config("qwen3-1.7b"), dtype="float32")
    m = build_model(cfg, device="cpu")
    m.init(torch.Generator().manual_seed(0))
    assert torch.count_nonzero(m.final_norm) == 0
    assert torch.count_nonzero(m.layers[0].q_norm) == 0
    assert m.embed.abs().max() <= 2 * 0.02 and m.embed.std() > 0.01
    w = m.layers[1].w_down
    assert w.abs().max() <= 2 / cfg.d_ff ** 0.5 and w.std() > 0.5 / cfg.d_ff ** 0.5


def test_build_model_rejects_other_families():
    """Every family of the JAX package builds: the encoder-decoder (audio)
    and the VLM from their own configs, which the port once refused, the
    dense family's MoE layers, QKV bias and untied head, the hybrid and the
    SSM; an unknown family raises ``ValueError``, as JAX's ``build_model``
    does."""
    for arch, cls in (("seamless-m4t-large-v2", "EncDecLM"),
                      ("llama-3.2-vision-90b", "VisionLM")):
        assert type(build_model(get_smoke_config(arch), device="cpu")).__name__ == cls
    with pytest.raises(ValueError, match="unknown family 'speech'"):
        build_model(reduced(get_smoke_config("qwen3-1.7b"), family="speech"), device="cpu")
    for ported in (dict(family="moe", n_experts=4, experts_per_token=2, expert_d_ff=32),
                   dict(qkv_bias=True), dict(tie_embeddings=False)):
        build_model(reduced(get_smoke_config("qwen3-1.7b"), **ported), device="cpu")
    for arch in ("recurrentgemma-2b", "mamba2-370m"):
        assert build_model(get_smoke_config(arch), device="cpu").cfg.family in ("hybrid", "ssm")


def test_entry_points_need_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(get_smoke_config("qwen3-1.7b"))


def test_windowed_layers_match_jax():
    """gemma3-1b's smoke config (sliding windows, per-layer RoPE theta,
    scaled embeddings) through prefill and a decode step past the window."""
    jcfg = dataclasses.replace(jax_smoke("gemma3-1b"), dtype="float32")
    _, params, prefill, decode = _jax_model(jcfg, 1)
    toks = np.random.default_rng(3).integers(3, jcfg.vocab_size, (B, 12)).astype(np.int32)
    want, cache = prefill(params, jnp.asarray(toks))
    nxt = jnp.argmax(want, -1).astype(jnp.int32)[:, None]
    want_dec, _ = decode(params, nxt, jnp.asarray(12, jnp.int32), cache)

    pm = build_model(_port_cfg(jcfg), device="cpu")
    pm.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    got, pcache = pm.prefill({"tokens": _t(toks)}, MAX_LEN)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_ATOL)
    got_dec, _ = pm.decode_step(_t(np.asarray(nxt)), torch.tensor(12, dtype=torch.int32), pcache)
    np.testing.assert_allclose(got_dec.numpy(), np.asarray(want_dec), atol=LOGITS_ATOL)
