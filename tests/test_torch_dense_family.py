"""The rest of the dense family against the JAX package, on the CPU:
``qwen3-moe-30b-a3b`` and ``olmoe-1b-7b`` (MoE layers), ``qwen2.5-14b``
(QKV bias) and ``qwen3-32b``, all with untied output heads.

Each arch runs its smoke config at f32.  The JAX ``Engine`` (on a 1x1
Auto-axis mesh, as ``tests/test_torch_engine.py`` builds it) draws the
parameters, which ``params_from_numpy`` carries into the port; both engines
serve the same seeded requests, and their greedy tokens must be identical
request for request (fp cache for every arch, and the int8 cache for
``qwen3-moe-30b-a3b``).  Inputs are made from a seed with numpy; the JAX
side runs once per module, jitted.  Tolerances, at f32: atol 2e-5 on
logits (as ``tests/test_torch_models.py``); losses rtol 1e-5 and gradients
rtol 5e-3 / atol 1e-5 (as ``tests/test_torch_train.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AxisType

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs import list_archs as jax_list_archs  # noqa: E402
from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import SyntheticLMDataset as JaxDataset  # noqa: E402
from repro.kernels import policy as jax_policy  # noqa: E402
from repro.launch.engine import Engine as JaxEngine  # noqa: E402
from repro.launch.serve import Request as JaxRequest  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.base import RunOptions as JaxRunOptions  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config, list_archs, reduced  # noqa: E402
from repro_torch.kernels import policy  # noqa: E402
from repro_torch.launch.engine import Engine  # noqa: E402
from repro_torch.launch.serve import Request, Server  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ARCHS = ("qwen3-moe-30b-a3b", "olmoe-1b-7b", "qwen2.5-14b", "qwen3-32b")
INT8_ARCH = "qwen3-moe-30b-a3b"
SLOTS, MAX_LEN = 3, 64
B, PLEN = 2, 6
BATCH, SEQ = 2, 16
LOGITS_ATOL = 2e-5
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=5e-3, atol=1e-5)
INT8 = dict(impl={"attention": "pallas"}, variants={"attention": {"kv_dtype": "int8"}})
NEVER = 10 ** 9  # no straggler degradation (wall times differ between engines)


@pytest.fixture(autouse=True)
def _reset_port_autotune():
    """The port's Server, Engine and trainer pin the autotune mode
    process-wide (``autotune.startup``), as JAX's do: clear it after each
    test."""
    yield
    from repro_torch.kernels import autotune as port_autotune

    port_autotune.set_mode(None)


def _workload(n, make, vocab):
    rng = np.random.default_rng(0)
    return [make(i, rng.integers(3, vocab, int(rng.integers(4, 20))).astype(np.int32),
                 max_new=int(rng.integers(2, 9)))
            for i in range(n)]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_engine(jcfg, chunk):
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    return JaxEngine(jcfg, mesh, max_batch=SLOTS, max_len=MAX_LEN, chunk=chunk,
                     degrade_after=NEVER, opts=JaxRunOptions(remat="none"))


def _jax_tokens(engine, n, vocab):
    reqs = _workload(n, JaxRequest, vocab)
    engine.run(reqs)
    return [r.out for r in reqs]


@pytest.fixture(scope="module")
def family():
    """Per arch: the JAX engine's parameters (as the port's state dict), its
    tokens (fp cache; int8 too for one MoE arch), and the JAX prefill logits
    on seeded tokens.  Also the loss and gradients of ``olmoe-1b-7b`` (MoE)
    and of ``qwen2.5-14b``, from the same parameters."""
    from repro.kernels import autotune

    out = {}
    try:
        for arch in ARCHS:
            jcfg = dataclasses.replace(jax_smoke(arch), dtype="float32")
            eng = _jax_engine(jcfg, chunk=8)
            ref = dict(tokens=_jax_tokens(eng, 6, jcfg.vocab_size))
            params = eng.params
            if arch == INT8_ARCH:
                with jax_policy.apply(**INT8):
                    q8 = _jax_engine(jcfg, chunk=24)
                    q8.params = params
                    ref["int8"] = _jax_tokens(q8, 4, jcfg.vocab_size)
            jm = jax_build(jcfg, JaxRunOptions(remat="none"))
            toks = np.random.default_rng(1).integers(3, jcfg.vocab_size, (B, PLEN)).astype(np.int32)
            logits, _ = jax.jit(lambda p, t, jm=jm: jm.prefill(p, {"tokens": t}, MAX_LEN))(
                params, jnp.asarray(toks))
            ref.update(params=params_from_numpy(_np_tree(params)), toks=toks,
                       logits=np.asarray(logits))
            if arch in ("olmoe-1b-7b", "qwen2.5-14b"):
                batch = JaxDataset(JaxDataConfig(global_batch=BATCH, seq_len=SEQ),
                                   jcfg).batch_at(0)
                jb = {k: jnp.asarray(v) for k, v in batch.items()}
                loss, grads = jax.jit(jax.value_and_grad(jm.loss))(params, jb)
                ref.update(batch=batch, loss=float(loss),
                           grads=params_from_numpy(_np_tree(grads)))
            out[arch] = ref
    finally:
        autotune.set_mode(None)  # Server.__init__ pins the autotune mode process-wide
    return out


def _port_cfg(arch):
    return reduced(get_smoke_config(arch), dtype="float32")


def test_configs_and_counts_match_jax():
    """Every registered arch: the config field for field (smoke too), the
    analytic parameter counts, and the registry's names (the port's
    ``list_archs`` is the JAX list: every family is ported)."""
    assert set(ARCHS) <= set(list_archs())
    assert "gemma3-1b" in list_archs()  # K1, K1q and K3 take head dim 256
    assert {"recurrentgemma-2b", "mamba2-370m"} <= set(list_archs())  # hybrid, ssm
    assert list_archs() == jax_list_archs()
    for arch in list_archs():
        for get_p, get_j in ((get_config, jax_config), (get_smoke_config, jax_smoke)):
            assert dataclasses.asdict(get_p(arch)) == dataclasses.asdict(get_j(arch)), arch
            assert get_p(arch).param_count() == get_j(arch).param_count(), arch
            assert get_p(arch).active_param_count() == get_j(arch).active_param_count(), arch
    # the full-width sizes this slice serves on one card (bf16)
    assert 2 * get_config("qwen3-moe-30b-a3b").param_count() < 62e9
    assert get_config("olmoe-1b-7b").active_param_count() < get_config("olmoe-1b-7b").param_count()


def test_params_carry_across(family):
    """The carried state dict fills every leaf of the port's model with the
    JAX names and shapes: the f32 router, the (E, d, f) experts under
    ``layers.<i>``, the biases and ``lm_head``."""
    for arch in ARCHS:
        cfg = _port_cfg(arch)
        params = family[arch]["params"]
        model = build_model(cfg, device="cpu")
        assert set(dict(model.named_parameters())) == set(params)
        model.load_state_dict(params)
        assert "lm_head" in params and not torch.equal(params["lm_head"], params["embed"])
        if cfg.n_experts:
            e, d, f = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
            assert params["layers.1.e_gate"].shape == (e, d, f)
            assert params["layers.1.e_down"].shape == (e, f, d)
            assert params["layers.0.router"].shape == (d, e)
            assert "layers.0.w_gate" not in params
        if cfg.qkv_bias:
            assert params["layers.0.bq"].shape == (cfg.q_dim,)
    bf = build_model(get_smoke_config("qwen3-moe-30b-a3b"), device="cpu")
    bf.init(torch.Generator().manual_seed(0))
    assert bf.layers[0].router.dtype == torch.float32  # f32 even in a bf16 model
    assert bf.layers[0].e_gate.dtype == torch.bfloat16
    b14 = build_model(get_smoke_config("qwen2.5-14b"), device="cpu")
    b14.init(torch.Generator().manual_seed(0))
    assert not b14.layers[0].bq.any() and b14.lm_head.std() < 0.03


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax(family, arch):
    ref = family[arch]
    model = build_model(_port_cfg(arch), device="cpu")
    model.load_state_dict(ref["params"])
    logits, _ = model.prefill({"tokens": torch.from_numpy(ref["toks"])}, MAX_LEN)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=LOGITS_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_identical_to_jax(family, arch):
    """The port's Engine serves the JAX engine's requests with its
    parameters: the same greedy tokens, request for request (an MoE step
    routes every slot's row, idle ones included, as the JAX step does, so
    the same tokens meet each expert's capacity)."""
    ref = family[arch]
    cfg = _port_cfg(arch)
    engine = Engine(cfg, device="cpu", params=ref["params"], max_batch=SLOTS, max_len=MAX_LEN,
                    chunk=8, degrade_after=NEVER)
    reqs = _workload(6, Request, cfg.vocab_size)
    engine.run(reqs)
    assert [r.out for r in reqs] == ref["tokens"]


def test_engine_int8_cache_identical_to_jax(family):
    ref = family[INT8_ARCH]
    cfg = _port_cfg(INT8_ARCH)
    with policy.apply(**INT8):
        engine = Engine(cfg, device="cpu", params=ref["params"], max_batch=SLOTS,
                        max_len=MAX_LEN, chunk=24, degrade_after=NEVER)
        assert engine.cache.quantized
        reqs = _workload(4, Request, cfg.vocab_size)
        engine.run(reqs)
    assert [r.out for r in reqs] == ref["int8"]


def test_moe_loss_matches_jax(family):
    """``olmoe-1b-7b``'s loss, the routers' aux term included (it moves the
    loss by more than the tolerance), and every gradient: the routers'
    (through the softmax, the top-k weights and the aux term), the experts'
    (the batched backward through the gathers of the sort dispatch) and the
    rest."""
    ref = family["olmoe-1b-7b"]
    cfg = _port_cfg("olmoe-1b-7b")
    model = build_model(cfg, device="cpu")
    model.load_state_dict(ref["params"])
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    with torch.no_grad():
        x, aux = model._backbone(torch.zeros_like(batch["tokens"]),
                                 torch.arange(SEQ, dtype=torch.int32))
    loss = model.loss(batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=LOSS_RTOL)
    assert cfg.router_aux_weight * aux.item() / cfg.n_layers > LOSS_RTOL * ref["loss"]
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert grads.keys() == ref["grads"].keys()
    assert {"layers.0.router", "layers.1.e_gate", "layers.1.e_down"} <= set(grads)
    for name, want in ref["grads"].items():
        torch.testing.assert_close(grads[name], want, **GRAD_TOL, msg=name)
    assert all(grads[f"layers.{i}.{n}"].abs().max() > 0 for i in range(cfg.n_layers)
               for n in ("router", "e_gate", "e_up", "e_down"))


def test_bias_and_head_loss_and_grads_match_jax(family):
    """``qwen2.5-14b``: loss and every gradient, the QKV biases' and the
    untied ``lm_head``'s among them."""
    ref = family["qwen2.5-14b"]
    model = build_model(_port_cfg("qwen2.5-14b"), device="cpu")
    model.load_state_dict(ref["params"])
    loss = model.loss({k: torch.from_numpy(v) for k, v in ref["batch"].items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=LOSS_RTOL)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert {"layers.0.bq", "layers.1.bv", "lm_head"} <= set(grads)
    for name, want in ref["grads"].items():
        torch.testing.assert_close(grads[name], want, **GRAD_TOL, msg=name)
    assert grads["layers.0.bk"].abs().max() > 0 and grads["lm_head"].abs().max() > 0


def test_server_serves_every_arch_and_unported_families_raise():
    """The lockstep Server on each new smoke config (bf16, seeded init):
    finite logits and every request complete; so do the encoder-decoder and
    the VLM, which the port once refused, with the frames or images the
    Server draws."""
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        srv = Server(cfg, device="cpu", max_batch=2, max_len=32)
        reqs = [Request(i, np.arange(3, 3 + n, dtype=np.int32), max_new=3)
                for i, n in enumerate((5, 9))]
        out = srv.run_batch(reqs)
        assert out["logits_finite"] and all(len(r.out) == 3 for r in reqs), arch
    for arch in ("seamless-m4t-large-v2", "llama-3.2-vision-90b"):
        srv = Server(get_smoke_config(arch), device="cpu", max_batch=2, max_len=32)
        reqs = [Request(i, np.arange(3, 3 + n, dtype=np.int32), max_new=3)
                for i, n in enumerate((5, 9))]
        out = srv.run_batch(reqs)
        assert out["logits_finite"] and all(len(r.out) == 3 for r in reqs), arch
        assert srv.model.cfg.family in ("audio", "vlm") and srv.draw_extras(2)
