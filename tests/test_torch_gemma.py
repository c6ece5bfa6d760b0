"""``gemma3-1b`` (head dim 256, one KV head, 5:1 local:global windows of
512, a local RoPE theta, scaled embeddings, a 262,144-token tied vocab)
against the JAX package on the CPU, and on the card against the CPU.

Its smoke config (head dim 32, windows of 8 on 2 of every 3 layers) runs at
f32.  The JAX ``Engine`` (on a 1x1 Auto-axis mesh, as
``tests/test_torch_engine.py`` builds it) draws the parameters, which
``params_from_numpy`` carries into the port; both engines serve the same
seeded requests (prompts of 3-30 tokens, most past the window; chunk 5,
which does not divide it) with the fp and the int8 cache, and the JAX
``Server`` serves three prompts: greedy tokens identical request for
request.  The loss and gradients of a 2 x 24 batch: rtol 1e-5 and rtol
5e-3 / atol 1e-5 (as ``tests/test_torch_train.py``).  The JAX side runs
once per module, jitted, in the ``jax_gemma`` fixture; JAX is imported
there only, so the tests marked ``cuda`` run on a machine without it:
``PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_gemma.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config, reduced  # noqa: E402
from repro_torch.kernels import policy  # noqa: E402
from repro_torch.launch.engine import Engine  # noqa: E402
from repro_torch.launch.serve import Request, Server  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ARCH = "gemma3-1b"
SLOTS, MAX_LEN, CHUNK, N_REQ = 3, 64, 5, 6
SERVER_PROMPTS = (12, 5, 17)
BATCH, SEQ = 2, 24
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


def _workload(n, make, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [make(i, rng.integers(3, vocab, int(rng.integers(3, 31))).astype(np.int32),
                 max_new=int(rng.integers(2, 9)))
            for i in range(n)]


def _server_prompts(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(3, vocab, n).astype(np.int32) for n in SERVER_PROMPTS]


def _port_cfg():
    return reduced(get_smoke_config(ARCH), dtype="float32")


@pytest.fixture(scope="module")
def jax_gemma():
    """The JAX engine's parameters (f32, and a bf16 init's as numpy), its
    tokens with the fp and the int8 cache, the JAX Server's tokens on the
    same parameters, and the loss and gradients of one batch."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs import get_smoke_config as jax_smoke
    from repro.data import DataConfig as JaxDataConfig
    from repro.data import SyntheticLMDataset as JaxDataset
    from repro.kernels import autotune
    from repro.kernels import policy as jax_policy
    from repro.launch.engine import Engine as JaxEngine
    from repro.launch.serve import Request as JaxRequest
    from repro.launch.serve import Server as JaxServer
    from repro.models import build_model as jax_build
    from repro.models.base import RunOptions as JaxRunOptions

    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype="float32")
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    opts = JaxRunOptions(remat="none")

    def engine_tokens(params=None):
        eng = JaxEngine(jcfg, mesh, max_batch=SLOTS, max_len=MAX_LEN, chunk=CHUNK,
                        degrade_after=NEVER, opts=opts)
        if params is not None:
            eng.params = params
        reqs = _workload(N_REQ, JaxRequest, jcfg.vocab_size)
        eng.run(reqs)
        return eng.params, [r.out for r in reqs]

    try:
        params, fp = engine_tokens()
        with jax_policy.apply(**INT8):
            _, q8 = engine_tokens(params)
        srv = JaxServer(jcfg, mesh, max_len=MAX_LEN, opts=opts)
        srv.params = params
        sreqs = [JaxRequest(i, p, max_new=6) for i, p in enumerate(_server_prompts(256))]
        srv.run_batch(sreqs)
    finally:
        autotune.set_mode(None)  # Server.__init__ pins the autotune mode process-wide
    jm = jax_build(jcfg, opts)
    batch = JaxDataset(JaxDataConfig(global_batch=BATCH, seq_len=SEQ), jcfg).batch_at(0)
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    bf16 = jax_build(dataclasses.replace(jcfg, dtype="bfloat16"), opts).init(jax.random.PRNGKey(0))
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return dict(params=params_from_numpy(to_np(params)), fp=fp, int8=q8,
                server=[r.out for r in sreqs], batch=batch, loss=float(loss),
                grads=params_from_numpy(to_np(grads)), bf16_tree=to_np(bf16))


def test_config_and_param_count_match_jax():
    """The config field for field (smoke too), its per-layer windows and
    thetas, and the analytic parameter count: 1.0e9, 2.0 GB in bf16."""
    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models.dense import layer_thetas as jax_thetas
    from repro.models.dense import layer_windows as jax_windows
    from repro_torch.models.dense import layer_thetas, layer_windows

    for get_p, get_j in ((get_config, jax_config), (get_smoke_config, jax_smoke)):
        cfg, jcfg = get_p(ARCH), get_j(ARCH)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
        assert [w or 1 << 30 for w in layer_windows(cfg)] == np.asarray(jax_windows(jcfg)).tolist()
        assert layer_thetas(cfg) == np.asarray(jax_thetas(jcfg)).tolist()
    full = get_config(ARCH)
    assert full.head_dim_ == 256 and full.n_kv_heads == 1
    assert full.param_count() == 999_812_736
    assert layer_windows(full).count(None) == 4  # layers 5, 11, 17, 23


def test_params_carry_across_unchanged(jax_gemma):
    """``params_from_numpy`` carries the tied, bias-free parameters bit for
    bit (a bf16 init and the f32 engine's): one leaf a layer per stacked
    leaf, no ``lm_head``, no QKV bias; they fill the port's model, which
    holds ``param_count`` values."""
    from repro.configs import get_smoke_config as jax_smoke

    tree = jax_gemma["bf16_tree"]
    got = params_from_numpy(tree)
    for name, leaf in tree["layers"].items():
        for i in range(leaf.shape[0]):
            t = got[f"layers.{i}.{name}"]
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.view(torch.int16).numpy(), leaf[i].view(np.int16)), name
    assert np.array_equal(got["embed"].view(torch.int16).numpy(), tree["embed"].view(np.int16))
    for params, dtype in ((got, "bfloat16"), (jax_gemma["params"], "float32")):
        cfg = reduced(get_smoke_config(ARCH), dtype=dtype)
        model = build_model(cfg, device="cpu")
        assert set(dict(model.named_parameters())) == set(params)
        assert "lm_head" not in params and not any(".bq" in n or ".bk" in n for n in params)
        model.load_state_dict(params)
        assert all(torch.equal(v, params[k]) for k, v in model.state_dict().items())
        assert sum(p.numel() for p in model.parameters()) == jax_smoke(ARCH).param_count()


@pytest.mark.parametrize("cache", ["fp", "int8"])
def test_engine_tokens_identical_to_jax(jax_gemma, cache):
    """The port's Engine serves the JAX engine's requests with its
    parameters: the same greedy tokens, request for request, with the fp
    and the int8 cache (chunk 5 against windows of 8)."""
    cfg = _port_cfg()
    with policy.apply(**(INT8 if cache == "int8" else {})):
        engine = Engine(cfg, device="cpu", params=jax_gemma["params"], max_batch=SLOTS,
                        max_len=MAX_LEN, chunk=CHUNK, degrade_after=NEVER)
        assert engine.cache.quantized == (cache == "int8")
        reqs = _workload(N_REQ, Request, cfg.vocab_size)
        engine.run(reqs)
    assert sum(len(r.prompt) > cfg.sliding_window for r in reqs) >= N_REQ // 2
    assert [r.out for r in reqs] == jax_gemma[cache]


def test_server_tokens_identical_to_jax(jax_gemma):
    cfg = _port_cfg()
    server = Server(cfg, device="cpu", params=jax_gemma["params"], max_len=MAX_LEN)
    reqs = [Request(i, p, max_new=6) for i, p in enumerate(_server_prompts(cfg.vocab_size))]
    out = server.run_batch(reqs)
    assert [r.out for r in reqs] == jax_gemma["server"]
    assert out["logits_finite"]


def test_loss_and_grads_match_jax(jax_gemma):
    """The loss and every gradient of a 2 x 24 batch, past the windows of 8
    (the tied embedding's gradient sums the input lookup and the logits)."""
    model = build_model(_port_cfg(), device="cpu")
    model.load_state_dict(jax_gemma["params"])
    loss = model.loss({k: torch.from_numpy(v) for k, v in jax_gemma["batch"].items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_gemma["loss"], rtol=LOSS_RTOL)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(jax_gemma["grads"])
    for name, want in jax_gemma["grads"].items():
        torch.testing.assert_close(grads[name], want, **GRAD_TOL, msg=name)


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_smoke_on_card_matches_cpu(cuda):
    """The smoke config at f32 from one seeded init: the card's greedy tokens
    equal the CPU's through the Engine (fp and int8 cache) and the Server."""
    cfg = _port_cfg()
    host = build_model(cfg, device="cpu")
    host.init(torch.Generator().manual_seed(0))
    params = host.state_dict()
    got = {}
    for where in ("cuda", "cpu"):
        for cache in ("fp", "int8"):
            with policy.apply(**(INT8 if cache == "int8" else {})):
                eng = Engine(cfg, device=where, params=params, max_batch=SLOTS,
                             max_len=MAX_LEN, chunk=CHUNK, degrade_after=NEVER)
                reqs = _workload(N_REQ, Request, cfg.vocab_size)
                eng.run(reqs)
            got[where, cache] = [r.out for r in reqs]
        srv = Server(cfg, device=where, params=params, max_len=MAX_LEN)
        reqs = [Request(i, p, max_new=6) for i, p in enumerate(_server_prompts(cfg.vocab_size))]
        srv.run_batch(reqs)
        got[where, "server"] = [r.out for r in reqs]
    for key in ("fp", "int8", "server"):
        assert got["cuda", key] == got["cpu", key], key


@pytest.mark.cuda
def test_unfaulted_engine_counts_no_stragglers(cuda):
    """The watchdog on the card at ``chip_smoke.py`` phase 11's traffic (8
    slots, 512 positions, chunk 64, 16 requests of 16-192 prompt and 8-48
    new tokens), on gemma3-1b at full width and 6 of its 26 layers (one of
    them global), bf16 from a seeded init, with the engine's default
    degradation settings: every request completes, no launch is flagged
    and no slot is shed, with either cache."""
    cfg = reduced(get_config(ARCH), n_layers=6)
    engine = Engine(cfg, device="cuda", max_batch=8, max_len=512, chunk=64)
    rng = np.random.default_rng(0)
    work = [(rng.integers(3, cfg.vocab_size, int(rng.integers(16, 193))).astype(np.int32),
             int(rng.integers(8, 49))) for _ in range(16)]
    for cache in ("fp", "int8"):
        reqs = [Request(i, p, max_new=m) for i, (p, m) in enumerate(work)]
        with policy.apply(**(INT8 if cache == "int8" else {})):
            out = engine.run(reqs)
        tel = out["telemetry"]
        assert all(len(r.out) == r.max_new for r in reqs), cache
        assert tel["stragglers"] == 0 and tel["degradations"] == 0, (cache, tel,
                                                                     out["stats"]["watchdog"])
