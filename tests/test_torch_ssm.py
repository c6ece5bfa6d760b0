"""``mamba2-370m`` (attention-free Mamba-2 with SSD, a bare ``StateCarry``
cache) against the JAX package on the CPU, and on the card against the
CPU.

Its smoke config (2 layers, state 16, SSD chunks of 8) runs at f32.  The
JAX ``Engine`` (on a 1x1 Auto-axis mesh) draws the parameters, which
``params_from_numpy`` carries into the port; both engines serve the same
seeded requests, prompts of 8-32 tokens on ``ssm_chunk`` multiples with
chunks of 8 and of 16, and the JAX ``Server`` serves three prompts: greedy
tokens identical request for request.  The loss and gradients of a 2 x 24
batch: rtol 1e-5 and rtol 5e-3 / atol 1e-5 (as ``tests/test_torch_train.py``).
``ssd_chunked`` (with and without an initial state) and ``ssd_decode_step``
against the JAX functions on seeded inputs: rtol 1e-5 / atol 1e-6 (f32;
the two sides contract the einsums in their own orders).  The JAX side
runs once per module, in the ``jax_ssm`` fixture; JAX is imported there
and in the function tests only, so the test marked ``cuda`` runs on a
machine without it:
``PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_ssm.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config, reduced  # noqa: E402
from repro_torch.launch.engine import Engine  # noqa: E402
from repro_torch.launch.serve import Request, Server  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import cache as dcache  # noqa: E402
from repro_torch.models.ssm import ssd_chunked, ssd_decode_step  # noqa: E402

ARCH = "mamba2-370m"
SLOTS, MAX_LEN, N_REQ, ALIGN = 3, 64, 6, 8
CHUNKS = (8, 16)
SERVER_PROMPTS = (12, 5, 17)
BATCH, SEQ = 2, 24
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=5e-3, atol=1e-5)
SSD_TOL = dict(rtol=1e-5, atol=1e-6)
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
    """Prompts of 8-32 tokens, on multiples of the SSD chunk (8)."""
    rng = np.random.default_rng(seed)
    return [make(i, rng.integers(3, vocab, -(-int(rng.integers(3, 31)) // ALIGN) * ALIGN)
                 .astype(np.int32), max_new=int(rng.integers(2, 9)))
            for i in range(n)]


def _server_prompts(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(3, vocab, n).astype(np.int32) for n in SERVER_PROMPTS]


def _port_cfg():
    return reduced(get_smoke_config(ARCH), dtype="float32")


@pytest.fixture(scope="module")
def jax_ssm():
    """The JAX engine's parameters (f32, and a bf16 init's as numpy), its
    tokens at each chunk, the JAX Server's tokens, and the loss and
    gradients of one batch."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs import get_smoke_config as jax_smoke
    from repro.data import DataConfig as JaxDataConfig
    from repro.data import SyntheticLMDataset as JaxDataset
    from repro.kernels import autotune
    from repro.launch.engine import Engine as JaxEngine
    from repro.launch.serve import Request as JaxRequest
    from repro.launch.serve import Server as JaxServer
    from repro.models import build_model as jax_build
    from repro.models.base import RunOptions as JaxRunOptions

    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype="float32")
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    opts = JaxRunOptions(remat="none")
    engine, params = {}, None
    try:
        for chunk in CHUNKS:
            eng = JaxEngine(jcfg, mesh, max_batch=SLOTS, max_len=MAX_LEN, chunk=chunk,
                            degrade_after=NEVER, opts=opts)
            if params is not None:
                eng.params = params
            reqs = _workload(N_REQ, JaxRequest, jcfg.vocab_size)
            eng.run(reqs)
            params = eng.params
            engine[chunk] = [r.out for r in reqs]
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
    return dict(params=params_from_numpy(to_np(params)), engine=engine,
                server=[r.out for r in sreqs], batch=batch, loss=float(loss),
                grads=params_from_numpy(to_np(grads)), bf16_tree=to_np(bf16))


def test_config_and_param_count_match_jax():
    """The config field for field (smoke too), the analytic parameter count
    (3.7e8, 0.74 GB in bf16) and the derived flags."""
    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke

    for get_p, get_j in ((get_config, jax_config), (get_smoke_config, jax_smoke)):
        cfg, jcfg = get_p(ARCH), get_j(ARCH)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
        assert (cfg.is_attention_free, cfg.supports_long_context) == (
            jcfg.is_attention_free, jcfg.supports_long_context) == (True, True)
        assert (cfg.ssm_d_inner, cfg.ssm_n_heads) == (jcfg.ssm_d_inner, jcfg.ssm_n_heads)
    assert get_config(ARCH).param_count() == 368_128_000


def test_params_carry_across_unchanged(jax_ssm):
    """``params_from_numpy`` carries a bf16 init's layers bit for bit, with
    ``A_log``, ``dt_bias`` and ``D`` f32; the f32 engine's parameters fill
    the port's model."""
    tree = jax_ssm["bf16_tree"]
    got = params_from_numpy(tree)
    ints = {2: (torch.int16, np.int16), 4: (torch.int32, np.int32)}
    for name, leaf in tree["layers"].items():
        for i in range(leaf.shape[0]):
            t = got[f"layers.{i}.{name}"]
            ti, ni = ints[t.element_size()]
            assert np.array_equal(t.view(ti).numpy(), np.ascontiguousarray(leaf[i]).view(ni))
            f32 = name in ("A_log", "dt_bias", "D")
            assert t.dtype == (torch.float32 if f32 else torch.bfloat16), name
    for params, dtype in ((got, "bfloat16"), (jax_ssm["params"], "float32")):
        model = build_model(reduced(get_smoke_config(ARCH), dtype=dtype), device="cpu")
        assert set(dict(model.named_parameters())) == set(params)
        model.load_state_dict(params)
        assert all(torch.equal(v, params[k]) for k, v in model.state_dict().items())


@pytest.mark.parametrize("chunk", CHUNKS)
def test_engine_tokens_identical_to_jax(jax_ssm, chunk):
    """The port's Engine serves the JAX engine's requests with its
    parameters, chunks on ``ssm_chunk`` multiples: the same greedy tokens,
    request for request; the cache is a bare ``StateCarry`` with no
    lengths."""
    cfg = _port_cfg()
    engine = Engine(cfg, device="cpu", params=jax_ssm["params"], max_batch=SLOTS,
                    max_len=MAX_LEN, chunk=chunk, degrade_after=NEVER)
    assert isinstance(engine.cache, dcache.StateCarry) and dcache.lengths(engine.cache) is None
    reqs = _workload(N_REQ, Request, cfg.vocab_size)
    engine.run(reqs)
    assert all(len(r.prompt) % ALIGN == 0 for r in reqs)
    assert [r.out for r in reqs] == jax_ssm["engine"][chunk]


def test_server_tokens_identical_to_jax(jax_ssm):
    cfg = _port_cfg()
    server = Server(cfg, device="cpu", params=jax_ssm["params"], max_len=MAX_LEN)
    reqs = [Request(i, p, max_new=6) for i, p in enumerate(_server_prompts(cfg.vocab_size))]
    out = server.run_batch(reqs)
    assert [r.out for r in reqs] == jax_ssm["server"]
    assert out["logits_finite"]


def test_loss_and_grads_match_jax(jax_ssm):
    """The loss and every gradient of a 2 x 24 batch (three SSD chunks)."""
    model = build_model(_port_cfg(), device="cpu")
    model.load_state_dict(jax_ssm["params"])
    loss = model.loss({k: torch.from_numpy(v) for k, v in jax_ssm["batch"].items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_ssm["loss"], rtol=LOSS_RTOL)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(jax_ssm["grads"])
    for name, want in jax_ssm["grads"].items():
        torch.testing.assert_close(grads[name], want, **GRAD_TOL, msg=name)


@pytest.mark.parametrize("length, chunk", [(16, 8), (24, 8), (12, 12), (20, 4)])
def test_ssd_matches_jax(length, chunk):
    """``ssd_chunked`` over 1-5 chunks, from zero and from a carried state,
    and one ``ssd_decode_step`` after it, against JAX."""
    import jax.numpy as jnp

    from repro.models.ssm import ssd_chunked as jax_ssd
    from repro.models.ssm import ssd_decode_step as jax_step

    rng = np.random.default_rng(length)
    b, h, p, n = 2, 3, 4, 5
    x = rng.standard_normal((b, length, h, p)).astype(np.float32)
    a = -rng.uniform(0.0, 0.5, (b, length, h)).astype(np.float32)
    B, C = (rng.standard_normal((b, length, n)).astype(np.float32) for _ in "BC")
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    t = lambda *xs: [torch.from_numpy(v) for v in xs]  # noqa: E731
    j = lambda *xs: [jnp.asarray(v) for v in xs]  # noqa: E731
    for init in (None, s0):
        wy, ws = jax_ssd(*j(x, a, B, C), chunk, None if init is None else jnp.asarray(init))
        gy, gs = ssd_chunked(*t(x, a, B, C), chunk, None if init is None else t(init)[0])
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **SSD_TOL)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **SSD_TOL)
    wy, ws = jax_step(*j(x[:, 0], a[:, 0], B[:, 0], C[:, 0], s0))
    gy, gs = ssd_decode_step(*t(x[:, 0], a[:, 0], B[:, 0], C[:, 0], s0))
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **SSD_TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **SSD_TOL)


def test_parked_rows_carry_state_bit_for_bit():
    """A row parked in a chunk (``lens = 0``: dt = 0 on its pad steps, so
    decay 1 and no input) and a row that is not ``valid`` in a decode step
    keep their conv and SSD state bit for bit while the other row
    advances."""
    model = build_model(_port_cfg(), device="cpu")
    model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(2, 32)
    gen = torch.Generator().manual_seed(1)
    for t in cache.states.values():
        t.copy_(torch.randn(t.shape, generator=gen))
    before = {k: t[:, 0].clone() for k, t in cache.states.items()}
    toks = torch.randint(3, 256, (2, 8), generator=gen)
    _, cache = model.prefill_chunk(toks, torch.zeros(2, dtype=torch.int32), cache,
                                   lens=torch.tensor([0, 6], dtype=torch.int32))
    cache = dcache.set_row_valid(cache, 0, False)
    _, cache = model.decode_step(toks[:, :1], torch.zeros(2, dtype=torch.int32), cache)
    assert cache.valid.tolist() == [False, True]
    for k, t in cache.states.items():
        assert torch.equal(t[:, 0], before[k]), k
        assert not torch.equal(t[:, 1], before[k]), k


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_smoke_on_card_matches_cpu():
    """The smoke config at f32 from one seeded init: the card's greedy tokens
    equal the CPU's through the Engine (chunk 8) and the Server."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no CPU mode")
    cfg = _port_cfg()
    host = build_model(cfg, device="cpu")
    host.init(torch.Generator().manual_seed(0))
    params = host.state_dict()
    got = {}
    for where in ("cuda", "cpu"):
        eng = Engine(cfg, device=where, params=params, max_batch=SLOTS, max_len=MAX_LEN,
                     chunk=CHUNKS[0], degrade_after=NEVER)
        reqs = _workload(N_REQ, Request, cfg.vocab_size)
        eng.run(reqs)
        got[where, "engine"] = [r.out for r in reqs]
        srv = Server(cfg, device=where, params=params, max_len=MAX_LEN)
        reqs = [Request(i, p, max_new=6) for i, p in enumerate(_server_prompts(cfg.vocab_size))]
        srv.run_batch(reqs)
        got[where, "server"] = [r.out for r in reqs]
    for key in ("engine", "server"):
        assert got["cuda", key] == got["cpu", key], key
