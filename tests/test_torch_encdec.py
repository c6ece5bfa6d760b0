"""``seamless-m4t-large-v2`` (encoder-decoder: a bidirectional encoder over
stub frame embeddings, a decoder with causal self-attention and
cross-attention over the encoder output, the ``CrossKV`` cache) against the
JAX package on the CPU, and on the card against the CPU.

Its smoke config (2 encoder and 2 decoder layers, d 64) runs at f32.  The
JAX ``Engine`` (on a 1x1 Auto-axis mesh, as ``tests/test_torch_engine.py``
builds it) draws the parameters, which ``params_from_numpy`` carries into
the port; both engines serve the same seeded requests, each with its own
seeded ``audio_frames`` (3 slots, chunk 5, so first-chunk launches mix
live and parked rows): greedy tokens identical request for request, also
under an injected fault plan.  The JAX ``Server`` draws its frames from
``default_rng(0)``, and so does the port's: tokens identical.  The loss and
gradients of a 2 x 24 batch: rtol 1e-5 and rtol 5e-3 / atol 1e-5 (as
``tests/test_torch_train.py``).  The JAX side runs once per module, in the
``jax_encdec`` fixture; JAX is imported there and in the config test only,
so the tests marked ``cuda`` run on a machine without it:
``PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_encdec.py``.
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
from repro_torch.models import cache as dcache  # noqa: E402
from repro_torch.runtime.fault_tolerance import FaultInjector  # noqa: E402

ARCH = "seamless-m4t-large-v2"
SLOTS, MAX_LEN, CHUNK, N_REQ = 3, 64, 5, 6
ENC_LEN = 16  # enc_len(MAX_LEN) = max(int(64 * 0.25), 16)
SERVER_PROMPTS = (12, 5, 17)
BATCH, SEQ = 2, 24
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=5e-3, atol=1e-5)
FAULT_PLAN = "slot@2=nan_logits,decode@5=raise"
# the same faults with the row poisoned at its third decode, after a snapshot
SNAPSHOT_PLAN = "slot@2=nan_logits:3,decode@5=raise"
NEVER = 10 ** 9  # no straggler degradation (wall times differ between engines)
INT8 = dict(impl={"attention": "pallas"}, variants={"attention": {"kv_dtype": "int8"}})


@pytest.fixture(autouse=True)
def _reset_port_autotune():
    """The port's Server, Engine and trainer pin the autotune mode
    process-wide (``autotune.startup``), as JAX's do: clear it after each
    test."""
    yield
    from repro_torch.kernels import autotune as port_autotune

    port_autotune.set_mode(None)


def _workload(n, make, vocab, d, seed=0):
    rng = np.random.default_rng(seed)
    return [make(i, rng.integers(3, vocab, int(rng.integers(3, 20))).astype(np.int32),
                 max_new=int(rng.integers(2, 9)),
                 extras={"audio_frames": rng.standard_normal((ENC_LEN, d)).astype(np.float32)})
            for i in range(n)]


def _server_prompts(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(3, vocab, n).astype(np.int32) for n in SERVER_PROMPTS]


def _port_cfg():
    return reduced(get_smoke_config(ARCH), dtype="float32")


@pytest.fixture(scope="module")
def jax_encdec():
    """The JAX engine's parameters (f32, and a bf16 init's as numpy), its
    tokens, the JAX Server's tokens on the same parameters, and the loss
    and gradients of one batch."""
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
    try:
        eng = JaxEngine(jcfg, mesh, max_batch=SLOTS, max_len=MAX_LEN, chunk=CHUNK,
                        degrade_after=NEVER, opts=opts)
        reqs = _workload(N_REQ, JaxRequest, jcfg.vocab_size, jcfg.d_model)
        eng.run(reqs)
        params = eng.params
        srv = JaxServer(jcfg, mesh, max_len=MAX_LEN, opts=opts)
        srv.params = params
        sreqs = [JaxRequest(i, p, max_new=6)
                 for i, p in enumerate(_server_prompts(jcfg.vocab_size))]
        srv.run_batch(sreqs)
    finally:
        autotune.set_mode(None)  # Server.__init__ pins the autotune mode process-wide
    jm = jax_build(jcfg, opts)
    batch = JaxDataset(JaxDataConfig(global_batch=BATCH, seq_len=SEQ), jcfg).batch_at(0)
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    bf16 = jax.jit(jax_build(dataclasses.replace(jcfg, dtype="bfloat16"), opts).init)(
        jax.random.PRNGKey(0))
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return dict(params=params_from_numpy(to_np(params)), engine=[r.out for r in reqs],
                server=[r.out for r in sreqs], batch=batch, loss=float(loss),
                grads=params_from_numpy(to_np(grads)), bf16_tree=to_np(bf16))


def test_config_and_param_count_match_jax():
    """The config field for field (smoke too) and the analytic parameter
    count, which leaves out the decoder's third norms and ``enc_norm``:
    the tree the model builds holds 25,600 values more (2.03e9, 4.07 GB in
    bf16)."""
    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke

    for get_p, get_j in ((get_config, jax_config), (get_smoke_config, jax_smoke)):
        cfg, jcfg = get_p(ARCH), get_j(ARCH)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
    full = get_config(ARCH)
    assert full.param_count() == 2_034_758_656
    model = build_model(full, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 2_034_784_256
    assert model.enc_len(2048) == 512 and model.enc_len(24) == 16


def test_params_carry_across_unchanged(jax_encdec):
    """``params_from_numpy`` unstacks the ``encoder`` and ``decoder`` trees,
    whose leaves are nested dicts (``decoder/self_attn/wq``), bit for bit;
    the f32 engine's parameters fill the port's model."""
    tree = jax_encdec["bf16_tree"]
    got = params_from_numpy(tree)
    n = 0
    for group in ("encoder", "decoder"):
        for sub, leaves in tree[group].items():
            for name, leaf in (leaves.items() if isinstance(leaves, dict) else [(None, leaves)]):
                for i in range(leaf.shape[0]):
                    key = ".".join(x for x in (group, str(i), sub, name) if x)
                    t = got[key]
                    assert t.dtype == torch.bfloat16, key
                    assert np.array_equal(t.view(torch.int16).numpy(),
                                          np.ascontiguousarray(leaf[i]).view(np.int16)), key
                    n += 1
    assert n == 2 * 9 + 2 * 14  # 2 encoder layers of 9 leaves, 2 decoder layers of 14
    for params, dtype in ((got, "bfloat16"), (jax_encdec["params"], "float32")):
        model = build_model(reduced(get_smoke_config(ARCH), dtype=dtype), device="cpu")
        assert set(dict(model.named_parameters())) == set(params)
        model.load_state_dict(params)
        assert all(torch.equal(v, params[k]) for k, v in model.state_dict().items())


def test_engine_tokens_identical_to_jax(jax_encdec):
    """The port's Engine serves the JAX engine's requests, each with its own
    frames, with its parameters: the same greedy tokens request for
    request."""
    cfg = _port_cfg()
    engine = Engine(cfg, device="cpu", params=jax_encdec["params"], max_batch=SLOTS,
                    max_len=MAX_LEN, chunk=CHUNK, degrade_after=NEVER)
    reqs = _workload(N_REQ, Request, cfg.vocab_size, cfg.d_model)
    engine.run(reqs)
    assert [r.out for r in reqs] == jax_encdec["engine"]


@pytest.mark.parametrize("plan, snapshot_every", [(FAULT_PLAN, 16), (SNAPSHOT_PLAN, 2)])
def test_engine_under_faults_gives_clean_tokens(jax_encdec, plan, snapshot_every):
    """An injected fault plan (a poisoned row, a failed decode launch): the
    failed launch retries, the poisoned row's request re-queues, and every
    request's tokens are the clean run's.  Poisoned at its first decode,
    the row replays its prompt and its first chunk reads its own staged
    frames again; at its third, with a snapshot every 2 tokens, it resumes
    from its snapshot, cross-attention cache included."""
    cfg = _port_cfg()
    engine = Engine(cfg, device="cpu", params=jax_encdec["params"], max_batch=SLOTS,
                    max_len=MAX_LEN, chunk=CHUNK, degrade_after=NEVER,
                    snapshot_every=snapshot_every, injector=FaultInjector(plan))
    reqs = _workload(N_REQ, Request, cfg.vocab_size, cfg.d_model)
    out = engine.run(reqs)
    faults = out["stats"]["faults"]
    assert faults["retries"] == 1 and faults["slots_poisoned"] == 1
    assert out["telemetry"]["snapshot_restores"] == (plan == SNAPSHOT_PLAN)
    assert [r.out for r in reqs] == jax_encdec["engine"]


def test_server_tokens_identical_to_jax(jax_encdec):
    """The lockstep Server against JAX's: both draw the wave's frames from
    ``default_rng(0)`` at ``enc_len(max_len)``."""
    cfg = _port_cfg()
    server = Server(cfg, device="cpu", params=jax_encdec["params"], max_len=MAX_LEN)
    reqs = [Request(i, p, max_new=6) for i, p in enumerate(_server_prompts(cfg.vocab_size))]
    out = server.run_batch(reqs)
    assert [r.out for r in reqs] == jax_encdec["server"]
    assert out["logits_finite"]
    assert server.draw_extras(3)["audio_frames"].shape == (3, ENC_LEN, cfg.d_model)


def test_loss_and_grads_match_jax(jax_encdec):
    """The loss and every gradient of a 2 x 24 batch with its 16 frames a
    row: the encoder's non-causal attention and the cross-attention's
    backward, both projections of the untied head."""
    model = build_model(_port_cfg(), device="cpu")
    model.load_state_dict(jax_encdec["params"])
    batch = {k: torch.from_numpy(v) for k, v in jax_encdec["batch"].items()}
    assert batch["audio_frames"].shape == (BATCH, 16, 64)
    loss = model.loss(batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_encdec["loss"], rtol=LOSS_RTOL)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(jax_encdec["grads"])
    for name, want in jax_encdec["grads"].items():
        torch.testing.assert_close(grads[name], want, **GRAD_TOL, msg=name)


def _frames(b, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, ENC_LEN, 64)).astype(np.float32))


def test_parked_row_cross_kv_bit_for_bit():
    """A first-chunk launch writes the cross k/v of its live rows only: a
    parked row (``lens = 0``) keeps its ``CrossKV`` slabs bit for bit, a
    live row's equal the encoder's over its own frames; the cache's rows go
    through ``snapshot_row`` / ``restore_row`` and a reset leaves them."""
    model = build_model(_port_cfg(), device="cpu")
    model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(2, MAX_LEN)
    assert cache["cross"].k.shape == (2, 2, ENC_LEN, 4, 16)
    gen = torch.Generator().manual_seed(1)
    for t in (cache["cross"].k, cache["cross"].v):
        t.copy_(torch.randn(t.shape, generator=gen))
    before = cache["cross"].k[:, 0].clone(), cache["cross"].v[:, 0].clone()
    toks = torch.randint(3, 256, (2, 5), generator=gen)
    frames = _frames(2, 2)
    _, cache = model.prefill_chunk(toks, torch.tensor([7, 0], dtype=torch.int32), cache,
                                   first=True, lens=torch.tensor([0, 5], dtype=torch.int32),
                                   extras={"audio_frames": frames})
    assert torch.equal(cache["cross"].k[:, 0], before[0])
    assert torch.equal(cache["cross"].v[:, 0], before[1])
    with torch.no_grad():
        enc = model._encoder(frames[1:])
        for i, layer in enumerate(model.decoder):
            k, v = model._cross_kv(layer.cross_attn, enc)
            assert torch.equal(cache["cross"].k[i, 1], k[0])
            assert torch.equal(cache["cross"].v[i, 1], v[0])
    snap = dcache.snapshot_row(cache, 1)
    cache = dcache.reset_row(cache, 0)
    assert torch.equal(cache["cross"].k[:, 0], before[0])
    dcache.snapshot_compatible(cache, snap)
    cache = dcache.restore_row(cache, 0, snap)
    assert torch.equal(cache["cross"].k[:, 0], cache["cross"].k[:, 1])
    assert dcache.lengths(cache).tolist() == [5, 5]


def test_int8_policy_keeps_the_self_cache_in_the_activation_dtype():
    """Under ``attention=pallas:kv_dtype=int8`` the self cache stays f32
    and unquantized, as JAX's ``init_cache`` builds it (only the dense
    family reads the variant), so nothing on this path runs K1q."""
    model = build_model(_port_cfg(), device="cpu")
    with policy.apply(**INT8):
        cache = model.init_cache(2, MAX_LEN)
    assert not cache["self"].quantized and cache["self"].k.dtype == torch.float32
    assert cache["cross"].k.dtype == torch.float32


def test_engine_refuses_extras_that_do_not_fit_the_spec():
    """A request whose frames are not a spec row, or whose key the model
    does not take, raises naming the key before anything runs."""
    cfg = _port_cfg()
    engine = Engine(cfg, device="cpu", max_batch=2, max_len=MAX_LEN, chunk=CHUNK)
    prompt = np.arange(3, 9, dtype=np.int32)
    bad = np.zeros((ENC_LEN + 1, cfg.d_model), np.float32)
    with pytest.raises(ValueError, match="audio_frames"):
        engine.run([Request(0, prompt, extras={"audio_frames": bad})])
    with pytest.raises(ValueError, match="image_embeds"):
        engine.adopt(Request(1, prompt, extras={"image_embeds": bad}))
    assert engine._extras_host["audio_frames"].shape == (2, ENC_LEN, cfg.d_model)


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_smoke_on_card_matches_cpu(cuda):
    """The smoke config at f32 from one seeded init: the card's greedy tokens
    equal the CPU's through the Engine (own frames per request) and the
    Server."""
    cfg = _port_cfg()
    host = build_model(cfg, device="cpu")
    host.init(torch.Generator().manual_seed(0))
    params = host.state_dict()
    got = {}
    for where in ("cuda", "cpu"):
        eng = Engine(cfg, device=where, params=params, max_batch=SLOTS, max_len=MAX_LEN,
                     chunk=CHUNK, degrade_after=NEVER)
        reqs = _workload(N_REQ, Request, cfg.vocab_size, cfg.d_model)
        eng.run(reqs)
        got[where, "engine"] = [r.out for r in reqs]
        srv = Server(cfg, device=where, params=params, max_len=MAX_LEN)
        reqs = [Request(i, p, max_new=6) for i, p in enumerate(_server_prompts(cfg.vocab_size))]
        srv.run_batch(reqs)
        got[where, "server"] = [r.out for r in reqs]
    for key in ("engine", "server"):
        assert got["cuda", key] == got["cpu", key], key
