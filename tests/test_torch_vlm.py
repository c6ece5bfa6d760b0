"""``llama-3.2-vision-90b`` (superblocks of self-attention layers and one
gated cross-attention layer over stub image embeddings, the ``CrossKV``
image cache) against the JAX package on the CPU, and on the card against
the CPU.

The gates start at zero, so a freshly drawn model ignores its image and
matching tokens at init would prove nothing about the cross-attention.
Every parity case here sets ``xgate_attn`` / ``xgate_ffn`` to seeded
normals (scale 1) and ``q_norm`` / ``k_norm`` to seeded normals (scale
0.1) in the JAX parameters before both sides run.  The smoke config (one
superblock of 4 self and 1 cross layer, 17 image tokens) runs at f32: the
JAX ``Engine`` (on a 1x1 Auto-axis mesh) and the port's serve the same
seeded requests, each with its own seeded ``image_embeds`` (3 slots, chunk
5), and both ``Server``s draw theirs from ``default_rng(0)``: greedy
tokens identical, also under an injected fault plan.  A 10-layer variant
(two superblocks) gives the loss and every gradient of a 2 x 24 batch
(rtol 1e-5 and rtol 5e-3 / atol 1e-5, as ``tests/test_torch_train.py``)
and the prefill logits.  The JAX side runs once per module, in the
``jax_vlm`` fixture; JAX is imported there and in the config test only, so
the tests marked ``cuda`` run on a machine without it:
``PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_vlm.py``.
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

ARCH = "llama-3.2-vision-90b"
SLOTS, MAX_LEN, CHUNK, N_REQ = 3, 64, 5, 6
N_IMG = 17
SERVER_PROMPTS = (12, 5, 17)
BATCH, SEQ = 2, 24
DEEP = 10  # two superblocks
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=5e-3, atol=1e-5)
LOGITS_ATOL = 1e-4
FAULT_PLAN = "slot@2=nan_logits,decode@5=raise"
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
                 extras={"image_embeds": rng.standard_normal((N_IMG, d)).astype(np.float32)})
            for i in range(n)]


def _server_prompts(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(3, vocab, n).astype(np.int32) for n in SERVER_PROMPTS]


def _port_cfg(n_layers=None):
    cfg = reduced(get_smoke_config(ARCH), dtype="float32")
    return cfg if n_layers is None else reduced(cfg, n_layers=n_layers)


def _set_gates(tree, seed):
    """``tree`` (a JAX parameter dict) with seeded non-zero gates and
    per-head norms in its ``cross_layers``."""
    rng = np.random.default_rng(seed)
    cross = dict(tree["cross_layers"])
    for name, scale in (("xgate_attn", 1.0), ("xgate_ffn", 1.0), ("q_norm", 0.1),
                        ("k_norm", 0.1)):
        leaf = np.asarray(cross[name])
        cross[name] = (scale * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    return {**tree, "cross_layers": cross}


@pytest.fixture(scope="module")
def jax_vlm():
    """The JAX engine's parameters with non-zero gates (and a bf16 init's
    tree as numpy), its tokens, the JAX Server's tokens on the same
    parameters, and for the 10-layer variant its parameters, loss,
    gradients and prefill logits."""
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
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    to_jnp = lambda tree: jax.tree.map(jnp.asarray, tree)  # noqa: E731
    try:
        eng = JaxEngine(jcfg, mesh, max_batch=SLOTS, max_len=MAX_LEN, chunk=CHUNK,
                        degrade_after=NEVER, opts=opts)
        eng.params = params = to_jnp(_set_gates(to_np(eng.params), 0))
        reqs = _workload(N_REQ, JaxRequest, jcfg.vocab_size, jcfg.d_model)
        eng.run(reqs)
        srv = JaxServer(jcfg, mesh, max_len=MAX_LEN, opts=opts)
        srv.params = params
        sreqs = [JaxRequest(i, p, max_new=6)
                 for i, p in enumerate(_server_prompts(jcfg.vocab_size))]
        srv.run_batch(sreqs)
    finally:
        autotune.set_mode(None)  # Server.__init__ pins the autotune mode process-wide
    deep_cfg = dataclasses.replace(jcfg, n_layers=DEEP)
    jm = jax_build(deep_cfg, opts)
    deep = to_jnp(_set_gates(to_np(jax.jit(jm.init)(jax.random.PRNGKey(1))), 1))
    batch = JaxDataset(JaxDataConfig(global_batch=BATCH, seq_len=SEQ), deep_cfg).batch_at(0)
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(
        deep, {k: jnp.asarray(v) for k, v in batch.items()})
    pre = {"tokens": batch["tokens"][:, :9], "image_embeds": batch["image_embeds"]}
    logits, _ = jax.jit(lambda p, b: jm.prefill(p, b, MAX_LEN))(
        deep, {k: jnp.asarray(v) for k, v in pre.items()})
    bf16 = jax.jit(jax_build(dataclasses.replace(deep_cfg, dtype="bfloat16"), opts).init)(
        jax.random.PRNGKey(0))
    return dict(params=params_from_numpy(to_np(params)), engine=[r.out for r in reqs],
                server=[r.out for r in sreqs], deep=params_from_numpy(to_np(deep)),
                batch=batch, loss=float(loss), grads=params_from_numpy(to_np(grads)),
                prefill=pre, logits=np.asarray(logits), bf16_tree=to_np(bf16))


def test_config_and_param_count_match_jax():
    """The config field for field (smoke too) and the reference's analytic
    count, 90,687,021,056: it adds an attention block and two norms per
    cross layer to 100 full layers, 3.02e9 more than the 87,666,799,656
    values of the tree the model builds."""
    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke

    for get_p, get_j in ((get_config, jax_config), (get_smoke_config, jax_smoke)):
        cfg, jcfg = get_p(ARCH), get_j(ARCH)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
    full = get_config(ARCH)
    assert full.param_count() == 90_687_021_056
    model = build_model(full, device="meta")
    assert (model.n_super, model.n_self) == (20, 4)
    assert sum(p.numel() for p in model.parameters()) == 87_666_799_656


def test_params_carry_across_unchanged(jax_vlm):
    """``params_from_numpy`` unstacks ``self_layers`` (stacked twice, (2, 4,
    ...)) and ``cross_layers`` with its scalar gates and per-head norms,
    bit for bit; the f32 parameters fill the port's 10-layer model."""
    tree = jax_vlm["bf16_tree"]
    got = params_from_numpy(tree)
    for name, leaf in tree["self_layers"].items():
        assert leaf.shape[:2] == (2, 4), name
        for s in range(2):
            for j in range(4):
                t = got[f"self_layers.{s}.{j}.{name}"]
                assert t.dtype == torch.bfloat16
                assert np.array_equal(t.view(torch.int16).numpy(),
                                      np.ascontiguousarray(leaf[s, j]).view(np.int16)), name
    for name, leaf in tree["cross_layers"].items():
        for s in range(2):
            t = got[f"cross_layers.{s}.{name}"]
            assert t.shape == leaf.shape[1:], name
            assert np.array_equal(t.view(torch.int16).reshape(-1).numpy(),
                                  np.array(leaf[s]).reshape(-1).view(np.int16)), name
    assert got["cross_layers.1.xgate_attn"].shape == ()
    for params, cfg in ((got, reduced(get_smoke_config(ARCH), n_layers=DEEP)),
                        (jax_vlm["deep"], _port_cfg(DEEP))):
        model = build_model(cfg, device="cpu")
        assert set(dict(model.named_parameters())) == set(params)
        model.load_state_dict(params)
        assert all(torch.equal(v, params[k]) for k, v in model.state_dict().items())


@pytest.mark.parametrize("plan", ["", FAULT_PLAN])
def test_engine_tokens_identical_to_jax(jax_vlm, plan):
    """The port's Engine serves the JAX engine's requests, each with its own
    image, with its parameters and non-zero gates: the same greedy tokens
    request for request; under an injected fault plan (a poisoned row whose
    replayed first chunk reads its own staged image again, a failed decode
    launch) too."""
    cfg = _port_cfg()
    engine = Engine(cfg, device="cpu", params=jax_vlm["params"], max_batch=SLOTS,
                    max_len=MAX_LEN, chunk=CHUNK, degrade_after=NEVER,
                    injector=FaultInjector(plan))
    reqs = _workload(N_REQ, Request, cfg.vocab_size, cfg.d_model)
    out = engine.run(reqs)
    assert out["stats"]["faults"]["slots_poisoned"] == (1 if plan else 0)
    assert [r.out for r in reqs] == jax_vlm["engine"]


def test_server_tokens_identical_to_jax(jax_vlm):
    """The lockstep Server against JAX's: both draw the wave's images from
    ``default_rng(0)``."""
    cfg = _port_cfg()
    server = Server(cfg, device="cpu", params=jax_vlm["params"], max_len=MAX_LEN)
    reqs = [Request(i, p, max_new=6) for i, p in enumerate(_server_prompts(cfg.vocab_size))]
    out = server.run_batch(reqs)
    assert [r.out for r in reqs] == jax_vlm["server"]
    assert out["logits_finite"]


def test_loss_grads_and_prefill_match_jax_over_two_superblocks(jax_vlm):
    """The 10-layer variant: the loss and every gradient of a 2 x 24 batch
    (the gates', ``q_norm``'s and ``k_norm``'s included), and the prefill
    logits of 9 tokens with their images."""
    model = build_model(_port_cfg(DEEP), device="cpu")
    model.load_state_dict(jax_vlm["deep"])
    loss = model.loss({k: torch.from_numpy(v) for k, v in jax_vlm["batch"].items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_vlm["loss"], rtol=LOSS_RTOL)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(jax_vlm["grads"])
    for name, want in jax_vlm["grads"].items():
        torch.testing.assert_close(grads[name], want, **GRAD_TOL, msg=name)
    for name in ("xgate_attn", "xgate_ffn", "q_norm", "k_norm"):
        assert torch.count_nonzero(grads[f"cross_layers.1.{name}"]) > 0, name
    logits, _ = model.prefill({k: torch.from_numpy(v) for k, v in jax_vlm["prefill"].items()},
                              MAX_LEN)
    np.testing.assert_allclose(logits.numpy(), jax_vlm["logits"], atol=LOGITS_ATOL)


def _images(b, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, N_IMG, 64)).astype(np.float32))


def test_one_request_image_moves_its_logits_only(jax_vlm):
    """Redrawing one row's image changes that row's prefill logits and
    leaves every other row's bit for bit; with the gates at zero (a fresh
    init) the image changes nothing."""
    cfg = _port_cfg()
    server = Server(cfg, device="cpu", params=jax_vlm["params"], max_len=MAX_LEN)
    toks = torch.from_numpy(np.stack(_server_prompts(cfg.vocab_size)[2:] * 3))
    img = _images(3, 0)
    moved = img.clone()
    moved[1] = _images(1, 1)[0]
    base, _ = server.prefill(toks, {"image_embeds": img})
    got, _ = server.prefill(toks, {"image_embeds": moved})
    assert torch.equal(got[0], base[0]) and torch.equal(got[2], base[2])
    assert (got[1] - base[1]).abs().max() > 1e-3
    fresh = Server(cfg, device="cpu", max_len=MAX_LEN)
    assert torch.equal(fresh.prefill(toks, {"image_embeds": img})[0],
                       fresh.prefill(toks, {"image_embeds": moved})[0])


def test_parked_row_cross_kv_bit_for_bit():
    """A first-chunk launch writes the image k/v of its live rows only, in
    every superblock of the 10-layer variant (the ``CrossKV``'s
    ``(n_super,)`` lead) with non-zero gates and norms: a parked row
    (``lens = 0``) keeps its slabs bit for bit, a live row's equal its own
    image's ``k_norm``-ed k and v; the rows go through ``snapshot_row`` /
    ``restore_row`` and a reset leaves them."""
    model = build_model(_port_cfg(DEEP), device="cpu")
    model.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for layer in model.cross_layers:
            for p in (layer.xgate_attn, layer.xgate_ffn, layer.q_norm, layer.k_norm):
                p.copy_(torch.randn(p.shape, generator=gen))
    cache = model.init_cache(2, MAX_LEN)
    assert cache["img"].k.shape == (2, 2, N_IMG, 2, 16)
    for t in (cache["img"].k, cache["img"].v):
        t.copy_(torch.randn(t.shape, generator=gen))
    before = cache["img"].k[:, 0].clone(), cache["img"].v[:, 0].clone()
    toks = torch.randint(3, 256, (2, 5), generator=gen)
    img = _images(2, 2)
    _, cache = model.prefill_chunk(toks, torch.tensor([7, 0], dtype=torch.int32), cache,
                                   first=True, lens=torch.tensor([0, 5], dtype=torch.int32),
                                   extras={"image_embeds": img})
    assert torch.equal(cache["img"].k[:, 0], before[0])
    assert torch.equal(cache["img"].v[:, 0], before[1])
    with torch.no_grad():
        for sb, layer in enumerate(model.cross_layers):
            k, v = model._image_kv(layer, img)
            assert torch.equal(cache["img"].k[sb, 1], k[1])
            assert torch.equal(cache["img"].v[sb, 1], v[1])
    snap = dcache.snapshot_row(cache, 1)
    cache = dcache.reset_row(cache, 0)
    assert torch.equal(cache["img"].k[:, 0], before[0])
    dcache.snapshot_compatible(cache, snap)
    cache = dcache.restore_row(cache, 0, snap)
    assert torch.equal(cache["img"].k[:, 0], cache["img"].k[:, 1])
    assert torch.equal(cache["img"].v[:, 0], cache["img"].v[:, 1])
    assert dcache.lengths(cache).tolist() == [5, 5]


def test_engine_refuses_extras_that_do_not_fit_the_spec():
    """A request whose image is not a spec row, or whose key the model does
    not take, raises naming the key before anything runs."""
    cfg = _port_cfg()
    engine = Engine(cfg, device="cpu", max_batch=2, max_len=MAX_LEN, chunk=CHUNK)
    prompt = np.arange(3, 9, dtype=np.int32)
    for bad in (np.zeros((N_IMG + 1, cfg.d_model), np.float32),
                np.zeros((N_IMG, cfg.d_model - 1), np.float32)):
        with pytest.raises(ValueError, match="image_embeds"):
            engine.run([Request(0, prompt, extras={"image_embeds": bad})])
    with pytest.raises(ValueError, match="audio_frames"):
        engine.adopt(Request(1, prompt, extras={
            "audio_frames": np.zeros((16, cfg.d_model), np.float32)}))
    assert engine._extras_host["image_embeds"].shape == (2, N_IMG, cfg.d_model)


def test_int8_policy_keeps_the_self_cache_in_the_activation_dtype():
    """Under ``attention=pallas:kv_dtype=int8`` the self cache, with its
    (n_super, n_self) lead, stays f32 and unquantized, as JAX's
    ``init_cache`` builds it, so nothing on this path runs K1q."""
    model = build_model(_port_cfg(DEEP), device="cpu")
    with policy.apply(**INT8):
        cache = model.init_cache(2, MAX_LEN)
    assert not cache["self"].quantized and cache["self"].k.dtype == torch.float32
    assert cache["self"].k.shape == (2, 4, 2, MAX_LEN, 2, 16) and cache["self"].b_axis == 2
    assert cache["img"].k.shape == (2, 2, N_IMG, 2, 16)


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_smoke_on_card_matches_cpu(cuda):
    """The 10-layer variant at f32 from one seeded init with non-zero gates:
    the card's greedy tokens equal the CPU's through the Engine (own image
    per request) and the Server."""
    cfg = _port_cfg(DEEP)
    host = build_model(cfg, device="cpu")
    host.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for layer in host.cross_layers:
            layer.xgate_attn.copy_(torch.randn((), generator=gen))
            layer.xgate_ffn.copy_(torch.randn((), generator=gen))
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
