"""``recurrentgemma-2b`` (RG-LRU recurrent blocks and local attention in the
pattern (rec, rec, attn), hd 256 over one KV head, 2048-key windows, the
``RingKV`` decode cache) against the JAX package on the CPU, and on the
card against the CPU.

Its smoke config (one superblock, windows of 8, LRU width 64) runs at f32.
The JAX ``Engine`` (on a 1x1 Auto-axis mesh, as ``tests/test_torch_engine.py``
builds it) draws the parameters, which ``params_from_numpy`` carries into
the port; both engines serve the same seeded requests (prompts of 3-30
tokens, most past the window; chunk 5), and the JAX ``Server`` serves three
prompts past the window with the linear and with the ring cache (8 slots,
so every ring wraps): greedy tokens identical request for request.  The
loss and gradients of a 2 x 24 batch: rtol 1e-5 and rtol 5e-3 / atol 1e-5
(as ``tests/test_torch_train.py``).  ``rglru_scan``, ``causal_conv1d`` with
``lens`` and ``ring_write`` past the ring's capacity against the JAX
functions on seeded inputs: rtol 1e-6 / atol 1e-6 for the scan (f32, both
sides pair elements alike), exact for the rest.  The JAX side runs once per
module, in the ``jax_hybrid`` fixture; JAX is imported there and in the
function tests only, so the tests marked ``cuda`` run on a machine without
it: ``PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_hybrid.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config, reduced  # noqa: E402
from repro_torch.launch.engine import Engine  # noqa: E402
from repro_torch.launch.serve import Request, Server  # noqa: E402
from repro_torch.models import RunOptions, build_model  # noqa: E402
from repro_torch.models import cache as dcache  # noqa: E402
from repro_torch.models.hybrid import causal_conv1d, rglru_scan  # noqa: E402
from repro_torch.runtime.fault_tolerance import FaultInjector  # noqa: E402

ARCH = "recurrentgemma-2b"
SLOTS, MAX_LEN, CHUNK, N_REQ = 3, 64, 5, 6
SERVER_PROMPTS = (12, 5, 17)
BATCH, SEQ = 2, 24
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=5e-3, atol=1e-5)
SCAN_TOL = dict(rtol=1e-6, atol=1e-6)
FAULT_PLAN = "slot@2=nan_logits,decode@5=raise"
# the same faults with the row poisoned at its third decode, after a snapshot
SNAPSHOT_PLAN = "slot@2=nan_logits:3,decode@5=raise"
NEVER = 10 ** 9  # no straggler degradation (wall times differ between engines)
RING = RunOptions(windowed_decode_cache=True)


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
def jax_hybrid():
    """The JAX engine's parameters (f32, and a bf16 init's as numpy), its
    tokens, the JAX Server's tokens on the same parameters with the linear
    and the ring cache, and the loss and gradients of one batch."""
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
    server = {}
    try:
        eng = JaxEngine(jcfg, mesh, max_batch=SLOTS, max_len=MAX_LEN, chunk=CHUNK,
                        degrade_after=NEVER, opts=opts)
        reqs = _workload(N_REQ, JaxRequest, jcfg.vocab_size)
        eng.run(reqs)
        params = eng.params
        for layout, ring in (("linear", False), ("ring", True)):
            srv = JaxServer(jcfg, mesh, max_len=MAX_LEN,
                            opts=dataclasses.replace(opts, windowed_decode_cache=ring))
            srv.params = params
            sreqs = [JaxRequest(i, p, max_new=6)
                     for i, p in enumerate(_server_prompts(jcfg.vocab_size))]
            srv.run_batch(sreqs)
            server[layout] = [r.out for r in sreqs]
    finally:
        autotune.set_mode(None)  # Server.__init__ pins the autotune mode process-wide
    jm = jax_build(jcfg, opts)
    batch = JaxDataset(JaxDataConfig(global_batch=BATCH, seq_len=SEQ), jcfg).batch_at(0)
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    bf16 = jax_build(dataclasses.replace(jcfg, dtype="bfloat16"), opts).init(jax.random.PRNGKey(0))
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return dict(params=params_from_numpy(to_np(params)), engine=[r.out for r in reqs],
                server=server, batch=batch, loss=float(loss),
                grads=params_from_numpy(to_np(grads)), bf16_tree=to_np(bf16))


def test_config_and_param_count_match_jax():
    """The config field for field (smoke too) and the analytic parameter
    count: 2.66e9, 5.3 GB in bf16; the derived flags."""
    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke

    for get_p, get_j in ((get_config, jax_config), (get_smoke_config, jax_smoke)):
        cfg, jcfg = get_p(ARCH), get_j(ARCH)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
        assert (cfg.is_attention_free, cfg.supports_long_context) == (
            jcfg.is_attention_free, jcfg.supports_long_context) == (False, True)
    full = get_config(ARCH)
    assert full.param_count() == 2_658_552_320
    assert full.head_dim_ == 256 and (full.n_heads, full.n_kv_heads) == (10, 1)


def test_params_carry_across_unchanged(jax_hybrid):
    """``params_from_numpy`` unstacks the ``groups/rec1|rec2|attn`` and
    ``tail_rec`` trees bit for bit, the LRU's f32 leaves staying f32 in a
    bf16 tree; the f32 engine's parameters fill the port's model."""
    tree = jax_hybrid["bf16_tree"]
    got = params_from_numpy(tree)
    ints = {2: (torch.int16, np.int16), 4: (torch.int32, np.int32)}
    stacked = [(f"groups.{g}", sub) for g, sub in tree["groups"].items()]
    for prefix, sub in stacked + [("tail_rec", tree["tail_rec"])]:
        for name, leaf in sub.items():
            for i in range(leaf.shape[0]):
                t = got[f"{prefix}.{i}.{name}"]
                ti, ni = ints[t.element_size()]
                assert np.array_equal(t.view(ti).numpy(),
                                      np.ascontiguousarray(leaf[i]).view(ni)), name
                f32 = name in ("lru_a_gate", "lru_i_gate", "lru_a_param")
                assert t.dtype == (torch.float32 if f32 else torch.bfloat16), name
    for params, dtype in ((got, "bfloat16"), (jax_hybrid["params"], "float32")):
        model = build_model(reduced(get_smoke_config(ARCH), dtype=dtype), device="cpu")
        assert set(dict(model.named_parameters())) == set(params)
        model.load_state_dict(params)
        assert all(torch.equal(v, params[k]) for k, v in model.state_dict().items())


def test_engine_tokens_identical_to_jax(jax_hybrid):
    """The port's Engine serves the JAX engine's requests with its
    parameters: the same greedy tokens, request for request (chunk 5
    against windows of 8, rows parked under identity state updates)."""
    cfg = _port_cfg()
    engine = Engine(cfg, device="cpu", params=jax_hybrid["params"], max_batch=SLOTS,
                    max_len=MAX_LEN, chunk=CHUNK, degrade_after=NEVER)
    reqs = _workload(N_REQ, Request, cfg.vocab_size)
    engine.run(reqs)
    assert sum(len(r.prompt) > cfg.sliding_window for r in reqs) >= N_REQ // 2
    assert [r.out for r in reqs] == jax_hybrid["engine"]


@pytest.mark.parametrize("plan, snapshot_every", [(FAULT_PLAN, 16), (SNAPSHOT_PLAN, 2)])
def test_engine_under_faults_gives_clean_tokens(jax_hybrid, plan, snapshot_every):
    """An injected fault plan (a poisoned row, a failed decode launch): the
    failed launch retries, the poisoned row's request re-queues, and every
    request's tokens are the clean run's.  Poisoned at its first decode, the
    row replays its prompt; at its third, with a snapshot every 2 tokens, it
    resumes from its snapshot (its ``StateCarry`` slice, ``valid`` flag and
    KV)."""
    engine = Engine(_port_cfg(), device="cpu", params=jax_hybrid["params"], max_batch=SLOTS,
                    max_len=MAX_LEN, chunk=CHUNK, degrade_after=NEVER,
                    snapshot_every=snapshot_every, injector=FaultInjector(plan))
    reqs = _workload(N_REQ, Request, 256)
    out = engine.run(reqs)
    faults = out["stats"]["faults"]
    assert faults["retries"] == 1 and faults["slots_poisoned"] == 1
    assert out["telemetry"]["snapshot_restores"] == (plan == SNAPSHOT_PLAN)
    assert [r.out for r in reqs] == jax_hybrid["engine"]


@pytest.mark.parametrize("layout", ["linear", "ring"])
def test_server_tokens_identical_to_jax(jax_hybrid, layout):
    """The lockstep Server against JAX's with the linear cache and with the
    8-slot ring (``windowed_decode_cache``), which every prompt wraps."""
    cfg = _port_cfg()
    server = Server(cfg, device="cpu", params=jax_hybrid["params"], max_len=MAX_LEN,
                    opts=RING if layout == "ring" else None)
    reqs = [Request(i, p, max_new=6) for i, p in enumerate(_server_prompts(cfg.vocab_size))]
    out = server.run_batch(reqs)
    assert [r.out for r in reqs] == jax_hybrid["server"][layout]
    assert out["logits_finite"]
    _, cache = server.prefill(torch.zeros((1, 4), dtype=torch.int32))
    assert isinstance(cache["kv"], dcache.RingKV if layout == "ring" else dcache.LinearKV)
    if layout == "ring":
        assert cache["kv"].capacity == cfg.sliding_window < max(SERVER_PROMPTS)
        with pytest.raises(NotImplementedError, match="RingKV"):
            server.model.prefill_chunk(torch.zeros((1, 4), dtype=torch.int32),
                                       torch.zeros(1, dtype=torch.int32), cache, first=True)


def test_loss_and_grads_match_jax(jax_hybrid):
    """The loss and every gradient of a 2 x 24 batch, past the windows of 8
    (the LRU gates' and ``lru_a_param``'s f32 gradients through the scan)."""
    model = build_model(_port_cfg(), device="cpu")
    model.load_state_dict(jax_hybrid["params"])
    loss = model.loss({k: torch.from_numpy(v) for k, v in jax_hybrid["batch"].items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_hybrid["loss"], rtol=LOSS_RTOL)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(jax_hybrid["grads"])
    for name, want in jax_hybrid["grads"].items():
        torch.testing.assert_close(grads[name], want, **GRAD_TOL, msg=name)


@pytest.mark.parametrize("seq", [1, 2, 7, 24, 45])
def test_rglru_scan_matches_jax(seq):
    """The associative scan with and without ``h0`` at lengths that take
    each branch of the recursion (odd and even levels)."""
    import jax.numpy as jnp

    from repro.models.hybrid import rglru_scan as jax_scan

    rng = np.random.default_rng(seq)
    a = rng.uniform(0.5, 1.0, (2, seq, 16)).astype(np.float32)
    b = rng.standard_normal((2, seq, 16)).astype(np.float32)
    h0 = rng.standard_normal((2, 16)).astype(np.float32)
    for init in (None, h0):
        want = np.asarray(jax_scan(jnp.asarray(a), jnp.asarray(b),
                                   None if init is None else jnp.asarray(init)))
        got = rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                         None if init is None else torch.from_numpy(init))
        np.testing.assert_allclose(got.numpy(), want, **SCAN_TOL)


def test_causal_conv1d_and_ring_write_match_jax():
    """``causal_conv1d`` with a carried state and per-row ``lens`` (0 keeps
    the state, a full chunk takes the true tail), and ``ring_write`` of a
    chunk longer than the ring at per-row offsets, against JAX."""
    import jax.numpy as jnp

    from repro.models.cache import ring_write as jax_ring_write
    from repro.models.hybrid import causal_conv1d as jax_conv

    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 6, 8)).astype(np.float32)
    w = rng.standard_normal((4, 8)).astype(np.float32)
    state = rng.standard_normal((3, 3, 8)).astype(np.float32)
    lens = np.array([0, 4, 6], np.int32)
    want_y, want_s = jax_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(state),
                              lens=jnp.asarray(lens))
    got_y, got_s = causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(state), lens=torch.from_numpy(lens))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_s[0].numpy(), state[0])

    slab = rng.standard_normal((2, 5, 1, 4)).astype(np.float32)
    for s, at in ((3, np.array([4, 7], np.int32)), (5, np.array([0, 3], np.int32)),
                  (9, np.array([2, 11], np.int32)), (7, 6)):
        new = rng.standard_normal((2, s, 1, 4)).astype(np.float32)
        want = jax_ring_write(jnp.asarray(slab), jnp.asarray(new), jnp.asarray(at))
        got = dcache.ring_write(torch.from_numpy(slab.copy()), torch.from_numpy(new),
                                at if isinstance(at, int) else torch.from_numpy(at))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ring_lanes_and_state_carry_rows():
    """``RingKV``'s lanes against JAX's (``attend_lens``,
    ``slot_positions``), and the composite helpers over the hybrid's cache:
    ``reset_row`` zeroes and invalidates one row's state, ``set_row_valid``
    flips it back, a snapshot restores state, ``valid`` and KV into another
    slot, ``lengths`` is the KV's (None for a bare carry), and a ring
    snapshot does not restore into a linear cache."""
    import jax.numpy as jnp

    from repro.models.cache import RingKV as JaxRing

    pos = np.array([0, 3, 7, 8, 20], np.int32)
    ring = dcache.RingKV.create((2,), 5, 8, 1, 4, torch.float32, device="cpu")
    jring = JaxRing.create((2,), 5, 8, 1, 4, jnp.float32)
    p = torch.from_numpy(pos)
    assert ring.attend_lens(p).tolist() == np.asarray(jring.attend_lens(pos)).tolist()
    assert ring.slot_positions(p).tolist() == np.asarray(jring.slot_positions(pos)).tolist()

    model = build_model(_port_cfg(), device="cpu")
    cache = model.init_cache(3, 16)
    gen = torch.Generator().manual_seed(0)
    for t in cache["state"].states.values():
        t.copy_(torch.randn(t.shape, generator=gen))
    cache["kv"].k.copy_(torch.randn(cache["kv"].k.shape, generator=gen))
    cache = {"state": cache["state"],
             "kv": cache["kv"].replace(pos=torch.tensor([4, 9, 2], dtype=torch.int32))}
    snap = dcache.snapshot_row(cache, 1)
    before = {k: t[:, 1].clone() for k, t in cache["state"].states.items()}
    cache = dcache.reset_row(cache, 1)
    assert cache["state"].valid.tolist() == [True, False, True]
    assert all(torch.count_nonzero(t[:, 1]) == 0 for t in cache["state"].states.values())
    assert dcache.set_row_valid(cache, 1, True)["state"].valid.tolist() == [True] * 3
    dcache.snapshot_compatible(cache, snap)
    cache = dcache.restore_row(cache, 2, snap)
    assert all(torch.equal(t[:, 2], before[k]) for k, t in cache["state"].states.items())
    assert cache["state"].valid.tolist() == [True, False, True]
    assert dcache.lengths(cache).tolist() == [4, 0, 9]
    assert dcache.lengths(cache["state"]) is None
    ring_model = build_model(_port_cfg(), RING, device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        dcache.snapshot_compatible(cache, dcache.snapshot_row(ring_model.init_cache(3, 16), 0))


def test_parked_rows_carry_state_bit_for_bit():
    """A row parked in a chunk (``lens = 0``) and a row that is not
    ``valid`` in a decode step: pad steps are scan identities (a = 1, b = 0)
    and the conv tail is sliced at the valid end, so the row's recurrent
    state comes through bit for bit while its neighbours advance.  Five
    layers: a superblock and a tail of two rec blocks."""
    model = build_model(reduced(_port_cfg(), n_layers=5), device="cpu")
    model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(2, 32)
    gen = torch.Generator().manual_seed(1)
    for t in cache["state"].states.values():
        t.copy_(torch.randn(t.shape, generator=gen))
    before = {k: t.clone() for k, t in cache["state"].states.items()}
    toks = torch.randint(3, 256, (2, 5), generator=gen)
    _, cache = model.prefill_chunk(toks, torch.tensor([4, 0], dtype=torch.int32), cache,
                                   lens=torch.tensor([0, 5], dtype=torch.int32))
    cache = dcache.set_row_valid(cache, 0, False)
    _, cache = model.decode_step(toks[:, :1], torch.tensor([4, 5], dtype=torch.int32), cache)
    for k, t in cache["state"].states.items():
        assert torch.equal(t[:, 0], before[k][:, 0]), k
        assert not torch.equal(t[:, 1], before[k][:, 1]), k


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_smoke_on_card_matches_cpu(cuda):
    """The smoke config at f32 from one seeded init: the card's greedy tokens
    equal the CPU's through the Engine and through the Server with both
    layouts."""
    cfg = _port_cfg()
    host = build_model(cfg, device="cpu")
    host.init(torch.Generator().manual_seed(0))
    params = host.state_dict()
    got = {}
    for where in ("cuda", "cpu"):
        eng = Engine(cfg, device=where, params=params, max_batch=SLOTS, max_len=MAX_LEN,
                     chunk=CHUNK, degrade_after=NEVER)
        reqs = _workload(N_REQ, Request, cfg.vocab_size)
        eng.run(reqs)
        got[where, "engine"] = [r.out for r in reqs]
        for layout, opts in (("linear", None), ("ring", RING)):
            srv = Server(cfg, device=where, params=params, max_len=MAX_LEN, opts=opts)
            reqs = [Request(i, p, max_new=6)
                    for i, p in enumerate(_server_prompts(cfg.vocab_size))]
            srv.run_batch(reqs)
            got[where, layout] = [r.out for r in reqs]
    for key in ("engine", "linear", "ring"):
        assert got["cuda", key] == got["cpu", key], key


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernels_at_ring_lanes_match_plain(cuda, dtype):
    """K1 at hd 256 with 10 query heads over 1 KV head (two-head groups in
    the tensor-core instance) over a 2048-slot ring: wrapped lanes with
    ``q_offset`` past ``sk`` and ``kv_len = C``, unwrapped lanes and an
    empty one; K3 at the 2 x 1024 training shape with window 2048."""
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_ref)

    dt = getattr(torch, dtype)
    bf = dtype == "bfloat16"
    # forward as phase 2 holds K1; backward as tests/test_torch_kernels.py holds K3
    tol = dict(atol=1e-2, rtol=2 ** -7) if bf else dict(atol=1e-5, rtol=1e-5)
    bwd_tol = dict(atol=3e-2, rtol=3e-2) if bf else dict(atol=1e-4, rtol=1e-4)
    g = torch.Generator(device="cuda").manual_seed(0)
    cap, h, hd = 2048, 10, 256
    pos = [2100, 4095, 2047, 0, 3000, 100, 2048, 0]
    qo = torch.tensor(pos, dtype=torch.int32, device="cuda")
    kl = torch.tensor([min(p + 1, cap) for p in pos[:-1]] + [0], dtype=torch.int32,
                      device="cuda")
    q = torch.randn(8, 1, h, hd, device="cuda", generator=g).to(dt)
    k, v = (torch.randn(8, cap, 1, hd, device="cuda", generator=g).to(dt) for _ in "kv")
    kw = dict(causal=True, window=0, q_offset=qo, kv_len=kl)
    out, lse = flash_attention(q, k, v, **kw)
    r_out, r_lse = flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(out.float(), r_out.float(), **tol)
    torch.testing.assert_close(lse, r_lse, atol=1e-4, rtol=1e-5)
    assert torch.count_nonzero(out[7]) == 0

    q, go = (torch.randn(2, 1024, h, hd, device="cuda", generator=g).to(dt) for _ in "qg")
    k, v = (torch.randn(2, 1024, 1, hd, device="cuda", generator=g).to(dt) for _ in "kv")
    out, lse = flash_attention(q, k, v, causal=True, window=cap)
    got = flash_attention_bwd(q, k, v, out, lse, go, causal=True, window=cap)
    want = flash_attention_bwd_ref(q, k, v, out, lse, go, causal=True, window=cap)
    for x, w in zip(got, want):
        torch.testing.assert_close(x.float(), w.float(), **bwd_tol)
