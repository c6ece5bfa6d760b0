"""``RunOptions``' execution knobs in the port, against the JAX package, on
the CPU.

``policy.from_run_options`` gives JAX's update dict for the same options;
every field of the JAX ``RunOptions`` exists in the port's with its name
and default.  Under ``fused_qkv=True`` (or the ``--impl`` spec
``matmul=pallas:qkv_fused=true``) each attention block runs one QKV
product, and the port's Engine serves the JAX Engine's tokens under the
same options on the ``qwen3-1.7b`` and ``recurrentgemma-2b`` smoke configs;
``use_banded_local=True`` on ``gemma3-1b``'s (windows of 8, prompts past
them) serves JAX's tokens too.  The JAX engines run on a 1x1 Auto-axis mesh
(see ``tests/test_torch_engine.py``), each once per module.
"""
import dataclasses
import itertools

import jax
import numpy as np
import pytest
from jax.sharding import AxisType

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import policy as jax_policy  # noqa: E402
from repro.launch.engine import Engine as JaxEngine  # noqa: E402
from repro.launch.serve import Request as JaxRequest  # noqa: E402
from repro.models.base import RunOptions as JaxRunOptions  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config, reduced  # noqa: E402
from repro_torch.kernels import policy, registry  # noqa: E402
from repro_torch.launch.engine import Engine  # noqa: E402
from repro_torch.launch.serve import Request  # noqa: E402
from repro_torch.models import RunOptions, build_model  # noqa: E402
from repro_torch.models import common  # noqa: E402

NEVER = 10 ** 9  # no straggler degradation (wall times differ between engines)
SLOTS, MAX_LEN = 3, 64
# (arch, JAX options beside remat="none", chunk): chunk 5 does not divide the
# windows of 8, and the prompts pass them
SERVED = {
    "qwen3-1.7b": ("qwen3-1.7b", {}, 8),
    "qwen3-1.7b fused": ("qwen3-1.7b", dict(fused_qkv=True), 8),
    "recurrentgemma-2b fused": ("recurrentgemma-2b", dict(fused_qkv=True), 5),
    "gemma3-1b banded": ("gemma3-1b", dict(use_banded_local=True), 5),
}


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
    return [make(i, rng.integers(3, vocab, int(rng.integers(4, 24))).astype(np.int32),
                 max_new=int(rng.integers(2, 9)))
            for i in range(n)]


@pytest.fixture(scope="module")
def jax_served():
    """Each case's JAX engine tokens and params (numpy), served under its
    options."""
    from repro.kernels import autotune

    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    out = {}
    try:
        for case, (arch, kw, chunk) in SERVED.items():
            jcfg = dataclasses.replace(jax_smoke(arch), dtype="float32")
            eng = JaxEngine(jcfg, mesh, max_batch=SLOTS, max_len=MAX_LEN, chunk=chunk,
                            degrade_after=NEVER, opts=JaxRunOptions(remat="none", **kw))
            reqs = _workload(5, JaxRequest, jcfg.vocab_size)
            eng.run(reqs)
            out[case] = ([r.out for r in reqs],
                         params_from_numpy(jax.tree.map(np.asarray, eng.params)))
    finally:
        autotune.set_mode(None)  # Server.__init__ pins the autotune mode process-wide
    return out


@pytest.mark.parametrize("case", list(SERVED))
def test_engine_under_options_matches_jax(jax_served, case):
    arch, kw, chunk = SERVED[case]
    tokens, params = jax_served[case]
    cfg = reduced(get_smoke_config(arch), dtype="float32")
    eng = Engine(cfg, device="cpu", params=params, max_batch=SLOTS, max_len=MAX_LEN,
                 chunk=chunk, degrade_after=NEVER, opts=RunOptions(remat="none", **kw))
    reqs = _workload(5, Request, cfg.vocab_size)
    eng.run(reqs)
    assert [r.out for r in reqs] == tokens


def _grid():
    """Combinations of the knobs ``from_run_options`` reads, and the rest at
    a non-default value or two."""
    for attn, mm, fused, tune in itertools.product(
            ("auto", "pallas", "jnp"), ("auto", "ref", "pallas"), (False, True),
            (None, "off", "replay", "search")):
        yield dict(attention_impl=attn, matmul_impl=mm, fused_qkv=fused, autotune=tune)
    yield dict(q_block=64, kv_block=128, use_banded_local=True, causal_block_skip=True)
    yield dict(remat="none", ce_chunk=256, windowed_decode_cache=True, moe_dispatch="onehot",
               moe_groups=2, microbatches=4)


@pytest.mark.parametrize("fields", list(_grid()), ids=str)
def test_from_run_options_matches_jax(fields):
    assert policy.from_run_options(RunOptions(**fields)) == \
        jax_policy.from_run_options(JaxRunOptions(**fields))


def test_run_options_fields_and_defaults_match_jax():
    """Every JAX field, in JAX's order, with JAX's default: a JAX
    ``RunOptions`` carries across, positionally too."""
    jax_fields = [(f.name, f.default) for f in dataclasses.fields(JaxRunOptions)]
    assert [(f.name, f.default) for f in dataclasses.fields(RunOptions)] == jax_fields
    j = JaxRunOptions(remat="none", q_block=32, fused_qkv=True, autotune="off",
                      use_banded_local=True, microbatches=2)
    assert dataclasses.asdict(RunOptions(**dataclasses.asdict(j))) == dataclasses.asdict(j)
    assert RunOptions(*dataclasses.astuple(j)) == RunOptions(**dataclasses.asdict(j))


def _counting_dispatch(monkeypatch):
    """Patch ``registry.dispatch`` to record (op, route, b's width, b's data
    pointer) per call."""
    calls = []
    real = registry.dispatch

    def dispatch(name, *args, **kw):
        calls.append((name, registry.resolve(name, device=args[0].device),
                      args[1].shape[-1] if name == "matmul" else None,
                      args[1].data_ptr() if name == "matmul" else None))
        return real(name, *args, **kw)

    monkeypatch.setattr(registry, "dispatch", dispatch)
    return calls


@pytest.mark.parametrize("fused", [False, True])
def test_qkv_project_dispatch_count(monkeypatch, fused):
    """One matmul dispatch of width q+k+v under the variant, three without;
    the same values either way."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 16, generator=g)
    ws = [torch.randn(16, n, generator=g) for n in (32, 8, 8)]
    want = [x @ w for w in ws]
    calls = _counting_dispatch(monkeypatch)
    with policy.apply(variants={"matmul": {"qkv_fused": True}} if fused else {}):
        got = common.qkv_project(x, *ws)
    assert [c[2] for c in calls] == ([48] if fused else [32, 8, 8])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("how", ["run_options", "impl_spec", "unfused"])
def test_fused_qkv_one_product_per_attention_block(monkeypatch, how):
    """A decode step of the qwen3-1.7b smoke config: 5 matmul dispatches a
    layer (one QKV product) under ``fused_qkv=True`` or the ``--impl`` spec
    ``matmul=pallas:qkv_fused=true``, 7 without; plus the logits."""
    cfg = reduced(get_smoke_config("qwen3-1.7b"), dtype="float32")
    opts = RunOptions(fused_qkv=how == "run_options")
    model = build_model(cfg, opts, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(2, 16)
    tokens = torch.tensor([[5], [7]], dtype=torch.int32)
    pos = torch.tensor([0, 0], dtype=torch.int32)
    calls = _counting_dispatch(monkeypatch)
    impl, variants = policy.parse_impl_spec("matmul=pallas:qkv_fused=true")
    with policy.apply(**(dict(impl=impl, variants=variants) if how == "impl_spec" else {})):
        model.decode_step(tokens, pos, cache)
    per_layer = 7 if how == "unfused" else 5
    assert sum(c[0] == "matmul" for c in calls) == per_layer * cfg.n_layers + 1
    # the fused products' B is the per-call concatenation, no parameter
    weights = {p.data_ptr() for p in model.parameters()}
    fused = [c for c in calls if c[0] == "matmul" and c[3] not in weights]
    assert [c[2] for c in fused] == \
        ([] if how == "unfused" else [cfg.q_dim + 2 * cfg.kv_dim] * cfg.n_layers)


def test_fused_qkv_trains_under_remat():
    """Training under ``fused_qkv=True`` with layer recomputation: the
    backward's recomputation runs the fused product too, and the loss and
    gradients equal the unfused model's."""
    cfg = reduced(get_smoke_config("qwen3-1.7b"), dtype="float32")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(3, cfg.vocab_size, (2, 12)).astype(np.int64))
             for k in ("tokens", "labels")}
    out = {}
    for fused in (False, True):
        model = build_model(cfg, RunOptions(remat="full", fused_qkv=fused), device="cpu")
        model.init(torch.Generator().manual_seed(0))
        loss = model.loss(batch)
        loss.backward()
        out[fused] = (loss.item(), {n: p.grad for n, p in model.named_parameters()})
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-6)
    for name, grad in out[False][1].items():
        torch.testing.assert_close(out[True][1][name], grad, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("mode", ["replay", "search"])
def test_autotune_modes_raise_naming_the_queue_item(jax_served, mode, tmp_path, monkeypatch):
    """The measured autotune's modes, which the port once refused, build and
    serve: the ``Engine`` under ``RunOptions(autotune=mode)`` at f32 gives
    the JAX engine's tokens (``search`` measures every product it meets on
    the CPU and records it in a table under ``REPRO_TUNE_DIR``; ``replay``
    reads that table).  An unknown mode still raises."""
    from repro_torch.kernels import autotune

    monkeypatch.setenv("REPRO_TUNE_DIR", str(tmp_path))
    autotune.clear_cache()
    cfg = reduced(get_smoke_config("qwen3-1.7b"), dtype="float32")
    with pytest.raises(ValueError, match="unknown autotune mode"):
        build_model(cfg, RunOptions(autotune="sometimes"), device="cpu")
    model = build_model(cfg, RunOptions(autotune="off"), device="cpu")
    assert "autotune=off" in policy.current().with_(autotune="off").describe()
    assert model.opts.autotune == "off"
    tokens, params = jax_served["qwen3-1.7b"]
    try:
        eng = Engine(cfg, device="cpu", params=params, max_batch=SLOTS, max_len=MAX_LEN,
                     chunk=8, degrade_after=NEVER,
                     opts=RunOptions(remat="none", autotune=mode))
        assert eng.model.opts.autotune == mode and autotune.mode() == mode
        reqs = _workload(5, Request, cfg.vocab_size)
        eng.run(reqs)
    finally:
        autotune.set_mode(None)  # Server.__init__ pins the autotune mode process-wide
    assert [r.out for r in reqs] == tokens
    table = autotune.load_table("cpu")
    assert bool(table) == (mode == "search")
    assert all(k.startswith(("matmul|", "attention|")) for k in table)


def test_matmul_impl_jnp_runs_the_plain_version_on_cpu(monkeypatch):
    """``matmul_impl="jnp"`` routes every model product to the plain version
    on a CPU tensor (the default routes them to the kernel's wrapper), with
    the same logits."""
    cfg = reduced(get_smoke_config("qwen3-1.7b"), dtype="float32")
    tokens = torch.tensor([[5, 9, 11, 3]], dtype=torch.int32)
    logits = {}
    for impl in ("auto", "jnp"):
        model = build_model(cfg, RunOptions(matmul_impl=impl), device="cpu")
        model.init(torch.Generator().manual_seed(0))
        calls = _counting_dispatch(monkeypatch)
        logits[impl], _ = model.prefill({"tokens": tokens}, 16)
        routes = {route for name, route, *_ in calls if name == "matmul"}
        assert routes == ({"jnp"} if impl == "jnp" else {"pallas"})
        monkeypatch.undo()
    torch.testing.assert_close(logits["jnp"], logits["auto"], rtol=1e-5, atol=1e-5)
