"""The port's measured autotune (``repro_torch.kernels.autotune``) against
the JAX package's (``repro.kernels.autotune``).

Keys: for each case the port's ``entry_key`` is JAX's string for the same
call (an attention call's operands folded to JAX's ``(b * heads, s, hd)``),
with ``REPRO_FAST_BYTES`` fixing both planners' device parameters.  Tables:
the same entries written by both ``save_table``s give the same file apart
from the stamp, ``nearest_plan`` borrows the same key from the same table,
and foreign, corrupt and stale-stamp files are cold on either side.  Modes:
JAX's ``test_mode_resolution`` case for case.  Search and replay on CPU
tensors (the plain versions timed), the dispatch overlay seen by a spy on
the wrapper's kwargs, no search under stream capture, the K2 and K1q
validators, and the ``Server``/``Engine`` under ``replay`` (a hand-written
table) and ``search`` against the JAX server's and engine's f32 tokens.
"""
import dataclasses
import importlib
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AxisType

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import autotune as jax_autotune  # noqa: E402
from repro.launch.engine import Engine as JaxEngine  # noqa: E402
from repro.launch.serve import Request as JaxRequest  # noqa: E402
from repro.launch.serve import Server as JaxServer  # noqa: E402
from repro.models.base import RunOptions as JaxRunOptions  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config, reduced  # noqa: E402
from repro_torch.kernels import autotune, planner, policy, registry  # noqa: E402
from repro_torch.launch.engine import Engine  # noqa: E402
from repro_torch.launch.serve import Request, Server  # noqa: E402
from repro_torch.models import RunOptions  # noqa: E402
from repro_torch.runtime.replica import spawn_replica  # noqa: E402

k2 = importlib.import_module("repro_torch.kernels.hbp_matmul")
fa = importlib.import_module("repro_torch.kernels.flash_attention")

MAX_LEN, SLOTS, CHUNK = 64, 3, 8
NEVER = 10 ** 9  # no straggler degradation (wall times differ between engines)
PROMPT_LENS = (8, 5, 11)


@pytest.fixture(autouse=True)
def _reset_port_autotune():
    """The port's Server, Engine and trainer pin the autotune mode
    process-wide (``autotune.startup``), as JAX's do: clear it after each
    test."""
    yield
    autotune.set_mode(None)


@pytest.fixture
def tune_dir(tmp_path, monkeypatch):
    """A fresh table directory for both packages, caches dropped."""
    monkeypatch.setenv("REPRO_TUNE_DIR", str(tmp_path))
    autotune.clear_cache()
    jax_autotune.clear_cache()
    yield tmp_path
    autotune.clear_cache()
    jax_autotune.clear_cache()


def _t(shape, dtype="float32", seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
    if dtype == "complex64":
        x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.from_numpy(x.astype(np.complex64))
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        getattr(torch, dtype))


def _sds(x, fold=None):
    """The JAX stand-in of a port tensor (attention's ``fold``: (b, s, h, d)
    -> (b*h, s, d))."""
    shape = tuple(x.shape)
    if fold:
        shape = (shape[0] * shape[2], shape[1], shape[3])
    return jax.ShapeDtypeStruct(shape, jnp.dtype(str(x.dtype).removeprefix("torch.")))


# (op, tensors (shapes, dtypes), kwargs); attention in the port's layout
KEY_CASES = {
    "matmul f32 classical": ("matmul", [((64, 48), "float32"), ((48, 80), "float32")], {}),
    "matmul bf16 decode": ("matmul", [((8, 256), "bfloat16"), ((256, 384), "bfloat16")], {}),
    "matmul f32 strassen": ("matmul", [((256, 256), "float32"), ((256, 256), "float32")], {}),
    "matmul bf16 strassen": ("matmul", [((512, 512), "bfloat16"), ((512, 512), "bfloat16")],
                             {}),
    "matmul forced classical": ("matmul", [((256, 256), "float32"), ((256, 256), "float32")],
                                {"backend": "classical"}),
    "scan f32": ("scan", [((8, 3000), "float32")], {}),
    "scan bf16": ("scan", [((4, 256), "bfloat16")], {}),
    "transpose f32": ("transpose", [((384, 500), "float32")], {}),
    "transpose bf16": ("transpose", [((128, 64), "bfloat16")], {}),
    "fft": ("fft", [((2, 1024), "complex64")], {}),
    "attention prefill f32": ("attention", [((2, 24, 4, 16), "float32"),
                                            ((2, 24, 2, 16), "float32"),
                                            ((2, 24, 2, 16), "float32")], {}),
    "attention prefill bf16 window": ("attention", [((2, 40, 4, 32), "bfloat16"),
                                                    ((2, 40, 4, 32), "bfloat16"),
                                                    ((2, 40, 4, 32), "bfloat16")],
                                      {"causal": True, "window": 8}),
    "attention decode bf16": ("attention", [((3, 1, 4, 16), "bfloat16"),
                                            ((3, 64, 2, 16), "bfloat16"),
                                            ((3, 64, 2, 16), "bfloat16")], {"causal": True}),
    "attention decode int8 cache": ("attention", [((3, 1, 4, 16), "bfloat16"),
                                                  ((3, 64, 2, 16), "int8"),
                                                  ((3, 64, 2, 16), "int8")], {}),
    "attention decode int8 long cache": ("attention", [((3, 1, 4, 16), "bfloat16"),
                                                       ((3, 512, 2, 16), "int8"),
                                                       ((3, 512, 2, 16), "int8")], {}),
    "attention chunk f32 int8 cache": ("attention", [((3, 8, 4, 16), "float32"),
                                                     ((3, 64, 2, 16), "int8"),
                                                     ((3, 64, 2, 16), "int8")], {}),
    "attention non-causal": ("attention", [((2, 5, 4, 16), "float32"),
                                           ((2, 17, 4, 16), "float32"),
                                           ((2, 17, 4, 16), "float32")], {"causal": False}),
}


@pytest.mark.parametrize("fast_bytes", ["65536", "8388608"])
@pytest.mark.parametrize("case", list(KEY_CASES))
def test_entry_key_is_jax_string(case, fast_bytes, monkeypatch):
    monkeypatch.setenv("REPRO_FAST_BYTES", fast_bytes)
    op, specs, kw = KEY_CASES[case]
    args = [_t(shape, dtype) for shape, dtype in specs]
    jargs = [_sds(a, fold=op == "attention") for a in args]
    want = jax_autotune.entry_key(op, *jargs, kwargs=kw)
    assert autotune.entry_key(op, *args, kwargs=kw) == want
    assert autotune.shape_class(*autotune.key_shapes(op, args)) == \
        jax_autotune.shape_class(*jargs)


def test_entry_key_matmul_backends_both_seen(monkeypatch):
    """At a small fast memory the planner sends square products to Strassen
    and the rest to the classical backend, in both packages' keys."""
    monkeypatch.setenv("REPRO_FAST_BYTES", "65536")
    sq = [_t((256, 256)), _t((256, 256))]
    rect = [_t((64, 48)), _t((48, 80))]
    assert autotune.entry_key("matmul", *sq).endswith("backend=strassen")
    assert autotune.entry_key("matmul", *rect).endswith("backend=classical")


# -- tables --------------------------------------------------------------------

ENTRIES = {
    "scan|8x1024|float32": {"plan": {"block": 256}, "us": 3.5, "analytic_plan": {"block": 1024},
                            "analytic_us": 4.0, "iters": 5, "candidates": 3},
    "scan|8x8192|float32": {"plan": {"block": 2048}, "us": 9.0,
                            "analytic_plan": {"block": 8192}, "analytic_us": 9.5,
                            "iters": 5, "candidates": 4},
    "scan|64x1024|float32": {"plan": {"block": 128}, "us": 20.0,
                             "analytic_plan": {"block": 1024}, "analytic_us": 21.0,
                             "iters": 5, "candidates": 4},
    "matmul|64x64_64x128|float32|backend=classical": {
        "plan": {"backend": "classical", "tile_n": 128, "splits": 2}, "us": 1.0},
}


def _fill(mod, kind, tune_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_DIR", str(tune_path))
    mod.clear_cache()
    mod.load_table(kind).update(json.loads(json.dumps(ENTRIES)))
    return mod.save_table(kind)


def test_saved_tables_are_jax_format_but_stamp(tmp_path, monkeypatch):
    jpath = _fill(jax_autotune, "cpu", tmp_path / "jax", monkeypatch)
    ppath = _fill(autotune, "cpu", tmp_path / "port", monkeypatch)
    assert (jpath.name, ppath.name) == ("cpu.json", "torch-cpu.json")
    j, p = json.loads(jpath.read_text()), json.loads(ppath.read_text())
    assert j.pop("jax_version") == jax.__version__
    stamp = autotune.table_stamp()
    assert {k: p.pop(k) for k in stamp} == stamp
    assert p == j and p["version"] == 3 and p["device_kind"] == "cpu"
    # and each is cold to the other package under the other's name
    (tmp_path / "jax" / ppath.name).write_text(jpath.read_text())
    (tmp_path / "port" / jpath.name).write_text(ppath.read_text())
    monkeypatch.setenv("REPRO_TUNE_DIR", str(tmp_path / "jax"))
    autotune.clear_cache()
    assert autotune.load_table("cpu") == {}
    monkeypatch.setenv("REPRO_TUNE_DIR", str(tmp_path / "port"))
    jax_autotune.clear_cache()
    assert jax_autotune.load_table("cpu") == {}
    autotune.clear_cache()
    assert autotune.load_table("cpu") == ENTRIES


def test_jax_table_survives_a_port_search_and_back(tune_dir):
    """Both packages keep their tables in one REPRO_TUNE_DIR: a search in
    either leaves the other's table as it was."""
    jax_autotune.load_table("cpu").update(json.loads(json.dumps(ENTRIES)))
    jpath = jax_autotune.save_table("cpu")
    written = jpath.read_text()
    x = _t((2, 256))
    autotune.search("scan", x, iters=1, max_candidates=2)
    assert jpath.read_text() == written
    jax_autotune.clear_cache()
    assert jax_autotune.load_table("cpu") == ENTRIES
    ported = autotune.table_path("cpu").read_text()
    jax_autotune.search("scan", jax.numpy.asarray(x.numpy()), iters=1, max_candidates=2)
    assert autotune.table_path("cpu").read_text() == ported
    autotune.clear_cache()
    assert list(autotune.load_table("cpu")) == [autotune.entry_key("scan", x)]


@pytest.mark.parametrize("shape", [(8, 2048), (8, 512), (32, 1024), (16, 4096)])
def test_nearest_plan_borrows_jax_key(shape, tmp_path, monkeypatch):
    caplog_free = logging.getLogger("repro_torch.autotune")
    caplog_free.disabled = True
    try:
        _fill(jax_autotune, "cpu", tmp_path / "jax", monkeypatch)
        want = jax_autotune.nearest_plan("scan", jax.ShapeDtypeStruct(shape, jnp.float32))
        _fill(autotune, "cpu", tmp_path / "port", monkeypatch)
        got = autotune.nearest_plan("scan", _t(shape))
    finally:
        caplog_free.disabled = False
    assert got == want and got is not None


@pytest.mark.parametrize("payload", [
    "not json at all {{{",
    '{"version": 99, "entries": {}}',
    '[1, 2, 3]',
    '{"version": 1, "entries": {"scan|4x256|float32": {"plan": {"block": "x"}}}}',
    "jax",  # a table JAX wrote: stamped jax_version, no torch_version
    "torch",  # the port's format under another torch
    "kernels",  # the port's format over other kernel sources
])
def test_foreign_corrupt_and_stale_tables_are_cold(tune_dir, payload):
    x = _t((2, 256))
    key = autotune.entry_key("scan", x)
    path = autotune.table_path("cpu")
    path.parent.mkdir(parents=True, exist_ok=True)
    good = {"version": 3, "device_kind": "cpu", **autotune.table_stamp(),
            "entries": {key: {"plan": {"block": 64}, "us": 1.0}}}
    if payload == "jax":
        good = {k: v for k, v in good.items() if k not in autotune.table_stamp()}
        good["jax_version"] = jax.__version__
    elif payload in ("torch", "kernels"):
        good[{"torch": "torch_version", "kernels": "kernels"}[payload]] = "elsewhere"
    path.write_text(json.dumps(good) if payload in ("jax", "torch", "kernels") else payload)
    autotune.clear_cache()
    assert autotune.load_table("cpu") == {}  # never raises
    with autotune.mode_scope("replay"):
        assert autotune.overlay("scan", (x,)) == {}
        got = registry.dispatch("scan", x)  # still runs, on the planner's plan
    torch.testing.assert_close(got, torch.cumsum(x, -1), rtol=1e-5, atol=1e-5)


# -- modes (JAX's test_mode_resolution, case for case) -------------------------

@pytest.mark.parametrize("mod", [autotune, jax_autotune], ids=["port", "jax"])
def test_mode_resolution(mod, monkeypatch):
    monkeypatch.setattr(mod, "_mode_override", None)
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    assert mod.mode() == "off"
    assert mod.resolve_mode() == "replay"
    assert mod.resolve_mode("search") == "search"
    monkeypatch.setenv("REPRO_AUTOTUNE", "search")
    assert mod.mode() == "search"
    assert mod.resolve_mode() == "search"
    with pytest.raises(ValueError, match="unknown autotune mode"):
        mod.resolve_mode("sideways")
    with pytest.raises(ValueError, match="unknown autotune mode"):
        mod.set_mode("sideways")
    monkeypatch.setenv("REPRO_AUTOTUNE", "bogus")
    assert mod.mode() == "off"


def test_mode_precedence_policy_over_process_over_env(monkeypatch):
    monkeypatch.setattr(autotune, "_mode_override", None)
    monkeypatch.setenv("REPRO_AUTOTUNE", "search")
    with autotune.mode_scope("replay"):
        assert autotune.mode() == "replay"
        with policy.apply(autotune="off"):
            assert autotune.mode() == "off"
        assert autotune.mode() == "replay"
    assert autotune.mode() == "search"


def test_run_options_resolution(monkeypatch):
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    opts = planner.resolve_run_options(RunOptions())
    assert opts.autotune == "replay"
    assert planner.resolve_run_options(opts) is opts
    assert planner.resolve_run_options(RunOptions(autotune="off")).autotune == "off"
    monkeypatch.setenv("REPRO_AUTOTUNE", "search")
    assert planner.resolve_run_options(RunOptions()).autotune == "search"
    from repro.kernels import planner as jax_planner

    for dtype in ("float32", "bfloat16"):
        assert planner.default_attention_blocks(head_dim=64, dtype=dtype) == \
            jax_planner.default_attention_blocks(head_dim=64, dtype=getattr(jnp, dtype))


# -- candidates, search and replay ---------------------------------------------

@pytest.mark.parametrize("case", ["matmul f32 classical", "matmul bf16 decode",
                                  "matmul f32 strassen", "scan f32", "transpose f32", "fft",
                                  "attention decode int8 long cache"])
def test_candidates_analytic_first_and_accepted(case, monkeypatch):
    monkeypatch.setenv("REPRO_FAST_BYTES", "65536")
    op, specs, kw = KEY_CASES[case]
    args = [_t(shape, dtype) for shape, dtype in specs]
    cands = autotune.candidates(op, *args, kwargs=kw)
    assert cands[0] == autotune.analytic_plan(op, *args, kwargs=kw)
    assert 1 < len(cands) <= 16 and len({json.dumps(c, sort_keys=True) for c in cands}) == \
        len(cands)
    info = autotune._TUNE[op]
    for c in cands:
        assert info.accepts(c, *args)
        assert autotune.snap_plan(op, args, c) == {k: v for k, v in c.items()
                                                   if k in info.knobs(*args)
                                                   or k in info.variant_keys}


def test_analytic_plans_are_the_kernels_own():
    a, b = _t((8, 256), "bfloat16"), _t((256, 384), "bfloat16")
    p = k2.plan(8, 384, 256, "stream", k2.NOMINAL_SMS)
    assert autotune.analytic_plan("matmul", a, b) == {
        "backend": "classical", "tile_n": p.tile_n, "splits": p.splits}
    q, k = _t((3, 1, 4, 16), "bfloat16"), _t((3, 64, 2, 16), "int8")
    assert autotune.analytic_plan("attention", q, k, k) == {
        "splits": fa.kv_splits(3, 1, 4, 2, 64, k2.NOMINAL_SMS, 64)}
    # K1 and K1q's FMA template read no splits: nothing to tune
    assert not autotune.tunable("attention", q, _t((3, 64, 2, 16), "bfloat16"),
                                _t((3, 64, 2, 16), "bfloat16"))
    assert not autotune.tunable("attention", q.float(), k, k)
    with autotune.mode_scope("search"):
        assert autotune.overlay("attention", (q.float(), k, k)) == {}


def test_search_persists_and_roundtrips(tune_dir):
    a, b = _t((8, 64)), _t((64, 96))
    entry = autotune.search("matmul", a, b, iters=2, max_candidates=4)
    assert entry["us"] <= entry["analytic_us"]
    assert entry["analytic_plan"] == autotune.analytic_plan("matmul", a, b)
    assert set(entry) == {"plan", "us", "analytic_plan", "analytic_us", "iters", "candidates"}
    path = autotune.table_path("cpu")
    autotune.clear_cache()
    assert autotune.lookup("matmul", a, b) == entry["plan"]
    raw = json.loads(path.read_text())
    assert raw["version"] == 3 and len(raw["entries"]) == 1
    assert {k: raw[k] for k in autotune.table_stamp()} == autotune.table_stamp()


@pytest.mark.parametrize("gain", ["noise", "real"])
def test_search_keeps_the_analytic_plan_within_its_spread(gain, tune_dir, monkeypatch):
    """A winner that beats the analytic plan by no more than the spread of
    the plan's samples (both timings) is noise: the entry records the plan."""
    x = _t((2, 256))
    cands = autotune.candidates("scan", x, max_candidates=3)
    analytic, other = cands[0], cands[1]
    fast = {"noise": [9.0, 9.5, 10.0], "real": [4.0, 4.0, 4.0]}[gain]
    times = {json.dumps(analytic): [10.0, 10.0, 11.0], json.dumps(other): fast}

    def fake(fn, args, *, iters, kwargs=None):
        plan = {k: v for k, v in (kwargs or {}).items() if k in analytic or k in other}
        return list(times.get(json.dumps(plan), [20.0, 20.0, 20.0]))

    monkeypatch.setattr(autotune, "_samples", fake)
    entry = autotune.search("scan", x, iters=3, max_candidates=3)
    assert entry["analytic_plan"] == analytic and entry["analytic_us"] == 10.0
    assert entry["plan"] == (analytic if gain == "noise" else other)
    assert entry["us"] == (10.0 if gain == "noise" else 4.0)
    assert autotune.measure_us(None, (x,), iters=3) == 20.0


def test_replay_cold_cache_is_the_planners_plan(tune_dir, monkeypatch):
    seen = []
    spec = registry.get("matmul")

    def spy(*args, **kw):
        seen.append(kw)
        return spec.kernel(*args, **kw)

    monkeypatch.setitem(registry._REGISTRY, "matmul", dataclasses.replace(spec, kernel=spy))
    a, b = _t((8, 64)), _t((64, 96))
    with autotune.mode_scope("replay"):
        assert autotune.overlay("matmul", (a, b)) == {}
        registry.dispatch("matmul", a, b)
    assert seen == [spec.plan(a, b)]
    assert not list(tune_dir.iterdir())  # replay never writes


def test_dispatch_replays_tuned_plan(tune_dir, monkeypatch):
    """A tuned plan reaches the wrapper (a spy on its kwargs), in JAX's
    order: planner, overlay, policy variants, explicit kwargs."""
    seen = []
    for op in ("matmul", "attention"):
        spec = registry.get(op)

        def spy(*args, _k=spec.kernel, **kw):
            seen.append(kw)
            return _k(*args, **kw)

        monkeypatch.setitem(registry._REGISTRY, op, dataclasses.replace(spec, kernel=spy))
    a, b = _t((8, 64)), _t((64, 96))
    q, k8 = _t((3, 1, 4, 16), "bfloat16"), _t((3, 64, 2, 16), "int8")
    sc = torch.ones(3, 2)
    table = autotune.load_table("cpu")
    table[autotune.entry_key("matmul", a, b)] = {
        "plan": {"backend": "classical", "tile_n": 128, "splits": 2}, "us": 1.0}
    table[autotune.entry_key("attention", q, k8, k8)] = {"plan": {"splits": 1}, "us": 1.0}
    autotune.save_table("cpu")
    autotune.clear_cache()
    with autotune.mode_scope("replay"):
        want = a @ b
        torch.testing.assert_close(registry.dispatch("matmul", a, b), want)
        assert seen[-1] == {"backend": "classical", "tile_n": 128, "splits": 2}
        registry.dispatch("matmul", a, b, splits=1)  # explicit kwargs win
        assert seen[-1]["splits"] == 1 and seen[-1]["tile_n"] == 128
        registry.dispatch("attention", q, k8, k8, k_scale=sc, v_scale=sc)
        assert seen[-1]["splits"] == 1
        # the f32 q runs K1q's FMA template, which reads no splits
        registry.dispatch("attention", q.float(), k8, k8, k_scale=sc, v_scale=sc)
        assert "splits" not in seen[-1]
        # repeated calls take the memoized overlay: no table I/O
        autotune.table_path("cpu").unlink()
        registry.dispatch("matmul", a, b)
        assert seen[-1]["splits"] == 2
    with autotune.mode_scope("off"):
        registry.dispatch("matmul", a, b)
        assert seen[-1] == {"backend": "classical"}


def test_forced_variant_keys_the_lookup(tune_dir, monkeypatch):
    monkeypatch.setenv("REPRO_FAST_BYTES", "65536")
    a, b = _t((256, 256)), _t((256, 256))
    assert registry.get("matmul").plan(a, b)["backend"] == "strassen"
    key = autotune.entry_key("matmul", a, b, kwargs={"backend": "classical"})
    autotune.load_table("cpu")[key] = {"plan": {"backend": "classical", "splits": 2}, "us": 1.0}
    seen = []
    spec = registry.get("matmul")
    monkeypatch.setitem(registry._REGISTRY, "matmul", dataclasses.replace(
        spec, kernel=lambda *args, **kw: seen.append(kw) or spec.kernel(*args, **kw)))
    with autotune.mode_scope("replay"), policy.apply(variants={"matmul": {"backend":
                                                                          "classical"}}):
        registry.dispatch("matmul", a, b)
    assert seen[-1]["backend"] == "classical" and seen[-1]["splits"] == 2
    with autotune.mode_scope("replay"):
        registry.dispatch("matmul", a, b)  # the planner's strassen key: a miss
    assert seen[-1] == spec.plan(a, b)


def test_search_mode_fills_table_from_dispatch(tune_dir, monkeypatch):
    x = _t((2, 128))
    with autotune.mode_scope("search"):
        registry.dispatch("scan", x)
    assert autotune.lookup("scan", x) is not None
    # under a stream capture the search must not run: it replays
    y = _t((2, 64))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with autotune.mode_scope("search"):
        registry.dispatch("scan", y)
        assert autotune.lookup("scan", y) is None
        with pytest.raises(RuntimeError, match="capture"):
            autotune.search("scan", y)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    with autotune.mode_scope("search"):
        registry.dispatch("scan", y)  # the capture's answer was not memoized
    assert autotune.lookup("scan", y) is not None


def test_search_never_writes_a_callers_out(tune_dir):
    x = _t((64, 32))
    out = torch.zeros(32, 64)
    bt = importlib.import_module("repro_torch.kernels.bi_transpose")
    autotune.search("transpose", x, iters=1, out=out)
    assert torch.count_nonzero(out) == 0
    torch.testing.assert_close(bt.bi_transpose(x, out=out), x.t())


# -- validators ------------------------------------------------------------------

K2_BAD = [
    ("wgmma tile_n not built", (32, 256), (256, 512), "bfloat16", {"tile_n": 96}),
    ("stream tile_n", (8, 256), (256, 512), "bfloat16", {"tile_n": 128}),
    ("stream past a cluster", (8, 1024), (1024, 512), "bfloat16", {"splits": 9}),
    ("splits past the K steps", (32, 128), (128, 512), "bfloat16", {"splits": 3}),
    ("fma tile_n", (64, 64), (64, 128), "float32", {"tile_n": 64}),
    ("zero splits", (64, 64), (64, 128), "float32", {"splits": 0}),
    ("bool splits", (64, 64), (64, 128), "float32", {"splits": True}),
    ("unknown key", (64, 64), (64, 128), "float32", {"bm": 64}),
    ("batched workspace split", (4, 32, 256), (4, 256, 128), "bfloat16", {"splits": 2}),
    ("batched fma split", (4, 32, 256), (4, 256, 128), "float32", {"splits": 2}),
]


@pytest.mark.parametrize("case", K2_BAD, ids=[c[0] for c in K2_BAD])
def test_k2_rejects_invalid_overrides(case):
    _, sa, sb, dtype, override = case
    a, b = _t(sa, dtype), _t(sb, dtype)
    with pytest.raises(ValueError):
        k2.hbp_matmul(a, b, plan=override)
    kw = {k: v for k, v in override.items() if k in ("tile_n", "splits")}
    if kw:
        with pytest.raises(ValueError):
            registry.dispatch("matmul", a, b, **kw)


def test_k2_takes_valid_overrides_and_strassen_none():
    a, b = _t((8, 1024), "bfloat16"), _t((1024, 512), "bfloat16")
    torch.testing.assert_close(k2.hbp_matmul(a, b, plan={"splits": 8, "tile_n": 64}),
                               k2.matmul_ref(a, b))
    a3, b3 = _t((4, 8, 256), "bfloat16"), _t((4, 256, 128), "bfloat16")
    k2.hbp_matmul(a3, b3, plan={"splits": 4})  # a batched stream call splits in a cluster
    p = k2.launch_plan(32, 512, 1024, "wgmma", 132, 1, {"tile_n": 192, "splits": 5})
    assert (p.tile_n, p.splits, p.kchunk) == (192, 4, 256)  # whole K steps a split
    sq = _t((256, 256))
    with pytest.raises(ValueError, match="strassen"):
        registry.dispatch("matmul", sq, sq, backend="strassen", splits=2)


K1Q_BAD = [
    ("size not a cluster", "bfloat16", "int8", 64, 3),
    ("past 8", "bfloat16", "int8", 1024, 16),
    ("past the K/V tiles", "bfloat16", "int8", 64, 2),
    ("K1 reads none", "bfloat16", "bfloat16", 256, 2),
    ("FMA template reads none", "float32", "int8", 256, 2),
    ("bool", "bfloat16", "int8", 256, True),
]


@pytest.mark.parametrize("case", K1Q_BAD, ids=[c[0] for c in K1Q_BAD])
def test_k1q_rejects_invalid_splits(case):
    _, qd, kd, sk, splits = case
    q, k = _t((2, 1, 4, 16), qd), _t((2, sk, 2, 16), kd)
    sc = {"k_scale": torch.ones(2, 2), "v_scale": torch.ones(2, 2)} if kd == "int8" else {}
    with pytest.raises(ValueError):
        fa.attention(q, k, k, splits=splits, **sc)
    with pytest.raises(ValueError):
        registry.dispatch("attention", q, k, k, splits=splits, **sc)


def test_k1q_takes_valid_splits_on_cpu():
    q, k = _t((2, 1, 4, 16), "bfloat16"), _t((2, 256, 2, 16), "int8")
    sc = torch.full((2, 2), 0.01)
    want = fa.attention(q, k, k, k_scale=sc, v_scale=sc)
    for s in (1, 2, 4):
        torch.testing.assert_close(fa.attention(q, k, k, k_scale=sc, v_scale=sc, splits=s),
                                   want)
    assert fa.kv_tile(256, "cpu") == 32 and fa.kv_tile(128, "cpu") == 64


# -- serving and the fleet ---------------------------------------------------------

def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def _workload(n, make, vocab, seed=1):
    rng = np.random.default_rng(seed)
    return [make(i, rng.integers(3, vocab, int(rng.integers(4, 20))).astype(np.int32),
                 max_new=int(rng.integers(2, 7)))
            for i in range(n)]


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX server's and engine's f32 tokens on the qwen3-1.7b smoke
    config (one 1x1 Auto-axis mesh, as the other port tests build it), and
    the parameters."""
    cfg = dataclasses.replace(jax_smoke("qwen3-1.7b"), dtype="float32")
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    try:
        js = JaxServer(cfg, mesh, max_len=MAX_LEN, opts=JaxRunOptions(remat="none"))
        sreqs = [JaxRequest(i, p, max_new=5) for i, p in enumerate(_prompts(cfg.vocab_size))]
        js.run_batch(sreqs)
        je = JaxEngine(cfg, mesh, max_batch=SLOTS, max_len=MAX_LEN, chunk=CHUNK,
                       degrade_after=NEVER, opts=JaxRunOptions(remat="none"))
        ereqs = _workload(5, JaxRequest, cfg.vocab_size)
        je.run(ereqs)
    finally:
        jax_autotune.set_mode(None)  # Server.__init__ pins the autotune mode process-wide
    params = params_from_numpy(jax.tree.map(np.asarray, js.params))
    return params, [r.out for r in sreqs], [r.out for r in ereqs]


def _hand_written_table(params, cfg):
    """Record every (op, tensors) an engine run and a server wave overlay,
    then write, for each, a tuned plan that is not the analytic one (the
    last candidate of its ladder)."""
    calls = {}
    real = registry.dispatch

    def record(op, *args, **kw):
        if autotune.tunable(op, *args):
            cands = autotune.candidates(op, *args, kwargs=kw)
            if len(cands) > 1:
                calls[autotune.entry_key(op, *args, kwargs=kw)] = cands[-1]
        return real(op, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(registry, "dispatch", record)
        _serve(params, cfg, RunOptions(remat="none", autotune="replay"))
    table = autotune.load_table("cpu")
    for key, plan in calls.items():
        table[key] = {"plan": plan, "us": 1.0}
    autotune.save_table("cpu")
    autotune.clear_cache()
    return calls


def _serve(params, cfg, opts):
    srv = Server(cfg, device="cpu", params=params, max_len=MAX_LEN, opts=opts)
    sreqs = [Request(i, p, max_new=5) for i, p in enumerate(_prompts(cfg.vocab_size))]
    srv.run_batch(sreqs)
    eng = Engine(cfg, device="cpu", params=params, max_batch=SLOTS, max_len=MAX_LEN,
                 chunk=CHUNK, degrade_after=NEVER, opts=opts)
    ereqs = _workload(5, Request, cfg.vocab_size)
    eng.run(ereqs)
    return [r.out for r in sreqs], [r.out for r in ereqs]


@pytest.mark.parametrize("mode", ["replay", "search"])
def test_server_and_engine_tokens_under_autotune(jax_runs, mode, tune_dir, monkeypatch):
    params, want_server, want_engine = jax_runs
    cfg = reduced(get_smoke_config("qwen3-1.7b"), dtype="float32")
    if mode == "replay":
        tuned = _hand_written_table(params, cfg)
        assert any("splits" in p for p in tuned.values())
    seen = []
    spec = registry.get("matmul")
    monkeypatch.setitem(registry._REGISTRY, "matmul", dataclasses.replace(
        spec, kernel=lambda *a, **kw: seen.append(kw) or spec.kernel(*a, **kw)))
    got_server, got_engine = _serve(params, cfg, RunOptions(remat="none", autotune=mode))
    assert autotune.mode() == mode  # the Server pinned it process-wide
    assert got_server == want_server and got_engine == want_engine
    table = autotune.load_table("cpu")
    assert table and all(k.split("|")[0] in ("matmul", "attention") for k in table)
    # the tuned plans reached the products
    assert any("splits" in kw for kw in seen)


def test_replica_row_and_entry_points_log_provenance(tune_dir, jax_runs, caplog):
    params, _, _ = jax_runs
    cfg = reduced(get_smoke_config("qwen3-1.7b"), dtype="float32")
    with caplog.at_level(logging.INFO):
        rep = spawn_replica(0, cfg, device="cpu", params=params, max_batch=2,
                            max_len=MAX_LEN, chunk=CHUNK)
        from repro_torch.launch.train import train
        from repro_torch.data import DataConfig

        train(cfg, steps=1, data_cfg=DataConfig(global_batch=2, seq_len=8), device="cpu",
              log_every=0, opts=RunOptions(autotune="off"))
    row = rep.provenance()["autotune"]
    assert set(row) == set(jax_autotune.provenance())
    assert row["device_kind"] == "cpu" and row["table"] == str(autotune.table_path("cpu"))
    text = caplog.text
    assert text.count("autotune table") >= 3  # the Server, the Engine, the trainer
    assert autotune.mode() == "off"  # train() pinned its resolved mode
