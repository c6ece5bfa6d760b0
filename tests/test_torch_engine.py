"""The port's continuous-batching Engine against the JAX Engine, on the CPU.

Both engines hold the same parameters (the JAX engine's own init, carried
across by ``params_from_numpy``) and serve the same seeded requests on the
``qwen3-1.7b`` smoke config at f32.  Greedy tokens must be identical
request for request, and so must the scheduler's counters: with the fp
cache (chunk 8, 6 requests over 3 slots), with the int8 cache (chunk 24 >=
the longest prompt, so the engine calibrates its scales on the same
whole-prompt first chunk the lockstep path uses), and under pressure
eviction.  The JAX engine runs on a 1x1 Auto-axis mesh (the installed JAX
makes ``make_debug_mesh``'s axes Explicit, which its sharding hints refuse),
and its int8 path runs the Pallas kernel in interpret mode.  Each JAX engine
is built once per module.

The pure-Python pieces copied from the JAX package (``SlotScheduler`` over
``match_round``, ``parse_impl_spec``, ``parse_fault_plan``) are held to the
originals on seeded and hand-written inputs, errors included.
"""
import dataclasses
import logging
import time

import jax
import numpy as np
import pytest
from jax.sharding import AxisType

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import policy as jax_policy  # noqa: E402
from repro.launch.engine import Engine as JaxEngine  # noqa: E402
from repro.launch.engine import SlotScheduler as JaxSlotScheduler  # noqa: E402
from repro.launch.serve import Request as JaxRequest  # noqa: E402
from repro.models.base import RunOptions  # noqa: E402
from repro.runtime import fault_tolerance as jax_ft  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config, reduced  # noqa: E402
from repro_torch.kernels import policy, registry  # noqa: E402
from repro_torch.launch.engine import Engine, SlotScheduler, check_lockstep_parity  # noqa: E402
from repro_torch.launch.serve import Request  # noqa: E402
from repro_torch.models import cache as dcache  # noqa: E402
from repro_torch.runtime import fault_tolerance as ft  # noqa: E402

MAX_LEN = 64
SLOTS = 3
BUDGET = 40
INT8 = dict(impl={"attention": "pallas"}, variants={"attention": {"kv_dtype": "int8"}})
TELEMETRY = ("matches", "rounds", "evictions", "pressure_evictions", "max_round_matches")
# The straggler watchdog z-scores each launch's host wall time, and enough
# flagged launches shrink the active-slot limit (failure model (c)), which
# changes admissions but never tokens.  Wall times differ between the two
# engines and from run to run, so the runs whose counters are compared never
# degrade; test_engine_degradation_shrinks_and_heals covers (c).
NEVER = 10 ** 9


@pytest.fixture(autouse=True)
def _reset_port_autotune():
    """The port's Server, Engine and trainer pin the autotune mode
    process-wide (``autotune.startup``), as JAX's do: clear it after each
    test."""
    yield
    from repro_torch.kernels import autotune as port_autotune

    port_autotune.set_mode(None)


def _workload(n, make, *, seed=0, max_prompt=20, max_new=8, vocab=256):
    """``tests/test_engine.py``'s mixed workload: ragged prompts, skewed
    generation budgets; ``make`` builds the port's or the JAX Request."""
    rng = np.random.default_rng(seed)
    return [make(i, rng.integers(3, vocab, int(rng.integers(4, max_prompt))).astype(np.int32),
                 max_new=int(rng.integers(2, max_new + 1)))
            for i in range(n)]


def _jax_engine(chunk):
    cfg = dataclasses.replace(jax_smoke("qwen3-1.7b"), dtype="float32")
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    return JaxEngine(cfg, mesh, max_batch=SLOTS, max_len=MAX_LEN, chunk=chunk,
                     degrade_after=NEVER, opts=RunOptions(remat="none"))


def _jax_serve(engine, n, **attrs):
    for key, val in attrs.items():
        setattr(engine, key, val)
    reqs = _workload(n, JaxRequest)
    out = engine.run(reqs)
    return [r.out for r in reqs], {k: out["telemetry"][k] for k in TELEMETRY}


@pytest.fixture(scope="module")
def jax_runs():
    """Every JAX engine run of this module: the fp engine clean and under
    pressure eviction (both policies), the int8 engine clean."""
    from repro.kernels import autotune

    try:
        fp = _jax_engine(chunk=8)
        runs = {"fp": _jax_serve(fp, 6)}
        for evict in ("largest", "coldest"):
            runs[evict] = _jax_serve(fp, 6, cache_budget=BUDGET, evict_policy=evict)
        with jax_policy.apply(**INT8):
            q8 = _jax_engine(chunk=24)
            runs["int8"] = _jax_serve(q8, 4)
    finally:
        autotune.set_mode(None)  # Server.__init__ pins the autotune mode process-wide
    params = params_from_numpy(jax.tree.map(np.asarray, fp.params))
    q8_params = params_from_numpy(jax.tree.map(np.asarray, q8.params))
    assert all(torch.equal(params[k], q8_params[k]) for k in params)
    return params, runs


def _engine(params, chunk, **kw):
    cfg = reduced(get_smoke_config("qwen3-1.7b"), dtype="float32")
    kw.setdefault("degrade_after", NEVER)
    return Engine(cfg, device="cpu", params=params, max_batch=SLOTS, max_len=MAX_LEN,
                  chunk=chunk, **kw)


def _serve(engine, n):
    reqs = _workload(n, Request)
    out = engine.run(reqs)
    return reqs, out


# -- the engine against JAX's --------------------------------------------------

@pytest.mark.parametrize("cache", ["fp", "int8"])
def test_engine_tokens_identical_to_jax(jax_runs, cache):
    """Request for request the same greedy tokens as the JAX engine, the
    same admissions, rounds and evictions; and each request's tokens equal
    its run-alone lockstep tokens (the port's own parity check)."""
    params, runs = jax_runs
    want, want_tel = runs[cache]
    scope = policy.apply(**INT8) if cache == "int8" else policy.apply()
    with scope:
        engine = _engine(params, chunk=24 if cache == "int8" else 8)
        reqs, out = _serve(engine, len(want))
        assert engine.cache.quantized == (cache == "int8")
        assert check_lockstep_parity(engine, reqs)
    assert [r.out for r in reqs] == want
    assert {k: out["telemetry"][k] for k in TELEMETRY} == want_tel
    assert out["completed"] == {r.uid: len(r.out) for r in reqs}
    assert out["prefill_chunk_rows"] > out["prefill_chunks"]  # batched chunks
    assert out["telemetry"]["max_round_matches"] <= SLOTS - 1


@pytest.mark.parametrize("evict", ["largest", "coldest"])
def test_engine_pressure_eviction_identical_to_jax(jax_runs, evict):
    """A context budget below the working set evicts; the evicted requests
    re-queue, replay, and finish with JAX's tokens and counters."""
    params, runs = jax_runs
    want, want_tel = runs[evict]
    engine = _engine(params, chunk=8, cache_budget=BUDGET, evict_policy=evict)
    reqs, out = _serve(engine, len(want))
    assert out["telemetry"]["pressure_evictions"] >= 1
    assert [r.out for r in reqs] == want
    assert {k: out["telemetry"][k] for k in TELEMETRY} == want_tel


@pytest.mark.parametrize("plan,snapshot_every", [
    ("decode@3=raise,slot@1=nan_logits", 16),
    ("decode@1=raise,slot@0=nan_logits:3", 1),  # the poisoned row resumes from a snapshot
])
def test_engine_injected_faults_token_identical(jax_runs, plan, snapshot_every):
    """A raised launch retries and a poisoned row is evicted and replayed;
    the tokens equal the clean run's (JAX's clean tokens)."""
    params, runs = jax_runs
    want, _ = runs["fp"]
    engine = _engine(params, chunk=8, injector=ft.FaultInjector(plan),
                     snapshot_every=snapshot_every)
    reqs, out = _serve(engine, len(want))
    assert [r.out for r in reqs] == want
    faults = out["stats"]["faults"]
    assert faults["retries"] == 1 and faults["slots_poisoned"] == 1
    assert faults["faults_injected"] == 2
    assert (faults["snapshot_restores"] >= 1) == (snapshot_every == 1)


def test_engine_degradation_shrinks_and_heals(jax_runs, monkeypatch):
    """Failure model (c): two failed launches inside the window shrink the
    active-slot limit; healthy iterations probe it back up; tokens stay the
    lockstep tokens.  The watchdog is kept from flagging wall-time outliers
    here, so the fault events are exactly the injected ones."""
    params, _ = jax_runs
    engine = _engine(params, chunk=8, injector=ft.FaultInjector("decode@2=raise,decode@3=raise"),
                     degrade_after=2, degrade_window=8, heal_after=4)
    monkeypatch.setattr(ft, "WATCHDOG_MIN_SAMPLES", NEVER)
    rng = np.random.default_rng(1)
    reqs = [Request(i, rng.integers(3, 256, 8).astype(np.int32), max_new=14)
            for i in range(3)]
    out = engine.run(reqs)
    assert out["telemetry"]["degradations"] >= 1 and out["telemetry"]["degraded_iters"] >= 1
    deg = engine.stats()["degradation"]
    assert deg["active_limit"] == deg["max_batch"] and not deg["degraded"]
    assert check_lockstep_parity(engine, reqs)


class _Clock:
    """A host clock that only the code under test moves: each reading
    advances it 1 ms and ``sleep`` advances it by the time asked, so every
    launch takes the same time but an injected delay."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        self.now += 1e-3
        return self.now

    def sleep(self, seconds):
        self.now += seconds


def test_engine_flags_injected_stragglers_per_series(jax_runs, caplog, monkeypatch):
    """Failure model (c)'s watchdog keeps one series per kind of launch: a
    delay injected late into the decode steps and one into the continuation
    chunks are each flagged against their own series, and nothing else is;
    they count as fault events and leave the tokens the clean run's.  The
    launch ordinals come from a clean run of the same engine and requests;
    the host clock is a fake one, so CPU load cannot blur the times."""
    params, _ = jax_runs
    clean = _engine(params, chunk=3)
    seen, launch = [], clean._launch

    def record(kind, fn, *args, series=None):
        seen.append((kind, clean._launch_seq[kind], series or kind))
        return launch(kind, fn, *args, series=series)

    clean._launch = record
    reqs, _ = _serve(clean, 6)
    want = [r.out for r in reqs]
    decode = [o for k, o, _ in seen if k == "decode"]
    cont = [o for _, o, series in seen if series == "prefill_cont"]
    assert len(decode) > 8 and len(cont) > 8  # past min_samples in each series
    plan = f"decode@{decode[-2]}=delay:0.25,prefill@{cont[-1]}=delay:0.25"
    engine = _engine(params, chunk=3, injector=ft.FaultInjector(plan))
    clock = _Clock()
    monkeypatch.setattr(time, "perf_counter", clock.perf_counter)
    monkeypatch.setattr(time, "sleep", clock.sleep)
    with caplog.at_level(logging.WARNING, logger="repro_torch.engine"):
        reqs, out = _serve(engine, 6)
    monkeypatch.undo()
    assert [r.out for r in reqs] == want
    flagged = {r.getMessage() for r in caplog.records if r.getMessage().startswith("straggler")}
    assert flagged == {f"straggler decode launch {decode[-2]}",
                       f"straggler prefill launch {cont[-1]}"}
    assert out["telemetry"]["stragglers"] == 2 and out["telemetry"]["faults_injected"] == 2
    assert set(out["stats"]["watchdog"]) == {"decode", "prefill_first", "prefill_cont"}


def test_launch_watchdog_series_and_floor():
    """Each series is judged on its own samples, a time at or below
    ``WATCHDOG_FLOOR`` (4x) the series' median joins its window unflagged
    however many deviations it passes, a longer one is z-scored, and a reset
    forgets the last run; the monitor under it keeps the JAX rule."""
    assert ft.WATCHDOG_FLOOR == 4.0 and ft.WATCHDOG_MIN_SAMPLES == 5
    wd = ft.LaunchWatchdog()
    for i in range(10):
        assert not wd.observe("decode", 0.010 + 1e-5 * i)
    assert not wd.observe("prefill_first", 0.200)  # a new series: nothing to judge by
    assert not wd.observe("decode", 0.035)  # ~2000 sigma, but 3.5x the median
    assert wd.series["decode"].times[-1] == 0.035  # kept in the window
    assert wd.observe("decode", 0.045)  # 4.5x the median
    desc = wd.describe()
    assert desc["decode"]["flagged"] == 1 and desc["decode"]["kept"] == 11
    assert desc["prefill_first"]["kept"] == 1
    assert 4.4 < desc["decode"]["peak_over_median"] < 4.5
    wd.reset()
    assert wd.describe() == {} and not wd.observe("decode", 1.0)
    plain = ft.StragglerMonitor(min_samples=5)
    for i in range(10):
        plain.observe(0.010 + 1e-5 * i)
    assert plain.observe(0.025)


def test_engine_launch_exhaustion_raises(jax_runs):
    params, _ = jax_runs
    engine = _engine(params, chunk=8, injector=ft.FaultInjector("decode@0=raise:99"))
    with pytest.raises(ft.LaunchFailedError) as ei:
        _serve(engine, 2)
    assert ei.value.kind == "decode" and ei.value.attempts == 3


def test_engine_rejects_unknown_evict_policy(jax_runs):
    params, _ = jax_runs
    with pytest.raises(ValueError):
        _engine(params, chunk=8, evict_policy="newest")


# -- the cache helpers the engine talks through --------------------------------

@pytest.mark.parametrize("quantized", [False, True])
def test_snapshot_outlives_later_writes(quantized):
    """The port writes the cache in place, so a snapshot must be a copy: on
    the CPU ``t.to("cpu")`` is the same storage and would follow every
    later write.  Here the row is overwritten after the snapshot, and the
    snapshot still restores the old contents, into another slot too."""
    dtype = torch.int8 if quantized else torch.float32
    cache = dcache.LinearKV.create((2,), 3, 8, 2, 4, dtype, device="cpu",
                                   quantized=quantized)
    gen = torch.Generator().manual_seed(0)

    def fill(t):
        t.copy_(torch.randint(-100, 100, t.shape, generator=gen).to(t.dtype))

    for t in (cache.k, cache.v) + ((cache.k_scale, cache.v_scale) if quantized else ()):
        fill(t)
    cache = cache.replace(pos=torch.tensor([5, 3, 7], dtype=torch.int32))
    before = dcache.slot(cache, 1)
    before = {n: None if t is None else t.clone() for n, t in
              (("k", before.k), ("v", before.v), ("k_scale", before.k_scale))}
    snap = dcache.snapshot_row(cache, 1)

    # later writes to row 1, in place: a chunk at position 0, a new scale
    dcache.linear_write(cache.k[0], torch.ones(3, 4, 2, 4).to(dtype), 0)
    cache.v[1, 1].fill_(9)
    if quantized:
        cache.k_scale[:, 1].fill_(7.0)
    cache = dcache.reset_row(cache, 1)
    assert not torch.equal(dcache.slot(cache, 1).k, before["k"])
    assert torch.equal(snap.k, before["k"]) and torch.equal(snap.v, before["v"])
    assert int(snap.pos) == 3
    if quantized:
        assert torch.equal(snap.k_scale, before["k_scale"])

    dcache.snapshot_compatible(cache, snap)
    restored = dcache.restore_row(cache, 2, snap)  # into another slot
    row = dcache.slot(restored, 2)
    assert torch.equal(row.k, before["k"]) and torch.equal(row.v, before["v"])
    assert restored.pos.tolist() == [5, 0, 3]
    assert restored.k.data_ptr() == cache.k.data_ptr()  # written in place


def test_slot_views_and_snapshot_compatibility():
    cache = dcache.LinearKV.create((2,), 3, 8, 2, 4, torch.float32, device="cpu")
    view = dcache.slot(cache, 2)
    view.k.fill_(3.0)  # slot() returns views: the write reaches the cache
    assert torch.all(cache.k[:, 2] == 3.0) and torch.all(cache.k[:, :2] == 0.0)
    assert dcache.lengths(cache) is cache.pos
    assert dcache.set_row_valid(cache, 0, True) is cache
    q8 = dcache.LinearKV.create((2,), 3, 8, 2, 4, torch.int8, device="cpu", quantized=True)
    for other, snap in ((q8, dcache.snapshot_row(cache, 0)),
                        (cache, dcache.snapshot_row(q8, 0)),
                        (dcache.LinearKV.create((2,), 3, 16, 2, 4, torch.float32,
                                                device="cpu"),
                         dcache.snapshot_row(cache, 0))):
        with pytest.raises(ValueError):
            dcache.snapshot_compatible(other, snap)
    mask = torch.tensor([True, False, True])
    got = dcache.masked_rows(mask, torch.ones(3, 2), torch.zeros(3, 2))
    assert got.tolist() == [[1, 1], [0, 0], [1, 1]]


# -- the copied pure-Python modules against the originals ----------------------

def test_slot_scheduler_matches_jax_on_random_queues():
    rng = np.random.default_rng(7)
    for _ in range(200):
        n_slots = int(rng.integers(1, 9))
        queue = []
        for uid in range(int(rng.integers(0, 12))):
            prompt = np.zeros(int(rng.integers(1, 40)), np.int32)
            out = [0] * int(rng.integers(0, 5))
            queue.append((uid, prompt, int(rng.integers(len(out) + 1, 20)), out))
        idle = sorted(rng.choice(n_slots, int(rng.integers(0, n_slots + 1)),
                                 replace=False).tolist())
        port, ref = SlotScheduler(n_slots), JaxSlotScheduler(n_slots)
        pq = [Request(u, p, max_new=m, out=list(o)) for u, p, m, o in queue]
        jq = [JaxRequest(u, p, max_new=m, out=list(o)) for u, p, m, o in queue]
        got = port.assign(idle, pq, Engine._work_remaining)
        want = ref.assign(idle, jq, JaxEngine._work_remaining)
        assert got == want
        assert port.counters == ref.counters


IMPL_SPECS = [
    "", "pallas", "*=jnp", "attention=pallas", "attention=pallas:kv_dtype=int8",
    "matmul=pallas:backend=classical,attention=auto",
    "matmul=ref:qkv_fused=true:cutoff=64", " attention = pallas : kv_dtype = i8 ,",
    # errors
    "=pallas", "atention=pallas", "attention=cuda", "*=pallas:kv_dtype=int8",
    "attention=pallas:kv_dtype", "attention=pallas:=int8", "attention=pallas:kv_dtype=",
    "torch",
]


@pytest.mark.parametrize("spec", IMPL_SPECS)
def test_parse_impl_spec_matches_jax(spec):
    def outcome(parse):
        try:
            return parse(spec)
        except Exception as e:  # noqa: BLE001 — the class and message are compared
            return type(e).__name__, str(e)

    got, want = outcome(policy.parse_impl_spec), outcome(jax_policy.parse_impl_spec)
    assert got == want
    if isinstance(want, tuple) and isinstance(want[0], dict):
        impl, variants = want
        port = policy.ExecutionPolicy().with_(impl=impl, variants=variants)
        ref = jax_policy.ExecutionPolicy().with_(impl=impl, variants=variants)
        assert port.describe() == ref.describe()
        assert port.variant_for("attention") == ref.variant_for("attention")
        assert policy.parse_impl_spec(port.describe()) == jax_policy.parse_impl_spec(
            ref.describe())


FAULT_PLANS = [
    "", "decode@12=raise,prefill@3=delay:0.2,slot@2=nan_logits:4",
    "decode@0=raise:3", " slot@1=nan_logits , decode@3=raise ",
    # errors
    "decode@12", "decode=raise", "decode@1=explode", "decode@1=nan_logits",
    "slot@1=raise", "slot@1=delay", "decode@x=raise", "gpu@1=raise",
    "decode@1=raise:abc",
]


@pytest.mark.parametrize("plan", FAULT_PLANS)
def test_parse_fault_plan_matches_jax(plan):
    def outcome(parse):
        try:
            return [dataclasses.astuple(s) for s in parse(plan)]
        except Exception as e:  # noqa: BLE001 — the class and message are compared
            return type(e).__name__, str(e)

    assert outcome(ft.parse_fault_plan) == outcome(jax_ft.parse_fault_plan)


def test_fault_injector_and_monitor_match_jax():
    plan = "decode@2=raise:2,slot@1=nan_logits:3,slot@0=nan_logits"
    port, ref = ft.FaultInjector(plan), jax_ft.FaultInjector(plan)
    for ordinal in range(4):
        for inj in (port, ref):
            for _ in range(3):
                try:
                    inj.before_launch("decode", ordinal)
                    break
                except (ft.InjectedFault, jax_ft.InjectedFault):
                    pass
        assert port.poison_rows([0, 1]) == ref.poison_rows([0, 1])
    assert port.counters == ref.counters
    pol, jpol = ft.FaultPolicy(), jax_ft.FaultPolicy()
    r1, r2 = pol.make_rng(), jpol.make_rng()
    assert [pol.backoff(a, r1) for a in range(3)] == [jpol.backoff(a, r2) for a in range(3)]
    mon, jmon = ft.StragglerMonitor(min_samples=3), jax_ft.StragglerMonitor(min_samples=3)
    times = [0.01, 0.011, 0.009, 0.5, 0.01, 0.012, 0.3]
    assert [mon.observe(t) for t in times] == [jmon.observe(t) for t in times]
    counters = {"retries": 2, "matches": 5}
    assert ft.export_fault_counters(counters) == jax_ft.export_fault_counters(counters)


def test_policy_stack_and_kernel_requirement(monkeypatch):
    """``REPRO_IMPL`` builds the ambient, ``install`` pins over it, ``apply``
    scopes over both; a plain backend on a CUDA device raises (the port
    runs only its kernels there), on the CPU it is what runs anyway.  The
    rule is the registry's resolution (``registry.resolve``)."""
    monkeypatch.setenv("REPRO_IMPL", "attention=pallas:kv_dtype=int8")
    assert policy.current().variant_for("attention") == {"kv_dtype": "int8"}
    policy.install(policy.ExecutionPolicy(impl={"matmul": "ref"}))
    try:
        assert policy.current().impl_for("matmul") == "ref"
        assert policy.current().impl_for("attention") == "auto"
        with policy.apply(impl={"*": "jnp"}) as scoped:
            assert scoped.impl_for("attention") == "jnp"
            assert registry.resolve("attention", device=torch.device("cpu")) == "jnp"
            with pytest.raises(NotImplementedError, match="plain version on a CUDA tensor"):
                registry.resolve("attention", device=torch.device("cuda"))
        assert registry.resolve("attention", device=torch.device("cuda")) == "pallas"
        with pytest.raises(NotImplementedError):
            registry.resolve("matmul", device=torch.device("cuda"))
    finally:
        policy.install(None)
    with pytest.raises(ValueError):
        policy.ExecutionPolicy(impl={"attention": "torch"})
    with pytest.raises(ValueError):
        policy.ExecutionPolicy(variants={"atention": {"kv_dtype": "int8"}})
