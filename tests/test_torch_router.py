"""The port's fleet Router against the JAX Router, on the CPU.

Both fleets serve the same seeded requests on the ``qwen3-1.7b`` smoke
config at f32 (2 replicas of 2 slots, chunk 8, ``snapshot_every=2``), the
port's replica 0 holding the JAX replica 0's params (``params_from_numpy``).
In five cases (``pws``; ``rws`` seed 5; ``pws`` under
``|decode@3=raise:99``, which kills replica 1 and restarts a replacement
from the fleet checkpoint; rebalancing that migrates a decoding slot; a
replica joined and another removed mid-run) the greedy tokens, the
placement log and every router counter must equal JAX's.

The JAX engines run on a 1x1 Auto-axis mesh: the installed JAX makes
``make_debug_mesh``'s axes Explicit, which its sharding hints refuse, and
the JAX router builds every respawn's and joiner's mesh through
``respawn_mesh``, which calls ``make_debug_mesh``.  The fixture patches
``repro.launch.router.respawn_mesh`` to return the same Auto-axis mesh; no
file of the JAX package changes.  One JAX router serves the four cases
without a fault in turn (each run begins afresh: per-run counters, queues,
caches and a re-seeded placement rng), so its engines are compiled once;
the port builds a fresh router per case.  Both engines' degradation
windows are off (``degrade_after`` never reached): the watchdogs time
launches on the host, and a shrunk slot limit would move placements.
"""
import dataclasses
import logging
import os
import random
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import AxisType

torch = pytest.importorskip("torch")

import repro.launch.router as jax_router_mod  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import rws as jax_rws  # noqa: E402
from repro.launch.serve import Request as JaxRequest  # noqa: E402
from repro.models.base import RunOptions as JaxRunOptions  # noqa: E402
from repro.runtime import fault_tolerance as jax_ft  # noqa: E402
from repro.runtime import replica as jax_replica  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config, reduced  # noqa: E402
from repro_torch.core import rws  # noqa: E402
from repro_torch.launch.engine import Engine  # noqa: E402
from repro_torch.launch.router import Router  # noqa: E402
from repro_torch.launch.serve import Request  # noqa: E402
from repro_torch.runtime import FaultInjector, elastic, replica  # noqa: E402
from repro_torch.runtime import fault_tolerance as ft  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
NEVER = 10 ** 9
ENGINE_KW = dict(max_batch=2, max_len=64, chunk=8, snapshot_every=2, degrade_after=NEVER)
DEATH = "|decode@3=raise:99"
# the rebalancing case (tests/test_router.py's): one long request beside
# three short ones leaves the fleet skewed once the shorts drain
REBALANCE_SPEC = [(np.arange(3, 15, dtype=np.int32), 20),
                  (np.arange(3, 11, dtype=np.int32), 2),
                  (np.arange(4, 12, dtype=np.int32), 2),
                  (np.arange(5, 13, dtype=np.int32), 2)]
CASES = {  # case -> (router kwargs, workload spec args)
    "pws": (dict(route="pws"), dict(n=6)),
    "rws": (dict(route="rws", seed=5), dict(n=6)),
    "death": (dict(route="pws", fleet_faults=DEATH), dict(n=6, max_new=8)),
    "rebalance": (dict(route="pws", rebalance_threshold=4, queue_depth=0), None),
    "join_leave": (dict(route="pws"), dict(n=10, seed=2, max_new=8)),
}


@pytest.fixture(autouse=True)
def _reset_port_autotune():
    """The port's Server, Engine and trainer pin the autotune mode
    process-wide (``autotune.startup``), as JAX's do: clear it after each
    test."""
    yield
    from repro_torch.kernels import autotune as port_autotune

    port_autotune.set_mode(None)


def _spec(vocab, n=6, *, seed=0, max_new=6):
    """tests/test_router.py's skewed workload: ragged prompts, mixed budgets."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(3, vocab, int(rng.integers(4, 20))).astype(np.int32),
             int(rng.integers(2, max_new + 1)))
            for _ in range(n)]


def _case_spec(case, vocab):
    args = CASES[case][1]
    return REBALANCE_SPEC if args is None else _spec(vocab, **args)


def _serve(router, spec, make, case):
    """Run ``case``'s workload through ``router``; the join/leave case steps
    2 rounds, joins a replica, steps 2 more, removes replica 1 and drains."""
    reqs = [make(i, p, max_new=mn) for i, (p, mn) in enumerate(spec)]
    if case != "join_leave":
        out = router.run(reqs)
    else:
        router.begin(reqs)
        for _ in range(2):
            router.step_round()
        router.add_replica()
        for _ in range(2):
            router.step_round()
        router.remove_replica(1)
        while not router.done():
            router.step_round()
        out = router.finish(reqs)
    return [r.out for r in reqs], out


def _jax_cfg():
    return dataclasses.replace(jax_smoke("qwen3-1.7b"), dtype="float32")


def _port_cfg():
    return reduced(get_smoke_config("qwen3-1.7b"), dtype="float32")


@pytest.fixture(scope="module")
def jax_fleet(tmp_path_factory):
    """Every JAX router run of this module, and replica 0's params and the
    directory of the fleet checkpoint JAX's ``save_checkpoint`` wrote."""
    from repro.kernels import autotune

    cfg = _jax_cfg()
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    kw = dict(ENGINE_KW, opts=JaxRunOptions(remat="none"))
    runs = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_router_mod, "respawn_mesh", lambda prev, lost_devices=0: mesh)
            shared = jax_router_mod.Router(cfg, mesh, n_replicas=2,
                                           ckpt_dir=str(tmp_path_factory.mktemp("jax_fleet")),
                                           **kw)
            for case in ("pws", "rws", "rebalance", "join_leave"):
                rkw = CASES[case][0]
                shared.route = rkw["route"]
                shared.seed = rkw.get("seed", 0)
                shared.rebalance_threshold = rkw.get("rebalance_threshold")
                shared.queue_depth = rkw.get("queue_depth", 1)
                runs[case] = _serve(shared, _case_spec(case, cfg.vocab_size), JaxRequest, case)
            dying = jax_router_mod.Router(cfg, mesh, n_replicas=2, fleet_faults=DEATH,
                                          ckpt_dir=str(tmp_path_factory.mktemp("jax_death")),
                                          **kw)
            runs["death"] = _serve(dying, _case_spec("death", cfg.vocab_size), JaxRequest,
                                   "death")
    finally:
        autotune.set_mode(None)  # Server.__init__ pins the autotune mode process-wide
    params = params_from_numpy(jax.tree.map(np.asarray, shared.replicas[0].engine.params))
    return params, runs, shared.ckpt_dir


@pytest.fixture(scope="module")
def port_fleet(jax_fleet, tmp_path_factory):
    """The port's router over the same cases, a fresh fleet each, replica 0
    holding JAX's replica 0's params."""
    params, _, _ = jax_fleet
    cfg = _port_cfg()
    runs = {}
    for case, (rkw, _) in CASES.items():
        router = Router(cfg, device="cpu", n_replicas=2, params=params,
                        ckpt_dir=tmp_path_factory.mktemp(f"port_{case}"), **rkw, **ENGINE_KW)
        runs[case] = (router, *_serve(router, _case_spec(case, cfg.vocab_size), Request, case))
    return runs


# -- the five cases against JAX -------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_router_matches_jax(jax_fleet, port_fleet, case):
    """Tokens request for request, the placement log and every router counter
    equal the JAX router's."""
    _, jax_runs, _ = jax_fleet
    j_tokens, j_out = jax_runs[case]
    _, p_tokens, p_out = port_fleet[case]
    assert p_tokens == j_tokens
    assert p_out["placements"] == [tuple(p) for p in j_out["placements"]]
    assert p_out["counters"] == j_out["counters"]
    assert p_out["tokens"] == j_out["tokens"]
    assert [(r["rid"], r["state"], r["spawned_from"]) for r in p_out["replicas"]] == \
        [(r["rid"], r["state"], r["spawned_from"]) for r in j_out["replicas"]]


@pytest.mark.parametrize("case", list(CASES))
def test_router_case_exercises_its_path(port_fleet, case):
    """Each case moves the counters it is about, and every request is served
    in full (no EOS)."""
    router, tokens, out = port_fleet[case]
    c = out["counters"]
    assert all(len(t) == mn for t, (_, mn) in zip(tokens, _case_spec(case, router.cfg.vocab_size)))
    assert c["route_rounds"] > 0
    if case in ("pws", "rws"):
        assert c["routed"][0] > 0 and c["routed"][1] > 0
    if case == "death":
        assert (c["replica_deaths"], c["replica_restarts"]) == (1, 1)
        assert c["requeued_on_death"] >= 1 and c["migrations"] >= 1
        assert router.replicas[1].state == "dead"
        assert router.replicas[2].spawned_from == "checkpoint"
    if case == "rebalance":
        assert c["rebalances"] >= 1 and c["slot_migrations"] >= 1 and c["migrations"] >= 1
        assert sum(row["faults"]["snapshot_restores"] for row in out["replicas"]) >= 1
    if case == "join_leave":
        assert c["joins"] == 1 and c["leaves"] == 1 and c["routed"].get(2, 0) >= 1
        assert {r.rid: r.state for r in router.replicas} == {0: "live", 1: "left", 2: "live"}


def test_router_single_replica_parity(jax_fleet, port_fleet):
    """The oracle of the JAX tests: a clean one-replica engine with replica
    0's params serves the death case's workload with the router's tokens."""
    params, _, _ = jax_fleet
    router, tokens, _ = port_fleet["death"]
    single = Engine(_port_cfg(), device="cpu", params=params,
                    injector=FaultInjector(""), **ENGINE_KW)
    alone = [Request(i, p, max_new=mn)
             for i, (p, mn) in enumerate(_case_spec("death", router.cfg.vocab_size))]
    single.run(alone)
    assert [r.out for r in alone] == tokens


def test_engine_restart_from_jax_checkpoint(jax_fleet):
    """``Engine.restart`` from the checkpoint JAX's ``save_checkpoint`` wrote
    for the JAX fleet serves the JAX fleet's tokens, and restores replica
    0's params bit for bit."""
    params, jax_runs, ckpt_dir = jax_fleet
    eng = Engine.restart(_port_cfg(), ckpt_dir, device="cpu", **ENGINE_KW)
    state = eng.model.state_dict()
    assert all(torch.equal(state[k], params[k]) for k in params)
    spec = _case_spec("pws", _port_cfg().vocab_size)
    reqs = [Request(i, p, max_new=mn) for i, (p, mn) in enumerate(spec)]
    eng.run(reqs)
    assert [r.out for r in reqs] == jax_runs["pws"][0]


def test_serving_and_elastic_restore_onto_a_device(tmp_path):
    """``serving_restore`` reads a fleet checkpoint into fresh tensors (the
    like untouched), ``elastic_restore`` a trainer's state."""
    from repro_torch.checkpoint import CheckpointManager, save_checkpoint

    src = {"layers.0.wq": torch.randn(4, 6), "embed": torch.randn(8, 4)}
    save_checkpoint(tmp_path, 3, {"params": src})
    like = {k: torch.zeros_like(v) for k, v in src.items()}
    step, got = elastic.serving_restore(CheckpointManager(tmp_path), like, "cpu")
    assert step == 3 and all(torch.equal(got[k], src[k]) for k in src)
    assert all(not like[k].any() for k in like)
    state = {"params": src, "opt_state": {"step": torch.tensor(7), "m": {"embed": src["embed"]}}}
    save_checkpoint(tmp_path / "train", 5, state)
    step, got = elastic.elastic_restore(CheckpointManager(tmp_path / "train"),
                                        {"params": like, "opt_state": {
                                            "step": torch.tensor(0), "m": {"embed": like["embed"]}}})
    assert step == 5 and int(got["opt_state"]["step"]) == 7
    assert torch.equal(got["opt_state"]["m"]["embed"], src["embed"])
    assert elastic.respawn_device("cpu") == torch.device("cpu")


# -- the pure-Python pieces against JAX's --------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 5, 11, 23])
def test_two_choice_matches_jax(seed):
    ids = [0, 1, 2, 3, 4]
    load = {0: 5, 1: 2, 2: 2, 3: 9, 4: 0}
    a, b = random.Random(seed), random.Random(seed)
    assert [rws.two_choice(a, ids, load) for _ in range(64)] == \
        [jax_rws.two_choice(b, ids, load) for _ in range(64)]
    assert rws.two_choice(random.Random(seed), [7], {7: 3}) == 7


@pytest.mark.parametrize("plan,n", [
    ("", 2), ("|decode@4=raise:99", 2), ("decode@2=raise", 3), ("|", 2),
    ("prefill@1=delay:0.1||slot@0=nan_logits", 3), ("|||", 2), ("|decode@x=raise", 2),
    ("decode@1=explode", 2), ("|slot@1=raise", 2),
])
def test_parse_fleet_plan_matches_jax(plan, n):
    try:
        want = jax_ft.parse_fleet_plan(plan, n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ft.parse_fleet_plan(plan, n)
        assert str(got.value) == str(e)
        return
    assert ft.parse_fleet_plan(plan, n) == want


@pytest.mark.parametrize("faults", [
    {}, {"retries": 2}, {"stragglers": 3}, {"degradations": 1, "retries": 1},
    {"degraded_iters": 40}, {"retries": 9, "degradations": 9}, {"stragglers": 1, "faults_injected": 4},
])
def test_health_score_matches_jax(faults):
    stats = {"faults": faults}
    assert replica.health_score(stats) == jax_replica.health_score(stats)
    assert replica.health_score({}) == jax_replica.health_score({}) == 1.0
    assert (replica.HEALTH_WEIGHTS, replica.SHED_THRESHOLD) == \
        (jax_replica.HEALTH_WEIGHTS, jax_replica.SHED_THRESHOLD)


# -- the port's router alone -----------------------------------------------------

def test_router_remove_guards(tmp_path):
    router = Router(_port_cfg(), device="cpu", n_replicas=2, ckpt_dir=tmp_path, **ENGINE_KW)
    router.remove_replica(1)
    with pytest.raises(ValueError, match="not live"):
        router.remove_replica(1)
    with pytest.raises(ValueError, match="last live"):
        router.remove_replica(0)
    with pytest.raises(ValueError, match="routing arm"):
        Router(_port_cfg(), device="cpu", route="random", ckpt_dir=tmp_path, **ENGINE_KW)


def test_router_health_shedding_routes_around_faulty_replica(tmp_path):
    """Replica 1's failing launches fold into a health score under the shed
    threshold (two retries and a degradation); the router stops placing new
    work there while the healthy replica finishes the queue, with the
    single engine's tokens."""
    cfg = _port_cfg()
    spec = _spec(cfg.vocab_size, n=10, seed=3, max_new=6)
    kw = dict(ENGINE_KW, degrade_after=2, degrade_window=16, heal_after=64)
    router = Router(cfg, device="cpu", n_replicas=2, ckpt_dir=tmp_path,
                    fleet_faults="|decode@1=raise,decode@2=raise", **kw)
    reqs = [Request(i, p, max_new=mn) for i, (p, mn) in enumerate(spec)]
    out = router.run(reqs)
    sick = router.replicas[1]
    assert sick.state == "live" and sick.health < replica.SHED_THRESHOLD and sick.shed()
    assert out["counters"]["sheds"] >= 1 and out["counters"]["replica_deaths"] == 0
    single = Engine(cfg, device="cpu", params=router.replicas[0].engine.model.state_dict(),
                    injector=FaultInjector(""), **ENGINE_KW)
    alone = [Request(i, p, max_new=mn) for i, (p, mn) in enumerate(spec)]
    single.run(alone)
    assert [r.out for r in alone] == [r.out for r in reqs]


def test_router_provenance_rows(port_fleet):
    """Every replica's row: identity, how it was born, its device, the
    kernel policy, the health and fault picture, its busy clock; the result
    carries both throughput clocks and the router's host time."""
    router, _, out = port_fleet["pws"]
    rows = out["replicas"]
    assert [row["rid"] for row in rows] == [0, 1]
    assert [row["spawned_from"] for row in rows] == ["init", "checkpoint"]
    for row in rows:
        assert row["state"] == "live" and row["device"] == "cpu"
        assert isinstance(row["policy"], str) and row["policy"]
        assert 0.0 <= row["health"] <= 1.0 and "retries" in row["faults"]
        assert row["busy_s"] > 0
    assert out["fleet_busy_s"] == max(row["busy_s"] for row in rows)
    assert out["rounds"] > 0 and 0 <= out["router_host_s"] <= out["wall_s"]
    assert router.ckpt_save_s > 0


def test_router_cli_death_plan():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    env.pop("REPRO_FAULTS", None)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.router", "--reduced", "--device", "cpu",
         "--check-single", "--inject", "|decode@4=raise:99", "--min-restarts", "1"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "single-replica token parity: OK" in out.stdout


@pytest.fixture(autouse=True)
def _quiet_router_logs(caplog):
    caplog.set_level(logging.ERROR)
