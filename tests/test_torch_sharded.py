"""Sharded execution on the CPU: four gloo ranks on the ``(2, 2)`` mesh
(``data`` x ``model``) against the JAX package, on the ``qwen3-1.7b`` smoke
config at f32.

One module fixture spawns the four ranks once (``launch.mesh.spawn``); each
runs every case (``tests/torch_sharded_ranks.py``) and hands its results
back, and the tests only compare.  The JAX references are computed once
here, on a 1x1 mesh with Auto axes (the installed JAX's
``make_debug_mesh`` is Explicit-axis), as ``tests/test_torch_mesh_train.py``
builds them.  Tolerances: greedy tokens identical; losses rtol 1e-5 (two
layers of products summed in other orders, as ``test_torch_mesh_train.py``
holds them); parameters after the AdamW steps atol 3e-6, 1% of one step
(lr 3e-4), as ``test_torch_checkpoint.py`` holds them; a restored
checkpoint bit-equal.
"""
import dataclasses
import json
import shutil

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AxisType  # noqa: E402

import torch_sharded_ranks as ranks  # noqa: E402
from repro.checkpoint import load_checkpoint as jax_load_checkpoint  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.sharding_hints import axis_rules as jax_axis_rules  # noqa: E402
from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.kernels import policy as jax_policy  # noqa: E402
from repro.launch.engine import Engine as JaxEngine  # noqa: E402
from repro.launch.serve import Request as JaxRequest  # noqa: E402
from repro.launch.serve import Server as JaxServer  # noqa: E402
from repro.launch.train import train as jax_train  # noqa: E402
from repro.models import RunOptions as JaxRunOptions  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402

PARAM_ATOL = 3e-6
LOSS_RTOL = 1e-5


def _jax_cfg():
    return dataclasses.replace(jax_smoke(ranks.ARCH), dtype="float32")


def _jax_mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def _jax_engine(params, max_batch, chunk):
    eng = JaxEngine(_jax_cfg(), _jax_mesh(), max_batch=max_batch, max_len=ranks.MAX_LEN,
                    chunk=chunk, degrade_after=ranks.NEVER,
                    opts=JaxRunOptions(remat="none"))
    if params is not None:
        eng.params = params
    return eng


def _jax_tokens(eng, n):
    reqs = ranks.workload(n, JaxRequest)
    eng.run(reqs)
    return [r.out for r in reqs]


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """Every JAX run of this module: the server's wave, the engine's
    workload (fp and int8), and the trainer's first step saved and then
    resumed to ``STEPS``."""
    from repro.kernels import autotune

    root = tmp_path_factory.mktemp("sharded")
    try:
        js = JaxServer(_jax_cfg(), _jax_mesh(), max_len=ranks.MAX_LEN,
                       opts=JaxRunOptions(remat="none"))
        reqs = [JaxRequest(i, p, max_new=6) for i, p in enumerate(ranks.prompts(256))]
        js.run_batch(reqs)
        refs = {"server": [r.out for r in reqs], "params": js.params, "root": root}
        prompt = np.stack([ranks.prompts(256)[1]] * 2)
        with js.mesh, jax_axis_rules(js.rules, js.mesh):
            refs["prefill_logits"] = np.asarray(js._prefill(js.params, {"tokens": prompt})[0])
        refs["engine"] = _jax_tokens(_jax_engine(None, ranks.SLOTS, ranks.CHUNK), 6)
        with jax_policy.apply(**ranks.INT8):
            refs["engine_int8"] = _jax_tokens(_jax_engine(None, ranks.SLOTS, ranks.INT8_CHUNK), 4)
        data = JaxDataConfig(global_batch=ranks.DATA.global_batch, seq_len=ranks.DATA.seq_len)
        jax_train(_jax_cfg(), mesh=_jax_mesh(), steps=1, data_cfg=data,
                  ckpt_dir=str(root / "jax"), save_every=100, log_every=0)
        shutil.copytree(root / "jax", root / "jax_step0")
        out = jax_train(_jax_cfg(), mesh=_jax_mesh(), steps=ranks.STEPS, data_cfg=data,
                        ckpt_dir=str(root / "jax"), save_every=100, log_every=0)
        refs["losses"] = out["losses"]
        refs["trained"] = params_from_numpy(jax.tree.map(np.asarray, out["params"]))
    finally:
        autotune.set_mode(None)  # the JAX launchers pin the autotune mode process-wide
    return refs


@pytest.fixture(scope="module")
def results(jax_refs):
    """The four ranks' results, every case run once."""
    params = params_from_numpy(jax.tree.map(np.asarray, jax_refs["params"]))
    work = jax_refs["root"] / "ranks"
    work.mkdir()
    return port_mesh.spawn(ranks.run, 4, params, str(jax_refs["root"] / "jax_step0"),
                           str(work), device="cpu")


@pytest.fixture(autouse=True)
def _reset_port_autotune():
    yield
    from repro_torch.kernels import autotune as port_autotune

    port_autotune.set_mode(None)


def _each(results, key):
    """``key``'s value, the same on every rank that computed it."""
    vals = [r[key] for r in results if key in r]
    assert vals, key
    assert all(v == vals[0] for v in vals[1:]), (key, vals)
    return vals[0]


def test_server_tokens_match_jax_on_two_by_two(results, jax_refs):
    assert _each(results, "mesh") == {"data": 2, "model": 2}
    assert _each(results, "server") == jax_refs["server"]
    assert _each(results, "server_finite")
    for r in results:  # whole logits on every rank, JAX's within f32 rounding
        np.testing.assert_allclose(r["prefill_logits"].numpy(), jax_refs["prefill_logits"],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["engine", "engine_faulted", "engine_int8", "server_fused"])
def test_engine_and_options_match_jax_on_two_by_two(results, jax_refs, case):
    """The engine (each data rank owns two of the four slots), the engine
    under a fault plan (a raised decode launch retried in lockstep, a
    poisoned row replayed from a snapshot broadcast from its owner), the
    int8 cache and fused QKV: JAX's tokens."""
    want = {"engine": "engine", "engine_faulted": "engine", "engine_int8": "engine_int8",
            "server_fused": "server"}[case]
    assert _each(results, case) == jax_refs[want]
    if case == "engine_faulted":
        faults = _each(results, "engine_faulted_stats")
        assert faults["faults_injected"] == 2 and faults["slots_poisoned"] == 1


def test_decode_collectives_are_counted(results):
    """A sharded wave's collectives, by kind: the weights' FSDP gathers,
    the row-parallel and embedding all-reduces, the sampled tokens'
    gathers; every rank makes the same ones."""
    counts = _each(results, "decode_collectives")
    assert counts["all_gather"]["calls"] > 0 and counts["all_reduce"]["calls"] > 0
    assert counts["reduce_scatter"]["calls"] == 0  # no gradient when serving


def test_row_parallel_sums_are_reduced_in_f32(results):
    """A bf16 row-parallel product: each rank's f32 partial sums are
    all-reduced in f32 and rounded once (not rounded to bf16 before the
    all-reduce): bit-equal to the two halves' f32 products added in f32."""
    x, w = ranks.row_parallel_operands()
    half = x.shape[1] // 2
    parts = [x[:, s].float() @ w[s].float() for s in (slice(0, half), slice(half, None))]
    want = (parts[0] + parts[1]).to(torch.bfloat16)
    rounded = (parts[0].to(torch.bfloat16) + parts[1].to(torch.bfloat16))
    assert not torch.equal(want, rounded)  # the case tells the two apart
    for r in results:
        assert r["row_parallel"].dtype == torch.bfloat16
        assert torch.equal(r["row_parallel"], want)


def test_training_matches_jax_on_two_by_two(results, jax_refs):
    """Three steps from JAX's own first-step checkpoint: the port resumes at
    step 1 on ``(2, 2)`` and gives JAX's losses, and its gathered
    parameters after the last step are JAX's."""
    assert _each(results, "start") == 1
    np.testing.assert_allclose(_each(results, "losses"), jax_refs["losses"],
                               rtol=LOSS_RTOL)
    trained = results[0]["trained"]["params"]
    assert trained.keys() == jax_refs["trained"].keys()
    for name, want in jax_refs["trained"].items():
        np.testing.assert_allclose(trained[name].numpy(), want.numpy(), atol=PARAM_ATOL,
                                   rtol=0, err_msg=name)


def test_two_by_two_checkpoint_reads_in_jax(results, jax_refs):
    """The checkpoint rank 0 wrote for the ``(2, 2)`` run: its manifest
    names that mesh, and JAX's ``load_checkpoint`` reads it into JAX's tree
    bit-equal to the gathered state."""
    port = jax_refs["root"] / "ranks" / "port"
    manifest = json.loads((port / f"step_{ranks.STEPS - 1}" / "manifest.json").read_text())
    assert manifest["mesh_shape"] == {"data": 2, "model": 2}
    jcfg = _jax_cfg()
    aparams = jax.eval_shape(lambda: jax_build(jcfg, JaxRunOptions()).init(jax.random.key(0)))
    like = {"params": aparams, "opt_state": jax.eval_shape(jax_adamw_init, aparams)}
    step, tree = jax_load_checkpoint(port, like)
    assert step == ranks.STEPS - 1
    want = results[0]["trained"]
    for name, t in params_from_numpy(jax.tree.map(np.asarray, tree["params"])).items():
        assert torch.equal(t, want["params"][name]), name
    for key in ("master", "m", "v"):
        got = params_from_numpy(jax.tree.map(np.asarray, tree["opt_state"][key]))
        for name, t in got.items():
            assert torch.equal(t, want["opt_state"][key][name]), (key, name)


def test_checkpoint_restores_onto_one_by_two_and_one_device(results, jax_refs):
    """That checkpoint restored bit-equal onto ``(1, 2)`` (ranks 0-1) and
    onto one device (rank 0); ``Engine.restart`` on ``(1, 2)`` serves JAX's
    tokens for the trained parameters."""
    assert [r.get("restored_12") for r in results] == [True, True, None, None]
    assert [r.get("restored_1") for r in results] == [True, None, None, None]
    port = jax_refs["root"] / "ranks" / "port"
    jcfg = _jax_cfg()
    aparams = jax.eval_shape(lambda: jax_build(jcfg, JaxRunOptions()).init(jax.random.key(0)))
    _, params = jax_load_checkpoint(port, {"params": aparams})
    from repro.kernels import autotune

    try:
        want = _jax_tokens(_jax_engine(params["params"], 2, ranks.CHUNK), 2)
    finally:
        autotune.set_mode(None)
    assert _each(results, "restart_12") == want


@pytest.mark.parametrize("arch", ranks.UNSHARDED + ("router",))
def test_unsharded_family_raises_on_two_by_two(results, arch):
    """A family or config this slice does not shard raises on ``(2, 2)``,
    naming itself and ``ROADMAP.md``, and so does the ``Router`` over
    multi-rank replicas; nothing is replicated quietly."""
    msg = _each(results, "refused").get(arch)
    assert msg is not None, arch
    assert "ROADMAP.md" in msg and "{'data': 2, 'model': 2}" in msg


def test_spawn_builds_the_kernels_once_before_the_ranks(monkeypatch):
    """On CUDA, ``spawn`` builds every kernel in the parent before the
    ranks start (each rank only loads them), and picks gloo for ranks that
    share a card: four ranks on one card."""
    import torch.multiprocessing as mp

    from repro_torch.kernels import _build

    calls = []
    monkeypatch.setattr(port_mesh, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(_build, "build", lambda names=None: calls.append("build") or {})

    def fake_spawn(fn, args, nprocs, join):
        n, tmp, device_type, backend = args[:4]
        calls.append(("spawn", nprocs, device_type, backend))
        for r in range(nprocs):
            torch.save(r, f"{tmp}/result_{r}.pt")

    monkeypatch.setattr(mp, "spawn", fake_spawn)
    assert port_mesh.spawn(print, 4, device="cuda") == [0, 1, 2, 3]
    assert calls == ["build", ("spawn", 4, "cuda", "gloo")]
    assert port_mesh.backend_for("cuda", 1) == "nccl"
    assert port_mesh.backend_for("cpu", 4) == "gloo"
    assert port_mesh.backend_for("cuda", 4, "nccl") == "nccl"


def test_only_rank_zero_searches(monkeypatch):
    """Under a process group of several ranks only rank 0 searches and
    writes the autotune tables; ``search`` pins ``replay`` elsewhere."""
    import torch.distributed as dist

    from repro_torch.kernels import autotune as port_autotune

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    for rank, want in ((0, "search"), (3, "replay")):
        monkeypatch.setattr(dist, "get_rank", lambda rank=rank: rank)
        assert port_autotune.searcher() is (rank == 0)
        assert port_autotune.startup("search", "cpu") == want
