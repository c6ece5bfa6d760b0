"""The port's lockstep Server against the JAX Server, and the port's
isolation from JAX.

Both servers hold the same parameters (the JAX server's own init, carried
across by ``params_from_numpy``) and get the same prompts, of unequal
lengths so that the left pad is attended as the JAX server attends it.  At
f32 the greedy tokens must be identical request for request.  At bf16 only
the prefill logits are compared: atol 1e-2 (logits up to about 0.5 in
magnitude; bf16 keeps 8 significant bits and the two sides round their
intermediates after sums taken in different orders).
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AxisType

torch = pytest.importorskip("torch")

from repro.checkpoint import save_checkpoint  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch.serve import Request as JaxRequest  # noqa: E402
from repro.launch.serve import Server as JaxServer  # noqa: E402
from repro.models.base import RunOptions  # noqa: E402
from repro_torch.checkpoint import load_repro_checkpoint, params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config, reduced  # noqa: E402
from repro_torch.launch.serve import Request, Server  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
MAX_LEN = 64
PROMPT_LENS = (8, 5, 11)
BF16_LOGITS_ATOL = 1e-2


@pytest.fixture(autouse=True)
def _reset_port_autotune():
    """The port's Server, Engine and trainer pin the autotune mode
    process-wide (``autotune.startup``), as JAX's do: clear it after each
    test."""
    yield
    from repro_torch.kernels import autotune as port_autotune

    port_autotune.set_mode(None)


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(3, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def _jax_server(dtype):
    """The JAX server as ``tests/test_train_serve.py`` builds it, on a 1x1
    mesh whose axes are Auto: the installed JAX makes ``make_debug_mesh``'s
    axes Explicit, and the server's sharding hints then refuse to trace."""
    cfg = dataclasses.replace(jax_smoke("qwen3-1.7b"), dtype=dtype)
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    return JaxServer(cfg, mesh, max_len=MAX_LEN, opts=RunOptions(remat="none"))


def _host_params(server):
    return jax.tree.map(np.asarray, server.params)


@pytest.fixture(scope="module")
def f32_run():
    js = _jax_server("float32")
    reqs = [JaxRequest(i, p, max_new=6) for i, p in enumerate(_prompts(256))]
    js.run_batch(reqs)
    return _host_params(js), [r.out for r in reqs]


def test_server_tokens_identical_to_jax_f32(f32_run):
    params, want = f32_run
    cfg = reduced(get_smoke_config("qwen3-1.7b"), dtype="float32")
    server = Server(cfg, device="cpu", params=params_from_numpy(params), max_len=MAX_LEN)
    reqs = [Request(i, p, max_new=6) for i, p in enumerate(_prompts(cfg.vocab_size))]
    out = server.run_batch(reqs)
    assert [r.out for r in reqs] == want
    assert out["tokens"] == 6 * len(reqs) and out["logits_finite"]
    assert out["decode_steps"] == 5


def test_server_per_row_stop(f32_run):
    """Rows stop at their own max_new or at eos; the wave ends early."""
    params, want = f32_run
    cfg = reduced(get_smoke_config("qwen3-1.7b"), dtype="float32")
    server = Server(cfg, device="cpu", params=params_from_numpy(params), max_len=MAX_LEN)
    reqs = [Request(i, p, max_new=n) for i, (p, n) in
            enumerate(zip(_prompts(cfg.vocab_size), (2, 6, 4)))]
    eos = want[1][3]
    expect = []
    for r, seq in zip(reqs, want):
        cut = seq[:r.max_new]
        expect.append(cut[:cut.index(eos) + 1] if eos in cut else cut)
    out = server.run_batch(reqs, eos_id=eos)
    assert [r.out for r in reqs] == expect
    assert out["completed"] == {i: len(e) for i, e in enumerate(expect)}
    assert out["decode_steps"] == max(map(len, expect)) - 1


def test_bf16_prefill_logits_close_to_jax():
    js = _jax_server("bfloat16")
    prompts = _prompts(256)
    plen = max(PROMPT_LENS)
    toks = np.zeros((len(prompts), plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    want, _ = js._prefill(js.params, {"tokens": jnp.asarray(toks)})
    server = Server(get_smoke_config("qwen3-1.7b"), device="cpu",
                    params=params_from_numpy(_host_params(js)), max_len=MAX_LEN)
    got, _ = server.model.prefill({"tokens": torch.from_numpy(toks)}, MAX_LEN)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BF16_LOGITS_ATOL)


def test_load_repro_checkpoint_round_trip(tmp_path, f32_run):
    """A JAX checkpoint (bf16 leaves stored as uint16) loads bit-exactly."""
    params, _ = f32_run
    bf16 = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
    save_checkpoint(tmp_path, 3, bf16)
    got = load_repro_checkpoint(tmp_path)
    want = params_from_numpy(jax.tree.map(np.asarray, bf16))
    assert got.keys() == want.keys() and "layers.1.wq" in got
    for name, t in want.items():
        assert got[name].dtype == torch.bfloat16
        assert torch.equal(got[name].view(torch.int16), t.view(torch.int16)), name
    np.testing.assert_array_equal(got["layers.1.wq"].float().numpy(),
                                  np.asarray(bf16["layers"]["wq"][1], np.float32))
    # the port's server takes the loaded state dict as it is
    Server(get_smoke_config("qwen3-1.7b"), device="cpu", params=got, max_len=MAX_LEN)


def test_import_loads_neither_jax_nor_repro():
    code = ("import repro_torch, repro_torch.launch.serve, repro_torch.launch.train, "
            "repro_torch.launch.steps, repro_torch.optim, repro_torch.data, "
            "repro_torch.kernels.ref, repro_torch.checkpoint, repro_torch.launch.engine, "
            "repro_torch.kernels.policy, repro_torch.core.pws, "
            "repro_torch.kernels.registry, repro_torch.kernels.planner, "
            "repro_torch.core.costmodel, "
            "repro_torch.runtime.fault_tolerance, repro_torch.models.dense, "
            "repro_torch.models.moe_layer, repro_torch.configs, "
            "repro_torch.launch.router, repro_torch.runtime.replica, "
            "repro_torch.runtime.elastic, repro_torch.core.rws, "
            "repro_torch.kernels.autotune, repro_torch.core.hbp, repro_torch.core.machine, "
            "repro_torch.core.layouts, repro_torch.core.algorithms, "
            "repro_torch.core.algorithms_torch, repro_torch.core.planner, "
            "repro_torch.core.sharding_hints, repro_torch.launch.mesh, "
            "repro_torch.launch.dryrun, repro_torch.launch.trace_analysis, "
            "repro_torch.core.collectives, sys; "
            "assert 'qwen3-moe-30b-a3b' in repro_torch.configs.list_archs(); "
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
            "or m.startswith(('jax.', 'repro.'))]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=SRC,
                   env={**os.environ, "PYTHONPATH": str(SRC)})


def test_sources_import_neither_jax_nor_repro():
    pat = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:\.|\s|$)", re.M)
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert files
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders
