"""Training on a mesh, on the CPU: the port's ``train`` on
``make_debug_mesh``'s one-device mesh against the JAX trainer on a 1x1
mesh, and the port's examples.

JAX's trainer runs on a ``(1, 1)`` mesh with Auto axes (the installed
JAX's ``make_debug_mesh`` is Explicit-axis, which its trainer cannot take).
Both start from JAX's checkpoint of its own first step, so both continue
from the same state: the port's losses for steps 1-2 must equal JAX's
within rtol 1e-5 (f32 smoke config: two layers of matmuls and a softmax
summed in other orders, as tests/test_torch_train.py holds them), and its
final manifest's ``mesh_shape`` must equal JAX's.
"""
import dataclasses
import json
import shutil

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AxisType  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.launch.train import train as jax_train  # noqa: E402
from repro_torch.configs import get_smoke_config, reduced  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.launch.mesh import axis_sizes, make_debug_mesh  # noqa: E402
from repro_torch.launch.train import build_training, train  # noqa: E402
from repro_torch.models import RunOptions  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402

ARCH, STEPS = "qwen3-1.7b", 3
DATA = DataConfig(global_batch=2, seq_len=16)


@pytest.fixture(autouse=True)
def _reset_port_autotune():
    yield
    from repro_torch.kernels import autotune as port_autotune

    port_autotune.set_mode(None)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's trainer on a 1x1 mesh: one step and its final save (the
    ``{"params", "opt_state"}`` tree), copied for the port, then resumed to
    ``STEPS``."""
    cfg = dataclasses.replace(jax_smoke(ARCH), dtype="float32")
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
    root = tmp_path_factory.mktemp("jax_mesh_train")
    data = JaxDataConfig(global_batch=DATA.global_batch, seq_len=DATA.seq_len)
    jax_train(cfg, mesh=mesh, steps=1, data_cfg=data, ckpt_dir=str(root / "jax"),
              save_every=100, log_every=0)
    shutil.copytree(root / "jax", root / "port")
    out = jax_train(cfg, mesh=mesh, steps=STEPS, data_cfg=data, ckpt_dir=str(root / "jax"),
                    save_every=100, log_every=0)
    manifest = json.loads((root / "jax" / f"step_{STEPS - 1}" / "manifest.json").read_text())
    return dict(losses=out["losses"], mesh_shape=manifest["mesh_shape"], port_dir=root / "port")


def test_mesh_training_gives_jax_losses_and_manifest(jax_run):
    mesh = make_debug_mesh(device="cpu")
    out = train(reduced(get_smoke_config(ARCH), dtype="float32"), steps=STEPS, data_cfg=DATA,
                mesh=mesh, log_every=0, ckpt_dir=str(jax_run["port_dir"]), save_every=100)
    assert out["start"] == 1 and axis_sizes(out["mesh"]) == {"data": 1, "model": 1}
    np.testing.assert_allclose(out["losses"], jax_run["losses"], rtol=1e-5)
    manifest = json.loads((jax_run["port_dir"] / f"step_{STEPS - 1}" /
                           "manifest.json").read_text())
    assert manifest["mesh_shape"] == jax_run["mesh_shape"] == {"data": 1, "model": 1}


def test_mesh_and_no_mesh_give_the_same_bits():
    cfg = get_smoke_config(ARCH)
    a = train(cfg, steps=2, data_cfg=DATA, device="cpu", log_every=0)
    b = train(cfg, steps=2, data_cfg=DATA, mesh=make_debug_mesh(device="cpu"), log_every=0)
    assert a["losses"] == b["losses"]
    for (n, p), (_, q) in zip(a["model"].named_parameters(), b["model"].named_parameters()):
        assert torch.equal(p, q), n
    with pytest.raises(ValueError, match="not the mesh's device"):
        train(cfg, steps=1, data_cfg=DATA, device="meta", mesh=make_debug_mesh(device="cpu"))


def test_build_training_returns_the_plans():
    mesh = make_debug_mesh(device="cpu")
    cfg = get_smoke_config(ARCH)
    example = {"tokens": np.zeros((2, 16), np.int32), "labels": np.zeros((2, 16), np.int32)}
    step, init_state, (p_sh, o_sh, b_sh) = build_training(cfg, mesh, RunOptions(),
                                                          AdamWConfig(), example)
    params, opt = init_state(torch.Generator().manual_seed(0))
    assert params.keys() == dict(step.model.named_parameters()).keys()
    assert {n: s.spec for n, s in p_sh.items()} == planner.plan_params(params, mesh)
    assert o_sh["step"].spec == planner.P() and o_sh["m"].keys() == params.keys()
    assert {k: s.spec for k, s in b_sh.items()} == {"tokens": planner.P("data", None),
                                                    "labels": planner.P("data", None)}
    assert int(opt["step"]) == 0


# -- the examples, each once on the CPU ----------------------------------------------

def test_quickstart_example(capsys):
    from examples import quickstart_torch

    quickstart_torch.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert "PWS plan (sample):" in printed and "decoded token 3" in printed
    assert "mesh={'data': 1, 'model': 1}" in printed


def test_serve_example():
    from examples import serve_lm_torch

    reqs = serve_lm_torch.main(["--device", "cpu", "--batch", "2", "--max-new", "4"])
    assert [len(r.out) for r in reqs] == [4, 4]


def test_train_example(tmp_path):
    from examples import train_lm_torch

    out = train_lm_torch.main(["--device", "cpu", "--steps", "12", "--batch", "2", "--seq",
                               "32", "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 12 and (tmp_path / "step_11").is_dir()
