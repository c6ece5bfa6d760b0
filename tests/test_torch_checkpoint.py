"""The port's checkpoints, fault-tolerant runner, LR schedules and int8
gradient compression against the JAX package's, on the CPU.

The first tests mirror the JAX package's own (``tests/test_substrate.py``):
round trip, checksum corruption, retention and atomicity, the async
manager, retry and give-up.  Then the port's own cases: its step updates
the parameters and the AdamW state in place, so a failure after the update
began is raised, not retried; a retried step and a resumed run equal the
unfaulted, uninterrupted run bit for bit.  Then the format both ways at
``olmoe-1b-7b``'s smoke size: the port's checkpoint read by JAX's
``load_checkpoint`` into the JAX ``{"params", "opt_state"}`` tree (bf16 and
f32 leaves, the same bits), and a checkpoint JAX's ``save_checkpoint``
wrote after two jitted JAX steps resumed by the port's ``train()``, whose
third step gives JAX's third loss within rtol 1e-5 at f32 (the loss
tolerance of ``tests/test_torch_train.py``); the JAX side runs once per
module.  The hybrid's tree (``groups/*`` and ``tail_rec`` stacked) both
ways: the port's checkpoint read by JAX, and JAX's parameters read by the
port giving JAX's prefill and decode logits within atol 1e-5 at f32.  The
cross-attention families' trees (the encoder-decoder's nested stacks, the
VLM's twice-stacked self layers at 10 layers) both ways, bit for bit.
Schedules and compression: rtol 1e-6 on f32 values computed by the same f32
operations, the int8 codes exact.
"""
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import load_checkpoint as jax_load_checkpoint  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save_checkpoint  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import SyntheticLMDataset as JaxDataset  # noqa: E402
from repro.launch.steps import make_train_step as jax_train_step  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.base import RunOptions as JaxRunOptions  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.optim import compression as jax_compression  # noqa: E402
from repro.optim import cosine_schedule as jax_cosine  # noqa: E402
from repro.optim import linear_warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, latest_step,  # noqa: E402
                                    load_checkpoint, load_repro_checkpoint,
                                    params_from_numpy, save_checkpoint)
from repro_torch.configs import get_smoke_config, reduced  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.kernels import policy  # noqa: E402
from repro_torch.launch import steps as pt_steps  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.optim import (compress_int8, cosine_schedule,  # noqa: E402
                               decompress_int8, linear_warmup_cosine)
from repro_torch.optim import compression as pt_compression  # noqa: E402
from repro_torch.runtime.fault_tolerance import (FaultTolerantRunner,  # noqa: E402
                                                 UpdateStartedError)

ARCH = "olmoe-1b-7b"
DATA = DataConfig(global_batch=2, seq_len=16)
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _reset_port_autotune():
    """The port's Server, Engine and trainer pin the autotune mode
    process-wide (``autotune.startup``), as JAX's do: clear it after each
    test."""
    yield
    from repro_torch.kernels import autotune as port_autotune

    port_autotune.set_mode(None)


def _state():
    """The JAX tests' state in the port's form: a layer-stacked leaf, a
    plain one, an int32 step and a bf16 leaf."""
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    return {"params": {"w": w, "layers.0.wq": w + 1, "layers.1.wq": w + 2,
                       "h": torch.linspace(-2, 2, 5).to(torch.bfloat16)},
            "opt_state": {"step": torch.tensor(5, dtype=torch.int32),
                          "m": {"w": torch.ones(2, 3)}}}


def _equal(a, b):
    return a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_roundtrip(tmp_path):
    state = _state()
    d = save_checkpoint(tmp_path, 5, state)
    assert d == tmp_path / "step_5" and latest_step(tmp_path) == 5
    manifest = (d / "manifest.json").read_text()
    assert '"layers/wq"' not in manifest and '"params/layers/wq"' in manifest
    like = {"params": {k: torch.zeros_like(v) for k, v in state["params"].items()},
            "opt_state": {"step": torch.tensor(0, dtype=torch.int32),
                          "m": {"w": torch.zeros(2, 3)}}}
    step, loaded = load_checkpoint(tmp_path, like)
    assert step == 5
    for key, t in state["params"].items():
        assert _equal(loaded["params"][key], t), key
    assert _equal(loaded["opt_state"]["step"], state["opt_state"]["step"])
    assert like["params"]["w"].sum() == 0  # not in place
    step, same = load_checkpoint(tmp_path, like, in_place=True)
    assert same is like and _equal(like["params"]["layers.1.wq"], state["params"]["layers.1.wq"])


def test_checkpoint_checksum_detects_corruption(tmp_path):
    state = _state()
    d = save_checkpoint(tmp_path, 1, state)
    victim = sorted(d.glob("leaf_*.npy"))[0]
    raw = bytearray(victim.read_bytes())
    raw[-1] ^= 0xFF
    victim.write_bytes(bytes(raw))
    like = _state()
    before = {k: v.clone() for k, v in like["opt_state"]["m"].items()}
    for in_place in (False, True):
        with pytest.raises(IOError):
            load_checkpoint(tmp_path, like, in_place=in_place)
    # every checksum is checked before the first in-place copy
    assert all(torch.equal(like["opt_state"]["m"][k], v) for k, v in before.items())


def test_checkpoint_retention_and_atomicity(tmp_path):
    state = _state()
    for s in [1, 2, 3, 4, 5]:
        save_checkpoint(tmp_path, s, state, keep=2)
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*"))
    assert steps == [4, 5]
    assert not list(tmp_path.glob("*.tmp"))
    (tmp_path / "step_9.tmp").mkdir()  # a save cut short is never the latest
    assert latest_step(tmp_path) == 5


def test_async_checkpoint_manager(tmp_path):
    mgr = CheckpointManager(tmp_path)
    state = _state()
    mgr.save_async(7, state)
    state["params"]["w"].add_(100)  # the snapshot was taken before save_async returned
    mgr.wait()
    step, loaded = mgr.restore_latest(_state())
    assert step == 7 and _equal(loaded["params"]["w"], _state()["params"]["w"])
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore_latest(_state())


def test_runner_retries_transient_failure(tmp_path):
    runner = FaultTolerantRunner(CheckpointManager(tmp_path), save_every=0, max_retries=2)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    assert runner.run_step(0, flaky) == "ok"
    assert runner.retries == 2


def test_runner_gives_up_and_raises(tmp_path):
    runner = FaultTolerantRunner(CheckpointManager(tmp_path), save_every=0, max_retries=1)

    def always_fails():
        raise ValueError("hard")

    with pytest.raises(RuntimeError):
        runner.run_step(0, always_fails)
    assert runner.retries == 2


def test_failure_after_the_update_began_is_not_retried(monkeypatch):
    """A failure inside the AdamW update comes out of the step as
    ``UpdateStartedError``, and the runner raises it at once: a second
    attempt would apply part of the update twice."""
    cfg = reduced(get_smoke_config(ARCH), dtype="float32")
    updates = []
    real = pt_steps.adamw_update

    def fails_midway(params, grads, opt_state, opt_cfg):
        updates.append(1)
        real(params, grads, opt_state, opt_cfg)
        raise RuntimeError("lost the card mid-update")

    monkeypatch.setattr(pt_steps, "adamw_update", fails_midway)
    with pytest.raises(UpdateStartedError) as err:
        train(cfg, steps=2, data_cfg=DATA, device="cpu", log_every=0)
    assert isinstance(err.value.__cause__, RuntimeError) and updates == [1]
    runner = FaultTolerantRunner(None, max_retries=2)

    def step_fn():
        raise UpdateStartedError("after")

    with pytest.raises(UpdateStartedError):
        runner.run_step(0, step_fn)
    assert runner.retries == 0


def _state_of(out):
    named = dict(out["model"].named_parameters())
    opt = out["opt_state"]
    flat = {f"params/{n}": p.detach() for n, p in named.items()}
    flat["step"] = opt["step"]
    for key in ("master", "m", "v"):
        flat.update({f"{key}/{n}": t for n, t in opt[key].items()})
    return flat


@pytest.fixture(scope="module")
def uninterrupted():
    """Three unfaulted steps of train() on the smoke config, at f32."""
    return train(reduced(get_smoke_config(ARCH), dtype="float32"), steps=3, data_cfg=DATA,
                 device="cpu", log_every=0)


def test_retried_step_equals_the_unfaulted_run(uninterrupted):
    """Step 1's first attempt fails before its update: the runner runs it
    again, and the run ends in the unfaulted run's state, bit for bit."""
    attempts = []

    def inject(step):
        attempts.append(step)
        if attempts.count(step) == 1 and step == 1:
            raise RuntimeError("injected before the update")

    out = train(reduced(get_smoke_config(ARCH), dtype="float32"), steps=3, data_cfg=DATA,
                device="cpu", log_every=0, before_update=inject)
    assert attempts == [0, 1, 1, 2] and out["retries"] == 1
    assert out["losses"] == uninterrupted["losses"]
    want = _state_of(uninterrupted)
    for name, t in _state_of(out).items():
        assert _equal(t, want[name]), name


def test_resume_equals_the_uninterrupted_run(tmp_path, uninterrupted, capsys, monkeypatch):
    """Two steps saving every step, then a fresh run on the same directory
    (through the CLI's flags) resumes at step 2: the same losses and the
    same final state, bit for bit."""
    cfg = reduced(get_smoke_config(ARCH), dtype="float32")
    first = train(cfg, steps=2, data_cfg=DATA, device="cpu", log_every=0,
                  ckpt_dir=str(tmp_path), save_every=1)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_0", "step_1"]
    rest = train(cfg, steps=3, data_cfg=DATA, device="cpu", log_every=0,
                 ckpt_dir=str(tmp_path))
    assert first["start"] == 0 and rest["start"] == 2
    assert first["losses"] + rest["losses"] == uninterrupted["losses"]
    want = _state_of(uninterrupted)
    for name, t in _state_of(rest).items():
        assert _equal(t, want[name]), name
    assert latest_step(tmp_path) == 2 and int(rest["opt_state"]["step"]) == 3
    # the CLI: --ckpt-dir / --save-every, bf16 smoke config, then a resume
    args = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2", "--seq", "8",
            "--ckpt-dir", str(tmp_path / "cli"), "--save-every", "1"]
    monkeypatch.setattr(policy, "_PROCESS", None)  # --impl installs a process policy
    monkeypatch.setattr(logging, "basicConfig", lambda **kw: None)  # nor the root logger
    train_main([*args, "--steps", "2"])
    train_main([*args, "--steps", "3", "--impl", "matmul=pallas"])
    assert policy.current().impl_for("matmul") == "pallas"
    printed = capsys.readouterr().out
    assert "steps 0-1:" in printed and "steps 2-2:" in printed
    assert latest_step(tmp_path / "cli") == 2


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX on the f32 smoke config: three jitted train steps from the JAX
    init, with the state after two saved by JAX's ``save_checkpoint``."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype="float32")
    jm = jax_build(jcfg, JaxRunOptions())
    params = jax.jit(jm.init)(jax.random.key(0))
    step = jax.jit(jax_train_step(jm, JaxAdamWConfig()))
    ds = JaxDataset(JaxDataConfig(global_batch=DATA.global_batch, seq_len=DATA.seq_len), jcfg)
    p, opt = params, jax_adamw_init(params)
    ckpt = tmp_path_factory.mktemp("jax_ckpt")
    losses = []
    for i in range(3):
        p, opt, metrics = step(p, opt, {k: jnp.asarray(v) for k, v in ds.batch_at(i).items()})
        losses.append(float(metrics["loss"]))
        if i == 1:
            jax_save_checkpoint(ckpt, i, {"params": p, "opt_state": opt})
    return dict(ckpt=ckpt, losses=losses, params=params_from_numpy(jax.tree.map(np.asarray, p)))


def test_jax_checkpoint_resumes_in_the_port(jax_run):
    """The port resumes JAX's step-1 checkpoint at step 2, and its step
    gives JAX's third loss; the parameters after it within 1% of a step."""
    out = train(reduced(get_smoke_config(ARCH), dtype="float32"), steps=3, data_cfg=DATA,
                device="cpu", log_every=0, ckpt_dir=str(jax_run["ckpt"]))
    assert out["start"] == 2 and int(out["opt_state"]["step"]) == 3
    np.testing.assert_allclose(out["losses"], jax_run["losses"][2:], rtol=LOSS_RTOL)
    for name, p in out["model"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jax_run["params"][name].numpy(),
                                   atol=0.01 * JaxAdamWConfig().lr, rtol=0, err_msg=name)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """The port's checkpoint of the bf16 smoke config (bf16 parameters, f32
    AdamW state) read by JAX's ``load_checkpoint`` into the JAX tree: every
    leaf's name, shape, dtype and bits.  JAX's save of those parameters
    alone still reads through ``load_repro_checkpoint``."""
    cfg = get_smoke_config(ARCH)
    out = train(cfg, steps=1, data_cfg=DATA, device="cpu", log_every=0,
                ckpt_dir=str(tmp_path))
    jcfg = jax_smoke(ARCH)
    aparams = jax.eval_shape(lambda: jax_build(jcfg, JaxRunOptions()).init(jax.random.key(0)))
    like = {"params": aparams, "opt_state": jax.eval_shape(jax_adamw_init, aparams)}
    step, tree = jax_load_checkpoint(tmp_path, like)
    assert step == 0
    got = {f"params/{n}": t for n, t in params_from_numpy(
        jax.tree.map(np.asarray, tree["params"])).items()}
    for key in ("master", "m", "v"):
        got.update({f"{key}/{n}": t for n, t in params_from_numpy(
            jax.tree.map(np.asarray, tree["opt_state"][key])).items()})
    got["step"] = torch.from_numpy(np.array(tree["opt_state"]["step"]))
    want = _state_of(out)
    assert got.keys() == want.keys()
    for name, t in want.items():
        assert _equal(got[name], t), name
    assert tree["params"]["embed"].dtype == jnp.bfloat16
    assert tree["params"]["layers"]["e_gate"].shape == (cfg.n_layers, cfg.n_experts,
                                                       cfg.d_model, cfg.expert_d_ff)
    # a parameter pytree saved by JAX still reads through the old entry
    jax_save_checkpoint(tmp_path / "params", 4, tree["params"])
    for name, t in load_repro_checkpoint(tmp_path / "params").items():
        assert _equal(t, want[f"params/{name}"]), name


HYBRID = "recurrentgemma-2b"
HYBRID_LAYERS = 5  # one superblock and a tail of two rec blocks


def _hybrid_cfgs(dtype="bfloat16"):
    """The hybrid's smoke config at 5 layers, in the port and in JAX."""
    return (reduced(get_smoke_config(HYBRID), n_layers=HYBRID_LAYERS, dtype=dtype),
            dataclasses.replace(jax_smoke(HYBRID), n_layers=HYBRID_LAYERS, dtype=dtype))


def test_hybrid_checkpoint_loads_in_jax(tmp_path):
    """The hybrid's tree both ways through the JAX format: the port's
    checkpoint of its bf16 smoke config (one AdamW step) read by JAX's
    ``load_checkpoint`` into the JAX tree (``groups/rec1|rec2|attn`` and
    ``tail_rec`` stacked, ``opt_state/m|v`` under the same names): every
    leaf's name, shape, dtype and bits, with the LRU's leaves f32 in the
    bf16 tree."""
    cfg, jcfg = _hybrid_cfgs()
    out = train(cfg, steps=1, data_cfg=DATA, device="cpu", log_every=0,
                ckpt_dir=str(tmp_path))
    aparams = jax.eval_shape(lambda: jax_build(jcfg, JaxRunOptions()).init(jax.random.key(0)))
    like = {"params": aparams, "opt_state": jax.eval_shape(jax_adamw_init, aparams)}
    step, tree = jax_load_checkpoint(tmp_path, like)
    assert step == 0
    got = {f"params/{n}": t for n, t in params_from_numpy(
        jax.tree.map(np.asarray, tree["params"])).items()}
    for key in ("master", "m", "v"):
        got.update({f"{key}/{n}": t for n, t in params_from_numpy(
            jax.tree.map(np.asarray, tree["opt_state"][key])).items()})
    got["step"] = torch.from_numpy(np.array(tree["opt_state"]["step"]))
    want = _state_of(out)
    assert got.keys() == want.keys()
    for name, t in want.items():
        assert _equal(got[name], t), name
    rec = tree["params"]["groups"]["rec1"]
    assert tree["params"]["embed"].dtype == jnp.bfloat16 and rec["w_x"].dtype == jnp.bfloat16
    for leaf in ("lru_a_gate", "lru_i_gate", "lru_a_param"):
        assert rec[leaf].dtype == jnp.float32, leaf
        assert tree["opt_state"]["m"]["groups"]["attn"]["wq"].dtype == jnp.float32
    assert rec["lru_a_gate"].shape[0] == 1 and tree["params"]["tail_rec"]["w_x"].shape[0] == 2


def test_jax_hybrid_checkpoint_gives_the_same_logits(tmp_path):
    """A JAX ``save_checkpoint`` of the hybrid's f32 smoke parameters, read
    by ``load_repro_checkpoint``: the port's prefill and one decode step
    give JAX's logits (atol 1e-5), and a bf16 init's checkpoint keeps its
    f32 leaves f32."""
    cfg, jcfg = _hybrid_cfgs("float32")
    jm = jax_build(jcfg, JaxRunOptions())
    params = jm.init(jax.random.key(3))
    jax_save_checkpoint(tmp_path / "f32", 7, params)
    toks = np.random.default_rng(0).integers(3, jcfg.vocab_size, (2, 11)).astype(np.int32)
    want, cache = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, 32))(params, toks)
    nxt = jnp.argmax(want, -1).astype(jnp.int32)[:, None]
    want_dec, _ = jax.jit(jm.decode_step)(params, nxt, jnp.asarray(11, jnp.int32), cache)

    from repro_torch.models import build_model

    model = build_model(cfg, device="cpu")
    model.load_state_dict(load_repro_checkpoint(tmp_path / "f32"))
    got, pcache = model.prefill({"tokens": torch.from_numpy(toks)}, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    got_dec, _ = model.decode_step(torch.from_numpy(np.array(nxt)),
                                   torch.tensor(11, dtype=torch.int32), pcache)
    np.testing.assert_allclose(got_dec.numpy(), np.asarray(want_dec), atol=1e-5)

    bf16 = jax_build(_hybrid_cfgs()[1], JaxRunOptions()).init(jax.random.key(0))
    jax_save_checkpoint(tmp_path / "bf16", 0, bf16)
    loaded = load_repro_checkpoint(tmp_path / "bf16")
    assert loaded["tail_rec.1.lru_a_param"].dtype == torch.float32
    assert loaded["groups.rec2.0.lru_i_gate"].dtype == torch.float32
    assert loaded["groups.attn.0.wq"].dtype == torch.bfloat16


# the cross-attention families' trees: the encoder-decoder's ``encoder`` and
# ``decoder`` stacks, whose leaves are nested dicts (``decoder/self_attn/wq``),
# and the VLM's ``self_layers`` stacked twice, (n_super, n_self, ...), beside
# ``cross_layers`` with scalar gates; the VLM at 10 layers, two superblocks
CROSS_ARCHS = {"seamless-m4t-large-v2": {}, "llama-3.2-vision-90b": {"n_layers": 10}}


def _cross_cfgs(arch, dtype="bfloat16"):
    kw = CROSS_ARCHS[arch]
    return (reduced(get_smoke_config(arch), dtype=dtype, **kw),
            dataclasses.replace(jax_smoke(arch), dtype=dtype, **kw))


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_cross_family_checkpoint_loads_in_jax(tmp_path, arch):
    """The port's checkpoint of the bf16 smoke config after one AdamW step
    (its frames or images from the data pipeline), read by JAX's
    ``load_checkpoint`` into the JAX tree: every leaf's name, shape, dtype
    and bits, the nested and the twice-stacked groups included."""
    cfg, jcfg = _cross_cfgs(arch)
    out = train(cfg, steps=1, data_cfg=DATA, device="cpu", log_every=0,
                ckpt_dir=str(tmp_path))
    aparams = jax.eval_shape(lambda: jax_build(jcfg, JaxRunOptions()).init(jax.random.key(0)))
    like = {"params": aparams, "opt_state": jax.eval_shape(jax_adamw_init, aparams)}
    step, tree = jax_load_checkpoint(tmp_path, like)
    assert step == 0
    got = {f"params/{n}": t for n, t in params_from_numpy(
        jax.tree.map(np.asarray, tree["params"])).items()}
    for key in ("master", "m", "v"):
        got.update({f"{key}/{n}": t for n, t in params_from_numpy(
            jax.tree.map(np.asarray, tree["opt_state"][key])).items()})
    got["step"] = torch.from_numpy(np.array(tree["opt_state"]["step"]))
    want = _state_of(out)
    assert got.keys() == want.keys()
    for name, t in want.items():
        assert _equal(got[name], t), name
    params = tree["params"]
    if arch == "llama-3.2-vision-90b":
        assert params["self_layers"]["wq"].shape[:2] == (2, 4)
        assert params["cross_layers"]["xgate_attn"].shape == (2,)
    else:
        assert params["decoder"]["cross_attn"]["wk"].shape[0] == 2


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_jax_cross_family_checkpoint_reads_bit_for_bit(tmp_path, arch):
    """A JAX ``save_checkpoint`` of the bf16 smoke parameters (the VLM's
    gates and norms set non-zero), read by ``load_repro_checkpoint`` and,
    into a model's own tensors, by ``load_checkpoint``: every leaf the same
    bits as ``params_from_numpy`` of the JAX tree."""
    from repro_torch.models import build_model

    cfg, jcfg = _cross_cfgs(arch)
    params = jax.tree.map(np.asarray, jax_build(jcfg, JaxRunOptions()).init(jax.random.key(2)))
    if "cross_layers" in params:
        rng = np.random.default_rng(0)
        params["cross_layers"] = {
            k: (rng.standard_normal(v.shape).astype(v.dtype)
                if k in ("xgate_attn", "xgate_ffn", "q_norm", "k_norm") else v)
            for k, v in params["cross_layers"].items()}
    jax_save_checkpoint(tmp_path, 4, params)
    want = params_from_numpy(params)
    got = load_repro_checkpoint(tmp_path)
    assert got.keys() == want.keys()
    model = build_model(cfg, device="cpu")
    assert set(dict(model.named_parameters())) == set(want)
    step, _ = load_checkpoint(tmp_path, dict(model.named_parameters()), in_place=True)
    assert step == 4
    state = model.state_dict()
    for name, t in want.items():
        assert _equal(got[name], t) and _equal(state[name], t), name


@pytest.mark.parametrize("warmup", [0, 5])
def test_schedules_match_jax(warmup):
    steps = np.arange(0, 130, 7, dtype=np.int32)
    if warmup:
        want = jax_warmup_cosine(3e-4, warmup, 100)(jnp.asarray(steps))
        got = linear_warmup_cosine(3e-4, warmup, 100)(torch.from_numpy(steps))
    else:
        want = jax_cosine(3e-4, 100, min_ratio=0.2)(jnp.asarray(steps))
        got = cosine_schedule(3e-4, 100, min_ratio=0.2)(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_compression_matches_jax():
    r = np.random.default_rng(0)
    g = (3 * r.standard_normal((7, 33))).astype(np.float32)
    res = (0.01 * r.standard_normal((7, 33))).astype(np.float32)
    q, s = jax_compression.compress_int8(jnp.asarray(g))
    pq, ps = compress_int8(torch.from_numpy(g))
    assert pq.dtype == torch.int8
    np.testing.assert_array_equal(pq.numpy(), np.asarray(q))
    np.testing.assert_allclose(ps.item(), float(s), rtol=1e-6)
    back = decompress_int8(pq, ps, torch.bfloat16)
    assert back.dtype == torch.bfloat16
    np.testing.assert_allclose(decompress_int8(pq, ps).numpy(),
                               np.asarray(jax_compression.decompress_int8(q, s)), rtol=1e-6)
    jq, js, jr = jax_compression.ef_compress({"g": jnp.asarray(g)}, {"g": jnp.asarray(res)})
    tq, ts, tr = pt_compression.ef_compress({"g": torch.from_numpy(g)},
                                            {"g": torch.from_numpy(res)})
    np.testing.assert_array_equal(tq["g"].numpy(), np.asarray(jq["g"]))
    np.testing.assert_allclose(tr["g"].numpy(), np.asarray(jr["g"]), rtol=1e-6, atol=1e-7)
    cq, cs = pt_compression.compress_tree({"g": torch.from_numpy(g)})
    assert torch.equal(cq["g"], pq) and torch.equal(cs["g"], ps)
