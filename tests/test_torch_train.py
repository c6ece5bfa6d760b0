"""The port's training path against the JAX package's, on the CPU (the
kernel wrappers run their plain versions there).

Inputs are made from a seed with numpy (or by the JAX package's own seeded
init and data pipeline, carried across as numpy); the JAX side is computed
once per module, jitted.  Tolerances, all at f32:

* cross-entropy and AdamW: rtol 1e-6 / atol 1e-7 where both sides do the
  same elementwise f32 arithmetic, looser only where a sum over a long axis
  is taken in another order (stated at each assert);
* the smoke model: loss rtol 1e-5, every gradient rtol 5e-3 / atol 1e-5 (as
  ``tests/test_strassen.py`` holds the JAX kernel route to its jnp route:
  two layers of matmuls and a softmax summed in other orders);
* parameters after AdamW steps: atol 3e-6, 1% of one step (lr 3e-4).
  AdamW divides each gradient by its own running magnitude, so an element
  whose gradient is near zero carries that gradient's relative rounding
  difference (the 5e-3 above, at worst) into its update.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import SyntheticLMDataset as JaxDataset  # noqa: E402
from repro.launch.steps import make_train_step as jax_train_step  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models.base import RunOptions as JaxRunOptions  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.optim import adamw_update as jax_adamw_update  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config, reduced  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMDataset  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import RunOptions, build_model  # noqa: E402
from repro_torch.models import common as pt_common  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, global_norm  # noqa: E402

# the kernel modules (the package exports their wrappers under the same names)
fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")
mm_mod = importlib.import_module("repro_torch.kernels.hbp_matmul")

BATCH, SEQ = 2, 32
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=5e-3, atol=1e-5)
PARAM_ATOL = 0.01 * AdamWConfig().lr


@pytest.fixture(autouse=True)
def _reset_port_autotune():
    """The port's Server, Engine and trainer pin the autotune mode
    process-wide (``autotune.startup``), as JAX's do: clear it after each
    test."""
    yield
    from repro_torch.kernels import autotune as port_autotune

    port_autotune.set_mode(None)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_batches(jcfg, n):
    ds = JaxDataset(JaxDataConfig(global_batch=BATCH, seq_len=SEQ), jcfg)
    return [ds.batch_at(i) for i in range(n)]


def _port_model(params, **opts):
    cfg = reduced(get_smoke_config("qwen3-1.7b"), dtype="float32")
    m = build_model(cfg, RunOptions(**opts), device="cpu")
    m.load_state_dict(params_from_numpy(params))
    return m


@pytest.fixture(scope="module")
def slice_refs():
    """JAX references on the f32 qwen3-1.7b smoke config: loss and grads of
    one batch, the parameters after two train steps, and one step with two
    microbatches, all from the JAX model's own init."""
    jcfg = dataclasses.replace(jax_smoke("qwen3-1.7b"), dtype="float32")
    jm = jax_build(jcfg, JaxRunOptions())
    params = jax.jit(jm.init)(jax.random.key(0))
    batches = _jax_batches(jcfg, 2)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(params, jb[0])

    step = jax.jit(jax_train_step(jm, JaxAdamWConfig()))
    p, opt = params, jax_adamw_init(params)
    step_losses = []
    for b in jb:
        p, opt, metrics = step(p, opt, b)
        step_losses.append(float(metrics["loss"]))

    jm2 = jax_build(jcfg, JaxRunOptions(microbatches=2))
    p_micro, _, m_micro = jax.jit(jax_train_step(jm2, JaxAdamWConfig()))(
        params, jax_adamw_init(params), jb[0])
    return dict(params=_np_tree(params), batches=batches, loss=float(loss),
                grads=params_from_numpy(_np_tree(grads)),
                stepped=params_from_numpy(_np_tree(p)), step_losses=step_losses,
                micro=params_from_numpy(_np_tree(p_micro)),
                micro_loss=float(m_micro["loss"]))


def _port_batch(b):
    return {k: _t(v) for k, v in b.items()}


def _loss_and_grads(model, batch):
    loss = model.loss(batch)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def test_loss_and_grads_match_jax(slice_refs):
    m = _port_model(slice_refs["params"])
    loss, grads = _loss_and_grads(m, _port_batch(slice_refs["batches"][0]))
    np.testing.assert_allclose(loss, slice_refs["loss"], rtol=LOSS_RTOL)
    assert grads.keys() == slice_refs["grads"].keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), slice_refs["grads"][name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_remat_does_not_change_values(slice_refs):
    """Per-layer recomputation gives the same loss and gradients, bit for
    bit (the same ops on the same inputs)."""
    batch = _port_batch(slice_refs["batches"][0])
    full = _loss_and_grads(_port_model(slice_refs["params"], remat="full"), batch)
    none = _loss_and_grads(_port_model(slice_refs["params"], remat="none"), batch)
    assert full[0] == none[0]
    for name, g in full[1].items():
        assert torch.equal(g, none[1][name]), name


def test_two_train_steps_match_jax(slice_refs):
    m = _port_model(slice_refs["params"])
    step = make_train_step(m, AdamWConfig())
    opt = adamw_init(dict(m.named_parameters()))
    losses = []
    for b in slice_refs["batches"]:
        opt, metrics = step(opt, _port_batch(b))
        losses.append(metrics["loss"].item())
    np.testing.assert_allclose(losses, slice_refs["step_losses"], rtol=LOSS_RTOL)
    assert int(opt["step"]) == 2
    for name, p in m.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), slice_refs["stepped"][name].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)


def test_microbatched_step_matches_jax(slice_refs):
    m = _port_model(slice_refs["params"], microbatches=2)
    opt, metrics = make_train_step(m, AdamWConfig())(
        adamw_init(dict(m.named_parameters())), _port_batch(slice_refs["batches"][0]))
    np.testing.assert_allclose(metrics["loss"].item(), slice_refs["micro_loss"], rtol=LOSS_RTOL)
    for name, p in m.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), slice_refs["micro"][name].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("seq,chunk", [(12, 4), (10, 4)], ids=["chunked", "ragged"])
def test_chunked_softmax_xent_matches_jax(seq, chunk):
    """-100 labels are masked; a sequence the chunk does not divide falls
    back to one chunk.  Value and both gradients."""
    r = np.random.default_rng(seq)
    hidden = r.standard_normal((2, seq, 16)).astype(np.float32)
    table = (0.3 * r.standard_normal((40, 16))).astype(np.float32)
    labels = r.integers(0, 40, (2, seq)).astype(np.int32)
    labels[0, :3] = -100
    labels[1, -2:] = -100

    def jax_loss(h, e):
        return jax_common.chunked_softmax_xent(h, e, jnp.asarray(labels), chunk=chunk)

    want, (wh, we) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(table))
    h, e = _t(hidden).requires_grad_(), _t(table).requires_grad_()
    got = pt_common.chunked_softmax_xent(h, e, _t(labels), chunk=chunk)
    got.backward()
    assert got.dtype == torch.float32
    # f32 logsumexp over 40 logits, summed over rows in another order
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(wh), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(we), rtol=1e-5, atol=1e-7)


def test_synthetic_batches_identical_to_jax():
    jcfg = jax_smoke("qwen3-1.7b")
    jds = JaxDataset(JaxDataConfig(seed=3, global_batch=3, seq_len=40), jcfg)
    pds = SyntheticLMDataset(DataConfig(seed=3, global_batch=3, seq_len=40),
                             get_smoke_config("qwen3-1.7b"))
    for step in (0, 1, 7):
        want, got = jds.batch_at(step), pds.batch_at(step)
        assert want.keys() == got.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


def test_adamw_update_matches_jax():
    """bf16 params with f32 master/m/v, a clipping grad norm, two steps; the
    second with f32 grads (the microbatched step's)."""
    r = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 4)}
    params = {n: r.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: (3.0 * r.standard_normal(s)).astype(np.float32) for n, s in shapes.items()}
             for _ in range(2)]
    cfg = JaxAdamWConfig()

    jp = {n: jnp.asarray(x, jnp.bfloat16) for n, x in params.items()}
    jopt = jax_adamw_init(jp)
    pp = {n: _t(x).to(torch.bfloat16) for n, x in params.items()}
    popt = adamw_init(pp)
    for i, g in enumerate(grads):
        jg = {n: jnp.asarray(x, jnp.bfloat16 if i == 0 else jnp.float32) for n, x in g.items()}
        pg = {n: _t(x).to(torch.bfloat16 if i == 0 else torch.float32) for n, x in g.items()}
        jp, jopt, jm = jax_adamw_update(jp, jg, jopt, cfg)
        pp, popt, pm = adamw_update(pp, pg, popt, AdamWConfig())
        # sum of squares over 30 leaves' elements in another order
        np.testing.assert_allclose(pm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-6)
        assert pm["grad_norm"].item() > 1.0  # the clip is active
        for n in shapes:
            for key in ("master", "m", "v"):
                np.testing.assert_allclose(popt[key][n].numpy(), np.asarray(jopt[key][n]),
                                           rtol=1e-6, atol=1e-7, err_msg=f"{key} {n}")
            assert pp[n].dtype == torch.bfloat16
            np.testing.assert_array_equal(pp[n].float().numpy(),
                                          np.asarray(jp[n], np.float32), err_msg=n)
    assert int(popt["step"]) == 2
    np.testing.assert_allclose(global_norm(pg).item(),
                               np.sqrt(sum(np.square(x).sum() for x in grads[1].values())),
                               rtol=1e-6)


def test_serving_path_takes_no_autograd_route(monkeypatch):
    """prefill and decode_step run under no_grad: the autograd Functions
    run their forwards only, so every product and attention call makes one
    forward-kernel call, as many as before the parameters became trainable
    (7 per layer + the logits; 1 attention per layer), no backward kernel
    runs, and nothing is recorded for a backward."""
    cfg = reduced(get_smoke_config("qwen3-1.7b"), dtype="float32")
    m = build_model(cfg, device="cpu")
    m.init(torch.Generator().manual_seed(0))
    calls = {"hbp_matmul": 0, "flash_attention": 0, "flash_attention_bwd": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(mm_mod, "hbp_matmul", counted("hbp_matmul", mm_mod.hbp_matmul))
    for name in ("flash_attention", "flash_attention_bwd"):
        monkeypatch.setattr(fa_mod, name, counted(name, getattr(fa_mod, name)))
    toks = torch.from_numpy(np.random.default_rng(0).integers(3, 256, (2, 5)).astype(np.int32))
    logits, cache = m.prefill({"tokens": toks}, 16)
    per_call = {"hbp_matmul": 7 * cfg.n_layers + 1, "flash_attention": cfg.n_layers,
                "flash_attention_bwd": 0}
    assert calls == per_call
    assert logits.grad_fn is None and not logits.requires_grad
    logits, _ = m.decode_step(logits.argmax(-1).to(torch.int32)[:, None],
                              torch.tensor(5, dtype=torch.int32), cache)
    assert calls == {k: 2 * v for k, v in per_call.items()}
    assert logits.grad_fn is None and not logits.requires_grad


def test_train_entry_point_on_cpu():
    """The trainer: seeded init, JAX-identical data, finite and decreasing
    loss on the smoke config; without device="cpu" it needs CUDA."""
    cfg = get_smoke_config("qwen3-1.7b")
    out = train(cfg, steps=3, data_cfg=DataConfig(global_batch=2, seq_len=16),
                device="cpu", log_every=0)
    assert len(out["losses"]) == len(out["grad_norms"]) == len(out["step_s"]) == 3
    assert all(np.isfinite(out["losses"])) and all(np.isfinite(out["grad_norms"]))
    assert out["losses"][-1] < out["losses"][0]
    assert int(out["opt_state"]["step"]) == 3
    assert out["model"].embed.dtype == torch.bfloat16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train(cfg, steps=1, data_cfg=DataConfig(global_batch=2, seq_len=16))
