"""The port's MoE layer and the batched K2 behind it, against the JAX
package's ``moe_layer`` and ``common.expert_project``, on the CPU (the
kernel wrappers run their plain versions there).

Inputs are made from a seed with numpy; each JAX function runs jitted, once
per module (the ``jax_moe`` fixture).  Tolerances, all at f32: atol 1e-5 on
the router's weights, the aux term and the layer's output (a few matmuls
summed in another order on each side); the router's experts, the capacity
and every index are exact.  ``train()`` on ``olmoe-1b-7b``'s smoke config
is held to two jitted JAX train steps (loss rtol 1e-5, parameters atol 1%
of a step, as ``tests/test_torch_train.py``).  JAX is imported inside the
fixtures and tests that use it only, so the tests marked ``cuda`` (the
batched instances and the batched backward against their plain versions on
the card, at ``chip_smoke.py`` phase 2's shapes) run on a machine without
it: ``PYTHONPATH=src python -m pytest --noconftest -m cuda
tests/test_torch_moe.py``.
"""
import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config, reduced  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.hbp_matmul import hbp_matmul, matmul_ref  # noqa: E402
from repro_torch.kernels.strassen_matmul import matmul  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import common as pt_common  # noqa: E402
from repro_torch.models import moe_layer as pt_moe  # noqa: E402

mm_mod = importlib.import_module("repro_torch.kernels.hbp_matmul")

ATOL = 1e-5
N, D, E, F, K = 64, 16, 8, 32, 2


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


def _inputs(seed=0, n=N, tie=False):
    """x (n, d), w_router (d, E), e_gate/e_up (E, d, f), e_down (E, f, d);
    ``tie``: router columns 1 = 5 and 2 = 6 (so every token ties there)."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((n, D)).astype(np.float32)
    wr = r.standard_normal((D, E)).astype(np.float32)
    if tie:
        wr[:, 5], wr[:, 6] = wr[:, 1], wr[:, 2]
    eg, eu = (0.1 * r.standard_normal((E, D, F)).astype(np.float32) for _ in "gu")
    ed = (0.1 * r.standard_normal((E, F, D))).astype(np.float32)
    return x, wr, eg, eu, ed


# (label, seed, tied router columns, capacity factor, n_groups); the drop
# cases overflow experts (capacity 8 for 64 x 2 entries over 8 experts at cf
# 0.5), the last asks for 5 groups of 64 rows (no divisor: one group, as in
# JAX)
MOE_CASES = [("g1", 0, False, 1.25, 1), ("g2", 1, False, 1.25, 2), ("drops", 2, False, 0.5, 1),
             ("drops_g2", 3, False, 0.5, 2), ("tied", 4, True, 1.25, 1),
             ("g5_fallback", 5, False, 1.25, 5)]


@pytest.fixture(scope="module")
def jax_moe():
    """The JAX router, sort and one-hot dispatch on every case, jitted."""
    jax = pytest.importorskip("jax")
    from repro.models import moe_layer as jm

    out = {}
    for label, seed, tie, cf, groups in MOE_CASES:
        x, wr, eg, eu, ed = _inputs(seed, tie=tie)
        top_p, top_e, aux = jax.jit(jm.router, static_argnums=2)(x, wr, K)
        ys, aux_s = jax.jit(lambda *a, cf=cf, g=groups: jm.moe_ffn_sort(
            *a, k=K, capacity_factor=cf, n_groups=g))(x, wr, eg, eu, ed)
        yo, aux_o = jax.jit(lambda *a, cf=cf: jm.moe_ffn_onehot(
            *a, k=K, capacity_factor=cf))(x, wr, eg, eu, ed)
        out[label] = dict(top_p=np.asarray(top_p), top_e=np.asarray(top_e),
                          aux=float(aux), sort=np.asarray(ys), aux_sort=float(aux_s),
                          onehot=np.asarray(yo), aux_onehot=float(aux_o))
    caps = {(n, e, k, cf): jm.gapped_capacity(n, e, k, cf)
            for n in (1, 7, 8, 24, 512, 1000) for e in (3, 8, 64, 128) for k in (1, 2, 8)
            for cf in (0.5, 1.0, 1.25)}
    return out, caps


def _case(label):
    return next(c for c in MOE_CASES if c[0] == label)


def test_gapped_capacity_matches_jax(jax_moe):
    """The capacity of every (rows, experts, k, factor) on a grid, and the
    full-width ones the engine meets: 8 at an 8-slot decode step, 40 and
    80 at a 512-row chunk of qwen3-moe-30b-a3b and olmoe-1b-7b."""
    _, caps = jax_moe
    for key, want in caps.items():
        assert pt_moe.gapped_capacity(*key) == want, key
    assert pt_moe.gapped_capacity(8, 128, 8, 1.25) == 8
    assert pt_moe.gapped_capacity(512, 128, 8, 1.25) == 40
    assert pt_moe.gapped_capacity(512, 64, 8, 1.25) == 80
    assert pt_moe.round_up(41, pt_moe.SUBLANE) == 48


@pytest.mark.parametrize("label", ["g1", "tied"])
def test_router_matches_jax(jax_moe, label):
    """Weights, experts and the aux term; with tied router columns the lower
    expert comes first, as ``lax.top_k`` orders ties."""
    ref = jax_moe[0][label]
    _, seed, tie, _, _ = _case(label)
    x, wr, *_ = _inputs(seed, tie=tie)
    top_p, top_e, aux = pt_moe.router(_t(x), _t(wr), K)
    np.testing.assert_array_equal(top_e.numpy(), ref["top_e"])
    np.testing.assert_allclose(top_p.numpy(), ref["top_p"], atol=ATOL)
    np.testing.assert_allclose(aux.item(), ref["aux"], atol=ATOL)
    if tie:  # every token sees two pairs of equal probabilities
        probs = torch.softmax(_t(x) @ _t(wr), -1)
        assert torch.equal(probs[:, 1], probs[:, 5]) and torch.equal(probs[:, 2], probs[:, 6])
        # the higher twin only beside, and after, the lower one
        rows = [list(row) for row in ref["top_e"]]
        assert any(1 in row or 2 in row for row in rows)
        for lo, hi in ((1, 5), (2, 6)):
            for row in rows:
                assert hi not in row or (lo in row and row.index(lo) < row.index(hi)), row
    p2, e2, none = pt_moe.router(_t(x), _t(wr), K, aux=False)
    assert none is None and torch.equal(e2, top_e) and torch.equal(p2, top_p)


@pytest.mark.parametrize("label", [c[0] for c in MOE_CASES])
def test_moe_ffn_sort_matches_jax(jax_moe, label):
    """The sort dispatch at n_groups 1 and 2, with tokens dropped, with
    ties, and with a group count that does not divide the rows."""
    ref = jax_moe[0][label]
    _, seed, tie, cf, groups = _case(label)
    args = [_t(a) for a in _inputs(seed, tie=tie)]
    y, aux = pt_moe.moe_ffn_sort(*args, k=K, capacity_factor=cf, n_groups=groups)
    np.testing.assert_allclose(y.numpy(), ref["sort"], atol=ATOL)
    np.testing.assert_allclose(aux.item(), ref["aux_sort"], atol=ATOL)


def test_drop_cases_drop_tokens():
    """The 'drops' cases overflow an expert (else they would test nothing)."""
    for label in ("drops", "drops_g2"):
        _, seed, tie, cf, groups = _case(label)
        x, wr, *_ = _inputs(seed, tie=tie)
        _, top_e, _ = pt_moe.router(_t(x), _t(wr), K)
        per_group = top_e.reshape(groups, -1)
        cap = pt_moe.gapped_capacity(N // groups, E, K, cf)
        most = max(int(torch.bincount(g, minlength=E).max()) for g in per_group)
        assert most > cap, (label, most, cap)


@pytest.mark.parametrize("label", ["g1", "drops", "tied"])
def test_moe_ffn_onehot_matches_jax_and_sort(jax_moe, label):
    """The reference dispatch against JAX's, and the port's sort dispatch
    against the port's one-hot dispatch (one group)."""
    ref = jax_moe[0][label]
    _, seed, tie, cf, _ = _case(label)
    args = [_t(a) for a in _inputs(seed, tie=tie)]
    y, aux = pt_moe.moe_ffn_onehot(*args, k=K, capacity_factor=cf)
    np.testing.assert_allclose(y.numpy(), ref["onehot"], atol=ATOL)
    np.testing.assert_allclose(aux.item(), ref["aux_onehot"], atol=ATOL)
    ys, aux_s = pt_moe.moe_ffn(*args, k=K, capacity_factor=cf, dispatch="sort")
    yo, aux_o = pt_moe.moe_ffn(*args, k=K, capacity_factor=cf, dispatch="onehot")
    torch.testing.assert_close(ys, yo, atol=ATOL, rtol=0)
    torch.testing.assert_close(aux_s, aux_o, atol=ATOL, rtol=0)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_expert_project_matches_einsum(lead, monkeypatch):
    """(..., E, C, d) @ (E, d, f) against ``jnp.einsum`` in ONE matmul
    dispatch of 3-D operands, whatever the leading dims; the registry's
    batched ``matmul`` itself against the einsum."""
    jnp = pytest.importorskip("jax.numpy")
    r = np.random.default_rng(7)
    h = r.standard_normal((*lead, E, 16, D)).astype(np.float32)
    w = r.standard_normal((E, D, F)).astype(np.float32)
    want = np.asarray(jnp.einsum("...ecd,edf->...ecf", h, w))
    calls = []
    real = registry.dispatch

    def spy(name, *args, **kw):
        calls.append((name, tuple(a.shape for a in args)))
        return real(name, *args, **kw)

    monkeypatch.setattr(registry, "dispatch", spy)
    got = pt_common.expert_project(_t(h), _t(w))
    rows = 16 * math.prod(lead)
    assert calls == [("matmul", ((E, rows, D), (E, D, F)))]
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    monkeypatch.setattr(registry, "dispatch", real)
    flat = registry.dispatch("matmul", _t(h).reshape(-1, 16, D)[:E], _t(w))
    np.testing.assert_allclose(flat.numpy(), np.asarray(
        jnp.einsum("ecd,edf->ecf", h.reshape(-1, 16, D)[:E], w)), atol=ATOL)
    assert registry.get("matmul").plan(_t(h).reshape(-1, 16, D)[:E], _t(w)) == {
        "backend": "classical"}


@pytest.mark.parametrize("experts", [1, 8, 128])
def test_moe_layer_dispatches_one_product_each(experts, monkeypatch):
    """The sort dispatch makes three matmul dispatches, each of 3-D
    operands holding every expert (no loop over experts), for any E."""
    r = np.random.default_rng(experts)
    x = _t(r.standard_normal((8, D)).astype(np.float32))
    wr = _t(r.standard_normal((D, experts)).astype(np.float32))
    eg, eu = (_t(0.1 * r.standard_normal((experts, D, F)).astype(np.float32)) for _ in "gu")
    ed = _t(0.1 * r.standard_normal((experts, F, D)).astype(np.float32))
    calls = []
    real = registry.dispatch
    monkeypatch.setattr(registry, "dispatch",
                        lambda name, *a, **kw: calls.append(a[0].shape) or real(name, *a, **kw))
    pt_moe.moe_ffn(x, wr, eg, eu, ed, k=min(K, experts), capacity_factor=1.25)
    assert len(calls) == 3 and all(len(s) == 3 and s[0] == experts for s in calls)


def test_batched_path_and_plan_rules():
    """K2's batched instance from one slab: stream at 16 rows or fewer,
    wgmma above, fma for f32, wmma when a slab stride is off 16 bytes; the
    plan counts the slabs' tiles and keeps split-K off but for stream."""
    bf = torch.bfloat16
    w = torch.zeros(128, 2048, 768, dtype=bf)
    for m, want in ((8, "stream"), (16, "stream"), (17, "wgmma"), (40, "wgmma")):
        assert mm_mod.path(torch.zeros(128, m, 2048, dtype=bf), w) == want, m
    assert mm_mod.path(torch.zeros(128, 8, 2048), w.float()) == "fma"
    pad = torch.zeros(4, 8 * 2048 + 8, dtype=bf)[:, :8 * 2048].view(4, 8, 2048)
    assert mm_mod.path(pad, w[:4]) == "stream"  # a stride of whole 16-byte steps
    off = torch.zeros(4 * (8 * 2048 + 4), dtype=bf).as_strided((4, 8, 2048),
                                                              (8 * 2048 + 4, 2048, 1))
    assert mm_mod.path(off, w[:4]) == "wmma"  # slabs 8 bytes off 16-byte steps
    assert mm_mod.path(torch.zeros(4, 2048, 8, dtype=bf).mT, w[:4]) == "wgmma"  # transposed
    for inst in mm_mod.INSTANCES:
        for e, m, n, k in ((128, 8, 768, 2048), (128, 8, 2048, 768), (128, 40, 768, 2048),
                           (64, 80, 1024, 2048), (3, 13, 100, 72)):
            p = mm_mod.plan(m, n, k, inst, 132, e)
            assert (p.splits - 1) * p.kchunk < k <= p.splits * p.kchunk
            if inst != "stream":
                assert p.splits == 1, (inst, e, m, n, k)
    # the decode product's cluster: 128 x 12 tiles already fill the SMs
    assert mm_mod.plan(8, 768, 2048, "stream", 132, 128).splits == 2
    assert mm_mod.plan(8, 768, 2048, "stream", 132).splits == 8
    # the same shapes planned alone keep their split-K
    assert mm_mod.plan(40, 768, 2048, "wgmma", 132).splits > 1


def test_batched_matmul_shapes_and_grad_rule(monkeypatch):
    """Batched K2 on CPU tensors is its plain version; out_dtype holds; the
    batched backward, ``dA = g Bᵀ`` and ``dB = Aᵀ g`` per slab (each one
    batched call on transposed slab views), equals autograd of the plain
    version, at a capacity (13 rows) that is no multiple of K2's K step,
    and casts each gradient to its operand's dtype."""
    r = np.random.default_rng(3)
    a = _t(r.standard_normal((3, 13, 72)).astype(np.float32))
    b = _t(r.standard_normal((3, 72, 100)).astype(np.float32))
    torch.testing.assert_close(hbp_matmul(a, b), a @ b, atol=ATOL, rtol=1e-6)
    got = hbp_matmul(a.bfloat16(), b.bfloat16(), out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (3, 13, 100)
    torch.testing.assert_close(got, matmul_ref(a.bfloat16(), b.bfloat16(), torch.float32))
    with pytest.raises(ValueError):
        hbp_matmul(a, b[:2])
    with pytest.raises(ValueError):
        matmul(a, b, backend="strassen")
    g = _t(r.standard_normal((3, 13, 100)).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        x, w = (t.to(dt).clone().requires_grad_() for t in (a, b))
        shapes = []
        real = mm_mod.hbp_matmul

        def spy(p, q, **kw):
            shapes.append((tuple(p.shape), tuple(q.shape), p.stride(-1) != 1, q.stride(-1) != 1))
            return real(p, q, **kw)

        monkeypatch.setattr(mm_mod, "hbp_matmul", spy)
        matmul(x, w).backward(g.to(dt))
        monkeypatch.undo()
        # forward, dA = g (3x13x100) @ wᵀ (a transposed view), dB = xᵀ @ g
        assert shapes == [((3, 13, 72), (3, 72, 100), False, False),
                          ((3, 13, 100), (3, 100, 72), False, True),
                          ((3, 72, 13), (3, 13, 100), True, False)]
        x2, w2 = (t.detach().clone().requires_grad_() for t in (x, w))
        matmul_ref(x2, w2).backward(g.to(dt))
        assert x.grad.dtype == w.grad.dtype == dt
        torch.testing.assert_close(x.grad, x2.grad, atol=ATOL, rtol=1e-6)
        torch.testing.assert_close(w.grad, w2.grad, atol=ATOL, rtol=1e-6)
    with torch.no_grad():
        torch.testing.assert_close(matmul(a, b), a @ b, atol=ATOL, rtol=1e-6)


# (label, moe_groups, capacity factor): two AdamW steps of train() on
# olmoe-1b-7b's f32 smoke config against two jitted JAX steps; at cf 0.5
# an expert holds 8 of a layer's 64 (token, expert) entries, fewer than the
# busiest expert gets in every MoE call, so tokens drop in each
TRAIN_CASES = [("g1", 1, 1.25), ("g2", 2, 1.25), ("drops", 1, 0.5)]
TRAIN_DATA = DataConfig(global_batch=2, seq_len=16)


@pytest.mark.parametrize("case", TRAIN_CASES, ids=lambda c: c[0])
def test_moe_train_steps_match_jax(case, monkeypatch):
    """``train()`` takes MoE configs: its two steps (loss, parameters) equal
    two jitted JAX ``make_train_step`` steps from the same parameters on the
    same batches: the losses within rtol 1e-5 and each parameter within 1%
    of one step (the tolerances of ``tests/test_torch_train.py``) plus the
    first update's own spread where the two sides' first gradients differ
    relative to their size, as ``chip_smoke.py`` phase 3 holds the card to
    the CPU: AdamW's first update moves an element by lr * g / (|g| + eps),
    whose slope is 1 / (|g| + eps), so clipped first gradients a and b
    (read back from each side's first moment, m = (1 - b1) g) may part the
    updates by lr |a - b| / (min(|a|, |b|) + eps), and by up to 2 lr where
    their signs differ.  A gradient that is rounding noise on both sides
    (|g| ~ eps, far under the gradients' atol of 1e-5) is all spread."""
    import dataclasses

    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.configs import get_smoke_config as jax_smoke
    from repro.data import DataConfig as JaxDataConfig
    from repro.data import SyntheticLMDataset as JaxDataset
    from repro.launch.steps import make_train_step as jax_train_step
    from repro.models import build_model as jax_build
    from repro.models.base import RunOptions as JaxRunOptions
    from repro.optim import AdamWConfig as JaxAdamWConfig
    from repro.optim import adamw_init as jax_adamw_init
    from repro_torch.checkpoint import params_from_numpy
    from repro_torch.models import RunOptions, build_model
    from repro_torch.launch import steps as pt_steps
    from repro_torch.models import dense as pt_dense
    from repro_torch.optim import AdamWConfig

    _, groups, cf = case
    cfg = dataclasses.replace(reduced(get_smoke_config("olmoe-1b-7b"), dtype="float32"),
                              capacity_factor=cf)
    opts = RunOptions(moe_groups=groups)
    init = build_model(cfg, opts, device="cpu")
    init.init(torch.Generator().manual_seed(TRAIN_DATA.seed))  # train()'s init
    layers = {}
    tree = {}
    for name, p in init.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            layers.setdefault(parts[2], []).append(p.detach().numpy())
        else:
            tree[name] = p.detach().numpy()
    tree["layers"] = {k: np.stack(v) for k, v in layers.items()}

    jcfg = dataclasses.replace(jax_smoke("olmoe-1b-7b"), dtype="float32", capacity_factor=cf)
    jm = jax_build(jcfg, JaxRunOptions(moe_groups=groups))
    step = jax.jit(jax_train_step(jm, JaxAdamWConfig()))
    ds = JaxDataset(JaxDataConfig(global_batch=TRAIN_DATA.global_batch,
                                  seq_len=TRAIN_DATA.seq_len), jcfg)
    p = jax.tree.map(jnp.asarray, tree)
    opt = jax_adamw_init(p)
    want = []
    for i in range(2):
        p, opt, metrics = step(p, opt, {k: jnp.asarray(v) for k, v in ds.batch_at(i).items()})
        want.append(float(metrics["loss"]))
        if i == 0:
            jax_m1 = params_from_numpy(jax.tree.map(np.asarray, opt["m"]))
    stepped = params_from_numpy(jax.tree.map(np.asarray, p))

    seen = []  # per MoE call: (busiest expert's entries, capacity)
    real = pt_dense.moe_ffn

    def spy(x, w_router, *a, k, capacity_factor, n_groups, **kw):
        _, top_e, _ = pt_moe.router(x, w_router, k, aux=False)
        per_group = top_e.reshape(n_groups, -1)
        cap = pt_moe.gapped_capacity(x.shape[0] // n_groups, w_router.shape[1], k,
                                     capacity_factor)
        seen.append((max(int(torch.bincount(g_).max()) for g_ in per_group), cap))
        return real(x, w_router, *a, k=k, capacity_factor=capacity_factor,
                    n_groups=n_groups, **kw)

    port_m1 = {}
    real_update = pt_steps.adamw_update

    def first_moment(params, grads, opt_state, opt_cfg):
        out = real_update(params, grads, opt_state, opt_cfg)
        if not port_m1:
            port_m1.update({n: m.clone() for n, m in opt_state["m"].items()})
        return out

    monkeypatch.setattr(pt_dense, "moe_ffn", spy)
    monkeypatch.setattr(pt_steps, "adamw_update", first_moment)
    out = train(cfg, steps=2, data_cfg=TRAIN_DATA, opts=opts, device="cpu", log_every=0)
    np.testing.assert_allclose(out["losses"], want, rtol=1e-5)
    opt_cfg = AdamWConfig()
    for name, q in out["model"].named_parameters():
        a, b = (m1[name] / (1 - opt_cfg.b1) for m1 in (port_m1, jax_m1))
        least = torch.where(a * b > 0, torch.minimum(a.abs(), b.abs()), 0.0)
        spread = opt_cfg.lr * (a - b).abs() / (least + opt_cfg.eps)
        gap = (q.detach() - stepped[name]).abs()
        assert bool((gap <= 0.01 * opt_cfg.lr + spread).all()), (name, gap.max().item())
    assert out["start"] == 0 and int(out["opt_state"]["step"]) == 2
    if case[0] == "drops":
        assert all(most > cap for most, cap in seen), seen


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


# (label, E, m, k, n): chip_smoke.py phase 2's batched shapes: the
# qwen3-moe-30b-a3b decode products, its 512-row chunk's 40-row slabs,
# olmoe-1b-7b's 80-row chunk slabs, and slab and row counts that match no
# tile (for stream, wgmma, and wmma through a row pitch of 100 elements)
BATCHED_SHAPES = [("decode gate/up", 128, 8, 2048, 768), ("decode down", 128, 8, 768, 2048),
                  ("chunk gate/up", 128, 40, 2048, 768), ("chunk down", 128, 40, 768, 2048),
                  ("olmoe chunk", 64, 80, 2048, 1024), ("ragged stream", 3, 13, 72, 104),
                  ("ragged wgmma", 5, 37, 136, 72), ("ragged wmma", 3, 13, 72, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", BATCHED_SHAPES, ids=lambda s: s[0])
def test_batched_instances_match_plain(cuda, shape, dtype):
    """Each batched instance against the plain version, one launch a call
    (counted apart as a batched launch)."""
    _, e, m, k, n = shape
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(e + m)
    a = torch.randn(e, m, k, device=cuda, generator=gen).to(dt)
    b = (torch.randn(e, k, n, device=cuda, generator=gen) / math.sqrt(k)).to(dt)
    want_inst = "fma" if dt == torch.float32 else ("stream" if m <= 16 else "wgmma")
    if dt == torch.bfloat16 and (k * 2 % 16 or n * 2 % 16):
        want_inst = "wmma"
    assert mm_mod.path(a, b) == want_inst
    before, before_b = hbp_matmul.launches, hbp_matmul.batched_launches
    got = hbp_matmul(a, b)
    assert hbp_matmul.launches - before == 1 and hbp_matmul.batched_launches - before_b == 1
    tol = 2 ** -7 if dt == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), matmul_ref(a, b).float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("inst", ["wgmma", "stream", "wmma", "fma"])
def test_batched_layouts_and_out_dtype(cuda, inst):
    """Transposed slabs (each slab the view of a row-major one) and strided
    stacks, bf16 -> f32 output, and the wmma instance forced by a slab
    stride off 16 bytes."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    e, k, n = 5, 136, 72
    m = 8 if inst == "stream" else 37
    dt = torch.float32 if inst == "fma" else torch.bfloat16
    if inst == "wmma":  # slabs 4 elements past a 16-byte step apart
        store = torch.randn(e * (m * k + 4), device=cuda, generator=gen).to(dt)
        a = store.as_strided((e, m, k), (m * k + 4, k, 1))
    else:
        a = torch.randn(e, m, k, device=cuda, generator=gen).to(dt)
    bt = (torch.randn(e, n, k, device=cuda, generator=gen) / math.sqrt(k)).to(dt)
    for b in (bt.mT, bt.mT.contiguous()):
        assert mm_mod.path(a, b) == inst
        got = hbp_matmul(a, b, out_dtype=torch.float32)
        assert got.dtype == torch.float32
        tol = 1e-4 if dt == torch.float32 else 2 ** -7
        torch.testing.assert_close(got, matmul_ref(a, b, torch.float32), atol=tol, rtol=tol)
    if inst != "stream":  # stream takes a row-major a only
        at = torch.randn(e, k, m, device=cuda, generator=gen).to(dt).mT
        b = bt.mT.contiguous()
        tol = 1e-4 if dt == torch.float32 else 2 ** -7
        torch.testing.assert_close(hbp_matmul(at, b).float(), matmul_ref(at, b).float(),
                                   atol=tol, rtol=tol)


# (label, E, C, k, n) of the batched backward: olmoe-1b-7b's three expert
# products at 4 x 128 tokens (capacity 80), at 2 x 1024 (320) and at 40
# rows (the 40-row prefill slabs), and a ragged one with a stream-sized dA
BACKWARD_SHAPES = [("olmoe gate/up C80", 64, 80, 2048, 1024),
                   ("olmoe down C80", 64, 80, 1024, 2048),
                   ("olmoe gate/up C320", 64, 320, 2048, 1024),
                   ("olmoe down C40", 64, 40, 1024, 2048),
                   ("ragged C13", 3, 13, 72, 104)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", BACKWARD_SHAPES, ids=lambda s: s[0])
def test_batched_backward_matches_plain(cuda, shape, dtype):
    """The batched backward on the card: two batched launches, ``dA = g Bᵀ``
    and ``dB = Aᵀ g`` (K = the capacity, no multiple of the 64-deep K step
    but for C 320), each against its plain version.  Every slab holds
    nonzero data, so a last K step that read the next slab's rows would
    show."""
    _, e, c, k, n = shape
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(c + k)
    a = torch.randn(e, c, k, device=cuda, generator=gen).to(dt).requires_grad_()
    b = (torch.randn(e, k, n, device=cuda, generator=gen) / math.sqrt(k)).to(dt).requires_grad_()
    g = torch.randn(e, c, n, device=cuda, generator=gen).to(dt)
    y = matmul(a, b)
    before, before_b = hbp_matmul.launches, hbp_matmul.batched_launches
    y.backward(g)
    assert hbp_matmul.launches - before == 2 and hbp_matmul.batched_launches - before_b == 2
    tol = 2 ** -7 if dt == torch.bfloat16 else 1e-4
    with torch.no_grad():
        torch.testing.assert_close(a.grad.float(), matmul_ref(g, b.mT).float(), atol=tol, rtol=tol)
        torch.testing.assert_close(b.grad.float(), matmul_ref(a.mT, g).float(), atol=tol, rtol=tol)
    assert a.grad.dtype == b.grad.dtype == dt


@pytest.mark.cuda
def test_kernels_launch_from_a_fresh_thread(cuda):
    """K2, 2-D and batched, launched first from a new thread (one that has
    run no CUDA call, as autograd's backward thread may be when its first
    call is the batched ``dA``): the launch succeeds and the result is
    right."""
    import threading

    gen = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn(4, 80, 256, device=cuda, generator=gen).to(torch.bfloat16)
    b = torch.randn(4, 256, 128, device=cuda, generator=gen).to(torch.bfloat16)
    out = {}

    def run():
        try:
            out["3d"] = hbp_matmul(a.mT.mT, b)
            out["2d"] = hbp_matmul(a[0], b[0])
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 -- reported below
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert "error" not in out, out.get("error")
    tol = 2 ** -7
    torch.testing.assert_close(out["3d"].float(), matmul_ref(a, b).float(), atol=tol, rtol=tol)
    torch.testing.assert_close(out["2d"].float(), matmul_ref(a[0], b[0]).float(), atol=tol,
                               rtol=tol)


@pytest.mark.cuda
def test_moe_layer_on_card_matches_cpu(cuda):
    """The sort dispatch at f32 on the card (three batched fma launches)
    against the same call on the CPU."""
    args = [_t(a) for a in _inputs(6)]
    want, want_aux = pt_moe.moe_ffn(*args, k=K, capacity_factor=1.25)
    before = hbp_matmul.batched_launches
    got, aux = pt_moe.moe_ffn(*[a.to(cuda) for a in args], k=K, capacity_factor=1.25)
    assert hbp_matmul.batched_launches - before == 3
    torch.testing.assert_close(got.cpu(), want, atol=ATOL, rtol=0)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=ATOL, rtol=0)
