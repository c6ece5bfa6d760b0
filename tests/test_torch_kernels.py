"""The port's kernels against the JAX package's.

On the CPU the port's wrappers run their plain versions, so these tests hold
``matmul_ref`` and ``flash_attention_ref`` (also over an int8 KV cache with
its scales, K1q's plain version) against the JAX Pallas kernels
(interpret mode) and the JAX oracles, on the same numpy inputs, and the
backward (``matmul``'s and ``FlashAttention``'s, K3's plain version) against
the JAX kernels' custom VJPs.  Tolerance: f32 throughout, atol 1e-5 forward
(the two sides sum in different orders) and 1e-4 backward (as
``tests/test_gqa_native.py`` holds the JAX VJP to its oracle: the gradients
are sums of products of the forward's sums).

The CUDA kernels themselves cannot run here; the tests marked ``cuda`` hold
them against their plain versions on the card and skip without one
(``PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_kernels.py`` on a
machine with a GPU).  ``chip_smoke.py`` checks them at the serving shapes.
"""
import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttention,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_int8,
    flash_attention_ref,
)
from repro_torch.kernels.hbp_matmul import hbp_matmul, matmul_ref  # noqa: E402
from repro_torch.kernels.strassen_matmul import matmul  # noqa: E402

# the package exports the wrapper under the module's name
mm_mod = importlib.import_module("repro_torch.kernels.hbp_matmul")

ATOL = 1e-5
BWD_ATOL = 1e-4

MM_SHAPES = [(8, 16, 24), (5, 7, 3), (16, 32, 64)]

# (name, b, sq, sk, h, kvh, hd, causal, window, q_offset, kv_len)
FA_CASES = [
    ("prefill_gqa", 2, 8, 8, 4, 2, 16, True, 0, None, None),
    ("prefill_mha_noncausal", 2, 8, 8, 2, 2, 16, False, 0, None, None),
    ("windowed", 1, 8, 8, 4, 2, 16, True, 3, None, None),
    ("decode_scalar", 2, 1, 16, 4, 2, 16, True, 0, [9], [10]),
    ("decode_rows_zero_lane", 2, 1, 16, 4, 2, 16, True, 0, [3, 0], [4, 0]),
    ("decode_rows_fully_masked", 2, 1, 16, 4, 1, 16, True, 2, [12, 3], [4, 4]),
    # gemma3-1b's head dim and GQA 4:1, windowed, over 96 keys: a 24-row chunk
    # and decode lanes, each with a kv_len 0 lane
    ("chunk_gqa_4_1_window_hd256", 2, 24, 96, 4, 1, 256, True, 16, [72, 0], [96, 0]),
    ("decode_gqa_4_1_window_hd256", 3, 1, 96, 4, 1, 256, True, 16, [95, 40, 7], [96, 41, 0]),
]
# cross-attention: queries over another key set, every key visible
FA_CROSS_CASES = [("cross_noncausal_sq5_sk17", 2, 5, 17, 4, 2, 16, False, 0, None, None)]


# (name, b, sq, sk, h, kvh, hd, causal, window, q_offset, kv_len)
BWD_CASES = [
    ("causal_mha", 2, 16, 16, 2, 2, 16, True, 0, None, None),
    ("causal_gqa_16_8", 1, 16, 16, 16, 8, 16, True, 0, None, None),
    ("offset_rows_zero_lane", 2, 8, 16, 4, 2, 16, True, 0, [8, 4], [16, 0]),
    ("window", 2, 16, 16, 4, 2, 16, True, 5, None, None),
    ("causal_gqa_4_1_hd256", 2, 16, 16, 4, 1, 256, True, 0, None, None),
    ("window_gqa_4_1_sk96_hd256", 1, 24, 96, 4, 1, 256, True, 16, [72], [96]),
    ("noncausal_cross_sq8_sk24", 2, 8, 24, 4, 2, 16, False, 0, None, None),
]
# (m, k, n, b passed as the transposed view of an (n, k) table)
MM_BWD_CASES = [(8, 16, 24, False), (16, 32, 64, True)]


def _rng(seed):
    return np.random.default_rng(seed)


def _fa_inputs(case, seed=0):
    _, b, sq, sk, h, kvh, hd, *_ = case
    r = _rng(seed)
    q = r.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = r.standard_normal((b, sk, kvh, hd)).astype(np.float32)
    v = r.standard_normal((b, sk, kvh, hd)).astype(np.float32)
    return q, k, v


def _lanes(x, device="cpu"):
    return None if x is None else torch.tensor(x, dtype=torch.int32, device=device)


def _fold(x):
    """(b, s, heads, hd) -> the JAX kernel's (b * heads, s, hd)."""
    b, s, h, hd = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, s, hd)


def _unfold(x, b):
    """The JAX kernel's (b * heads, s, hd) -> (b, s, heads, hd)."""
    bh, s, hd = x.shape
    return x.reshape(b, bh // b, s, hd).transpose(0, 2, 1, 3)


def _bwd_inputs(case, seed=5):
    q, k, v = _fa_inputs(case, seed)
    g = _rng(seed + 1).standard_normal(q.shape).astype(np.float32)
    return q, k, v, g


def _mm_bwd_inputs(case, seed=3):
    m, k, n, trans = case
    r = _rng(seed)
    a = r.standard_normal((m, k)).astype(np.float32)
    b = r.standard_normal((n, k) if trans else (k, n)).astype(np.float32)
    return a, b, r.standard_normal((m, n)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_refs():
    """Every JAX reference of this module, computed once."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import jax

    from repro.kernels import ref
    from repro.kernels.flash_attention import flash_attention as jax_fa
    from repro.kernels.hbp_matmul import hbp_matmul as jax_mm
    from repro.kernels.strassen_matmul import matmul as jax_matmul

    out = {"mm": {}, "fa": {}, "bwd": {}, "mm_bwd": {}}
    for i, (m, k, n) in enumerate(MM_SHAPES):
        r = _rng(i)
        a = r.standard_normal((m, k)).astype(np.float32)
        b = r.standard_normal((k, n)).astype(np.float32)
        out["mm"][(m, k, n)] = (a, b, np.asarray(jax_mm(jnp.asarray(a), jnp.asarray(b),
                                                        interpret=True)),
                                np.asarray(ref.matmul_ref(jnp.asarray(a), jnp.asarray(b))))
    for case in FA_CASES + FA_CROSS_CASES:
        name, b, sq, sk, h, kvh, hd, causal, window, qo, kl = case
        q, k, v = _fa_inputs(case)
        kw = dict(causal=causal, window=window,
                  q_offset=None if qo is None else np.asarray(qo, np.int32),
                  kv_len=None if kl is None else np.asarray(kl, np.int32),
                  n_heads=h if kvh != h else None)
        fq, fk, fv = (jnp.asarray(_fold(x)) for x in (q, k, v))
        kern = np.asarray(jax_fa(fq, fk, fv, interpret=True, **kw))
        oracle = np.asarray(ref.flash_attention_ref(fq, fk, fv, **kw))
        unfold = lambda o: o.reshape(b, h, sq, hd).transpose(0, 2, 1, 3)  # noqa: E731
        out["fa"][name] = (unfold(kern), unfold(oracle))
    for case in BWD_CASES:
        name, b, sq, sk, h, kvh, hd, causal, window, qo, kl = case
        q, k, v, g = _bwd_inputs(case)
        kw = dict(causal=causal, window=window, q_block=8, kv_block=8, interpret=True,
                  q_offset=None if qo is None else np.asarray(qo, np.int32),
                  kv_len=None if kl is None else np.asarray(kl, np.int32),
                  n_heads=h if kvh != h else None)
        _, vjp = jax.vjp(lambda q, k, v: jax_fa(q, k, v, **kw),
                         *(jnp.asarray(_fold(x)) for x in (q, k, v)))
        out["bwd"][name] = [_unfold(np.asarray(d), b) for d in vjp(jnp.asarray(_fold(g)))]
    for case in MM_BWD_CASES:
        a, b, g = _mm_bwd_inputs(case)
        trans = case[3]
        _, vjp = jax.vjp(lambda a, b: jax_matmul(a, b.T if trans else b, backend="classical",
                                                 interpret=True),
                         jnp.asarray(a), jnp.asarray(b))
        out["mm_bwd"][case] = [np.asarray(d) for d in vjp(jnp.asarray(g))]
    return out


@pytest.mark.parametrize("shape", MM_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matmul_ref_matches_jax(jax_refs, shape):
    a, b, kern, oracle = jax_refs["mm"][shape]
    got = matmul_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, kern, atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=1e-5)


def test_matmul_wrapper_cpu_transposed_b_and_out_dtype():
    """The wrapper takes B as a transposed view and honours out_dtype."""
    r = _rng(1)
    a = torch.from_numpy(r.standard_normal((6, 10)).astype(np.float32)).bfloat16()
    table = torch.from_numpy(r.standard_normal((12, 10)).astype(np.float32)).bfloat16()
    got = hbp_matmul(a, table.T, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (6, 12)
    torch.testing.assert_close(got, a.float() @ table.float().T, atol=ATOL, rtol=1e-5)
    assert hbp_matmul(a, table.T).dtype == torch.bfloat16


@pytest.mark.parametrize("m,n,k", [(4, 2048, 2048), (4, 2048, 6144), (256, 6144, 2048),
                                   (4, 151936, 2048), (5, 70, 37), (1, 1, 1),
                                   (512, 2048, 151936), (17, 65, 2056)])
@pytest.mark.parametrize("instance", mm_mod.INSTANCES)
def test_matmul_plan_covers_k(instance, m, n, k):
    """For each instance the splits are whole K steps that cover K exactly
    once, within the instance's limits (stream: one cluster of at most 8;
    wgmma: one of its tile widths)."""
    p = mm_mod.plan(m, n, k, instance, sms=132)
    bm, bk = mm_mod.TILE[instance]
    assert p.kchunk % bk == 0 and p.splits >= 1 and p.group >= 1
    assert (p.splits - 1) * p.kchunk < k <= p.splits * p.kchunk
    if instance == "wgmma":
        assert p.tile_m == bm and p.tile_n in mm_mod.WGMMA_BN
    if instance == "stream":
        assert p.splits <= mm_mod.STREAM_MAX_SPLITS
    if instance == "wmma":
        assert p.tile_m == (16 if m <= 16 else 64)
    assert mm_mod.plan(m, n, k, instance, sms=132) is p  # memoized


def test_matmul_path_rule():
    """K2's instance from dtype, rows and layout, decided on CPU tensors
    without a launch: wgmma for bf16 above 16 rows, stream for a row-major
    bf16 A of at most 16 rows, wmma where TMA cannot describe an operand (a
    base off 16 bytes, a row pitch of 100 elements), fma for f32."""
    bf = torch.bfloat16
    w = torch.zeros(2048, 1024, dtype=bf)
    for m, want in ((4, "stream"), (16, "stream"), (17, "wgmma"), (512, "wgmma")):
        assert mm_mod.path(torch.zeros(m, 2048, dtype=bf), w) == want, m
    act = torch.zeros(512, 2048, dtype=bf)
    assert mm_mod.path(act.T, torch.zeros(512, 1024, dtype=bf)) == "wgmma"  # dW = xᵀ g
    assert mm_mod.path(torch.zeros(2048, 8, dtype=bf).T, w) == "wgmma"  # 8 rows, transposed
    table = torch.zeros(1000, 2048, dtype=bf)
    assert mm_mod.path(torch.zeros(4, 2048, dtype=bf), table.T) == "stream"  # embed.T
    assert mm_mod.path(act, table.T) == "wgmma"
    flat = torch.zeros(512 * 2048 + 8, dtype=bf)
    assert flat.data_ptr() % 16 == 0
    assert mm_mod.path(flat[4:4 + 512 * 2048].view(512, 2048), w) == "wmma"  # 8 bytes off
    assert mm_mod.path(flat[8:].view(512, 2048), w) == "wgmma"  # 16 bytes off
    assert mm_mod.path(torch.zeros(70, 100, dtype=bf), torch.zeros(100, 65, dtype=bf)) == "wmma"
    assert mm_mod.path(act, torch.zeros(2048, 100, dtype=bf)) == "wmma"  # b's pitch
    assert mm_mod.path(torch.zeros(4, 2048), w.float()) == "fma"
    assert mm_mod.path(act.float().T, torch.zeros(512, 7)) == "fma"


@pytest.mark.parametrize("case", FA_CASES + FA_CROSS_CASES, ids=lambda c: c[0])
def test_flash_attention_ref_matches_jax(jax_refs, case):
    name, *_, causal, window, qo, kl = case
    q, k, v = (torch.from_numpy(x) for x in _fa_inputs(case))
    out, lse = flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=_lanes(qo), kv_len=_lanes(kl))
    kern, oracle = jax_refs["fa"][name]
    np.testing.assert_allclose(out.numpy(), kern, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), oracle, atol=ATOL)

    # lse: log-sum-exp of each row's visible scaled scores; ~NEG_INF when none
    b, sq, h, hd = q.shape
    n_rep = h // k.shape[2]
    qo_b = np.repeat(np.asarray(qo if qo is not None else [0]), b // len(qo or [0]))
    kl_b = np.repeat(np.asarray(kl if kl is not None else [k.shape[1]]),
                     b // len(kl or [0]))
    s = np.einsum("bqhd,bkhd->bhqk", q.numpy(),
                  np.repeat(k.numpy(), n_rep, axis=2)) / math.sqrt(hd)
    qp = qo_b[:, None, None, None] + np.arange(sq)[None, None, :, None]
    kp = np.arange(k.shape[1])[None, None, None, :]
    ok = kp < kl_b[:, None, None, None]
    if causal:
        ok = ok & (kp <= qp)
    if window > 0:
        ok = ok & (kp > qp - window)
    ok = np.broadcast_to(ok, s.shape)
    want = np.where(ok.any(-1), np.log(np.where(ok, np.exp(s), 0).sum(-1).clip(1e-30)), -1e30)
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-4, rtol=1e-5)


def test_flash_attention_zero_rows_are_exact():
    """A kv_len == 0 lane and a fully masked row give exact zeros."""
    for case in FA_CASES[4:]:
        _, b, sq, sk, h, kvh, hd, causal, window, qo, kl = case
        q, k, v = (torch.from_numpy(x) for x in _fa_inputs(case))
        out, _ = flash_attention(q, k, v, causal=causal, window=window,
                                 q_offset=_lanes(qo), kv_len=_lanes(kl))
        dead = [i for i in range(b)
                if kl[i] == 0 or qo[i] - window + 1 >= kl[i] and window > 0]
        assert dead and all(torch.count_nonzero(out[i]) == 0 for i in dead)


@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: c[0])
def test_flash_attention_bwd_matches_jax_vjp(jax_refs, case):
    """K3's plain version, and FlashAttention's backward through it, against
    the JAX kernels' VJP (interpret mode): dk/dv at the native kv heads, a
    kv_len 0 lane with exact zero grads."""
    name, b, sq, sk, h, kvh, hd, causal, window, qo, kl = case
    q, k, v, g = (torch.from_numpy(x) for x in _bwd_inputs(case))
    kw = dict(causal=causal, window=window, q_offset=_lanes(qo), kv_len=_lanes(kl))
    want = jax_refs["bwd"][name]

    out, lse = flash_attention_ref(q, k, v, **kw)
    plain = flash_attention_bwd_ref(q, k, v, out, lse, g, **kw)
    wrapped = flash_attention_bwd(q, k, v, out, lse, g, **kw)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    FlashAttention.apply(*leaves, kw["q_offset"], kw["kv_len"], causal, window).backward(g)
    for got in (plain, wrapped, [x.grad for x in leaves]):
        assert got[1].shape == k.shape and got[2].shape == v.shape
        for d, w, which in zip(got, want, ("dq", "dk", "dv")):
            np.testing.assert_allclose(d.numpy(), w, atol=BWD_ATOL, err_msg=which)
    if kl is not None:
        for row in (i for i, n in enumerate(kl) if n == 0):
            assert all(torch.count_nonzero(d[row]) == 0 for d in plain)


@pytest.mark.parametrize("case", MM_BWD_CASES, ids=lambda c: "x".join(map(str, c[:3]))
                         + ("_bT" if c[3] else ""))
def test_matmul_backward_matches_jax_vjp(jax_refs, case):
    """``matmul``'s backward (dA = g bᵀ, dB = aᵀ g through the wrapper)
    against the JAX classical matmul's custom VJP; b may be the transposed
    view of a table, as in the tied logits."""
    trans = case[3]
    a, b, g = (torch.from_numpy(x) for x in _mm_bwd_inputs(case))
    a.requires_grad_()
    b.requires_grad_()
    out = matmul(a, b.T if trans else b)
    out.backward(g)
    want_a, want_b = jax_refs["mm_bwd"][case]
    np.testing.assert_allclose(a.grad.numpy(), want_a, atol=BWD_ATOL)
    np.testing.assert_allclose(b.grad.numpy(), want_b, atol=BWD_ATOL)


def test_matmul_wrapper_cpu_transposed_a():
    """The wrapper takes A as the transposed view of a row-major matrix."""
    r = _rng(2)
    act = torch.from_numpy(r.standard_normal((9, 6)).astype(np.float32))
    g = torch.from_numpy(r.standard_normal((9, 5)).astype(np.float32))
    torch.testing.assert_close(hbp_matmul(act.T, g), act.T @ g, atol=ATOL, rtol=1e-5)


def test_wrappers_reject_bad_inputs():
    q = torch.zeros(2, 4, 4, 16)
    k = torch.zeros(2, 4, 3, 16)  # 3 kv heads do not divide 4
    with pytest.raises(ValueError):
        flash_attention(q, k, k)
    with pytest.raises(TypeError):
        flash_attention(q, q, q, kv_len=torch.tensor([1, 2]))  # int64 lanes
    with pytest.raises(ValueError):
        flash_attention(q, q, q, kv_len=torch.tensor([1, 2, 3], dtype=torch.int32))
    with pytest.raises(TypeError):
        hbp_matmul(torch.zeros(2, 3), torch.zeros(3, 2, dtype=torch.float64))
    with pytest.raises(ValueError):  # operands on two devices
        hbp_matmul(torch.zeros(2, 3, device="meta"), torch.zeros(3, 2))
    # a meta tensor gets the kernel's output shape alone (the dry run's trace)
    got = hbp_matmul(torch.zeros(2, 3, device="meta"), torch.zeros(3, 2, device="meta"))
    assert got.device.type == "meta" and got.shape == (2, 2)
    out, lse = flash_attention(q, q, q)
    with pytest.raises(ValueError):  # lse of the wrong shape
        flash_attention_bwd(q, q, q, out, lse[:, :2], out)


def test_library_path_hashes_shared_headers(tmp_path, monkeypatch):
    """Editing a shared ``csrc/*.cuh`` header moves every library's path, so
    a stale build is never loaded; nothing is built (a copy of ``csrc``)."""
    import shutil

    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "csrc has no shared header"
    before = {name: _build.library_path(name) for name in _build.sources()}
    assert before["flash_attention"] == _build.library_path("flash_attention")
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.sources()}
    assert all(after[n] != before[n] for n in before)
    (csrc / "bp_scan.cu").write_text((csrc / "bp_scan.cu").read_text() + "\n")
    assert _build.library_path("bp_scan") != after["bp_scan"]
    assert _build.library_path("flash_attention") == after["flash_attention"]
    assert not _build.BUILD_DIR.joinpath(after["flash_attention"].name).exists()


def test_tensor_core_layout_rule():
    """The bf16 mma instances take a pointer aligned to 16 bytes and
    (batch, seq, head) strides of whole 16-byte steps; K1 and K3 pick them
    for bf16 (decode too), never for f32 or K1q."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    q = torch.zeros(2, 8, 4, 64, dtype=torch.bfloat16)
    assert fa._tensor_core_layout(q)
    assert fa._tensor_core_layout(q[:, 2:])  # a later row: 2 * 4 * 64 elements on
    assert not fa._tensor_core_layout(torch.zeros(2, 8, 4, 65, dtype=torch.bfloat16)[..., :64])
    flat = torch.zeros(2 * 8 * 4 * 64 + 4, dtype=torch.bfloat16)
    assert not fa._tensor_core_layout(flat[4:].view(2, 8, 4, 64))  # 8 bytes off
    assert fa._tensor_core_layout(torch.zeros(2, 8, 4, 64)[..., :60])  # f32: 4-element steps
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._require_tensor_core_layout("k1", q=flat[4:].view(2, 8, 4, 64))
    assert fa.fwd_path(q) == "mma" and fa.bwd_path(q) == "mma"
    assert fa.fwd_path(q[:, :1]) == "mma"
    assert fa.fwd_path(q.float()) == "fma" and fa.bwd_path(q.float()) == "fma"


def test_int8_cache_takes_the_tensor_cores():
    """K1q's instance follows q alone: bf16 q over an int8 cache runs the
    mma instance (decode and chunks), f32 q the FMA template.  The layout
    rule on int8 k/v asks for 16-element steps (16 bytes)."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    cache = torch.zeros(8, 512, 8, 128, dtype=torch.int8)
    for sq in (1, 64):
        q = torch.zeros(8, sq, 16, 128, dtype=torch.bfloat16)
        assert fa.fwd_path(q) == "mma" and fa.fwd_path(q.float()) == "fma"
    assert fa._tensor_core_layout(cache) and fa._tensor_core_layout(cache[:, :77])
    assert fa._tensor_core_layout(torch.zeros(3, 16, 2, 16, dtype=torch.int8))
    # a head stride of 24 int8 (not a 16-byte step), and 8 bytes off
    assert not fa._tensor_core_layout(torch.zeros(2, 8, 2, 24, dtype=torch.int8)[..., :16])
    flat = torch.zeros(2 * 8 * 2 * 16 + 8, dtype=torch.int8)
    assert not fa._tensor_core_layout(flat[8:].view(2, 8, 2, 16))
    with pytest.raises(ValueError, match="multiples of 16 elements"):
        fa._require_tensor_core_layout("k1q", k=torch.zeros(2, 8, 2, 24, dtype=torch.int8)[..., :16])


@pytest.mark.parametrize("b,sq,h,kvh,sk,sms,want", [
    (8, 1, 16, 8, 512, 132, 2),    # the engine's decode: 64 blocks on 132 SMs
    (8, 64, 16, 8, 512, 132, 1),   # its 64-row chunks: 128 blocks
    (4, 1, 16, 8, 256, 132, 4),    # the lockstep decode: 32 blocks
    (1, 1, 16, 8, 512, 132, 8),    # at most 8 blocks a cluster
    (1, 1, 16, 8, 128, 132, 2),    # no more than the cache's 64-key tiles
    (3, 1, 4, 2, 16, 132, 1),      # a single tile
    (8, 1, 16, 8, 512, 100, 1),    # fewer SMs than a doubled grid
])
def test_kv_splits_plan(b, sq, h, kvh, sk, sms, want):
    """K1q's cluster split doubles while the split grid fits the SMs once,
    up to 8 and to the cache's 64-key tiles."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    assert fa.kv_splits(b, sq, h, kvh, sk, sms, 64) == want


@pytest.mark.parametrize("b,sq,h,kvh,sk,sms,want", [
    (8, 1, 4, 1, 2048, 132, 8),    # gemma3-1b's engine decode: 8 blocks on 132 SMs
    (8, 64, 4, 1, 2048, 132, 4),   # its 64-row chunks: 32 blocks
    (1, 1, 4, 1, 64, 132, 2),      # two 32-key tiles (one 64-key tile at hd 128)
    (8, 1, 4, 1, 2048, 60, 4),     # 8 x 8 blocks would not fit 60 SMs
])
def test_kv_splits_plan_hd256(b, sq, h, kvh, sk, sms, want):
    """At hd 256 the plan counts the kernel's 32-key tiles
    (``test_mma_kv_tile_from_the_kernel`` reads them from the kernel)."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    assert fa.kv_splits(b, sq, h, kvh, sk, sms, 32) == want
    assert fa.kv_splits(1, 1, 4, 1, 64, 132, 64) == 1


# (dtype, (m, n), bt, the instance): 16-byte pitches and tile edges take vec
TRANSPOSE_PATHS = [
    *[(dt, (96, 160), 32, "vec") for dt in ("int8", "bfloat16", "float32", "float64")],
    *[(dt, (64, 99), 128, "scalar") for dt in ("int8", "bfloat16", "float32", "float64")],
    *[(dt, (1000, 24), 8, want) for dt, want in (("int8", "scalar"), ("bfloat16", "vec"),
                                                 ("float32", "vec"), ("float64", "vec"))],
    ("int8", (96, 160), 8, "scalar"),     # a tile edge of 8 bytes
    ("bfloat16", (100, 160), 20, "scalar"),  # 100 rows: an output pitch of 200 bytes
    ("float64", (6, 10), 2, "vec"),
    ("float32", (8192, 8192), None, "vec"),  # the planner's tile
]


@pytest.mark.parametrize("case", TRANSPOSE_PATHS, ids=lambda c: f"{c[0]}_{c[1][0]}x{c[1][1]}_{c[2]}")
def test_transpose_path_rule(case):
    """bi_transpose.path names vec where the pointer, both row pitches and
    both tile edges are whole 16-byte steps, scalar elsewhere, by layout
    alone; a view 1 element off 16 bytes takes scalar; the sub-tile edge
    follows the instance."""
    k6 = importlib.import_module("repro_torch.kernels.bi_transpose")
    dt, (m, n), bt, want = case
    x = torch.zeros(m, n, dtype=getattr(torch, dt))
    assert k6.path(x, bt) == want
    flat = torch.zeros(m * n + 1, dtype=x.dtype)
    assert k6.path(flat[1:].view(m, n), bt) == "scalar"
    size = x.element_size()
    assert k6.tile("vec", size) == 16 * 16 // size
    assert k6.tile("scalar", size) == (32 if size >= 4 else 64)


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,trans", [(4, 256, 384, False), (70, 100, 65, True),
                                         (256, 512, 128, False)])
def test_matmul_kernel_matches_plain(cuda, dtype, m, k, n, trans):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(m, k, device=cuda, generator=g).to(dt)
    b = (torch.randn(n, k, device=cuda, generator=g) / math.sqrt(k)).to(dt)
    b = b.T if trans else b.T.contiguous()
    got = hbp_matmul(a, b).float()
    want = matmul_ref(a, b).float()
    tol = 1e-4 if dt == torch.float32 else 2 ** -7
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


# cases at the bf16 tensor-core kernels' tile edges (64-key K/V tiles, 16-row
# query warps, 16-key dk/dv blocks): (name, b, sq, sk, h, kvh, hd, causal,
# window, q_offset, kv_len)
EDGE_CASES = [
    *[(f"gqa_16_8_hd{hd}_sq{sq}", 2, sq, sq, 16, 8, hd, True, 0, None, None)
      for hd in (64, 128) for sq in (57, 65, 129)],
    ("noncausal_hd64_sq65", 1, 65, 65, 4, 2, 64, False, 0, None, None),
    ("window_40_across_tiles_hd128", 2, 129, 129, 16, 8, 128, True, 40, None, None),
    ("chunk_64_vs_512_lanes_hd128", 4, 64, 512, 16, 8, 128, True, 0,
     [0, 100, 448, 0], [64, 164, 512, 0]),
    ("decode_vs_512_lanes_hd128", 4, 1, 512, 16, 8, 128, True, 0,
     [0, 100, 511, 7], [1, 101, 512, 0]),
    # hd 256 (32-key K/V tiles, column-sliced backward), gemma3-1b's GQA
    # 4:1 and 512-key window over a 2048-position cache
    *[(f"gqa_4_1_hd256_sq{sq}", 2, sq, sq, 4, 1, 256, True, 0, None, None)
      for sq in (57, 65, 129)],
    ("window_40_across_tiles_hd256", 2, 129, 129, 4, 1, 256, True, 40, None, None),
    ("chunk_64_vs_2048_lanes_window_hd256", 4, 64, 2048, 4, 1, 256, True, 512,
     [0, 900, 1984, 0], [64, 964, 2048, 0]),
    ("decode_vs_2048_lanes_window_hd256", 4, 1, 2048, 4, 1, 256, True, 512,
     [0, 700, 2047, 7], [1, 701, 2048, 0]),
]

# cross-attention, non-causal with sq != sk and no lanes: llama-3.2-vision-90b's
# 64/8 heads at hd 128 over 1601 image tokens (25 tiles of 64 keys and one
# key; decode, a chunk, the engine's 8 x 256 first chunk, the Server's 4 x 512
# prefill), seamless-m4t-large-v2's 16/16 heads at hd 64 over 512 encoder
# frames (and the encoder's own 512 x 512), and 17 keys, below one tile
CROSS_CASES = [
    ("cross_decode_8x1_vs_1601_hd128", 8, 1, 1601, 64, 8, 128, False, 0, None, None),
    ("cross_chunk_2x64_vs_1601_hd128", 2, 64, 1601, 64, 8, 128, False, 0, None, None),
    ("cross_chunk_8x256_vs_1601_hd128", 8, 256, 1601, 64, 8, 128, False, 0, None, None),
    ("cross_prefill_4x512_vs_1601_hd128", 4, 512, 1601, 64, 8, 128, False, 0, None, None),
    ("cross_decode_8x1_vs_512_hd64", 8, 1, 512, 16, 16, 64, False, 0, None, None),
    ("cross_chunk_4x64_vs_512_hd64", 4, 64, 512, 16, 16, 64, False, 0, None, None),
    ("encoder_8x512_hd64", 8, 512, 512, 16, 16, 64, False, 0, None, None),
    ("cross_chunk_2x33_vs_17_hd64", 2, 33, 17, 16, 16, 64, False, 0, None, None),
]
# K3 non-causal: the encoder-decoder's training (decoder cross-attention of
# 1024 queries over 256 frames, the encoder's 256 x 256), the VLM's 1601
# image keys at hd 128, and keys ending one into a tile (65)
CROSS_BWD_CASES = [
    ("cross_bwd_2x1024_vs_256_hd64", 2, 1024, 256, 16, 16, 64, False, 0, None, None),
    ("encoder_bwd_2x256_hd64", 2, 256, 256, 16, 16, 64, False, 0, None, None),
    ("cross_bwd_1x64_vs_1601_hd128", 1, 64, 1601, 64, 8, 128, False, 0, None, None),
    ("cross_bwd_2x100_vs_65_hd64", 2, 100, 65, 16, 16, 64, False, 0, None, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_CASES + FA_CROSS_CASES + EDGE_CASES + CROSS_CASES,
                         ids=lambda c: c[0])
def test_flash_kernel_matches_plain(cuda, dtype, case):
    """K1 against its plain version on the card; a kv_len 0 lane gives exact
    zeros."""
    name, *_, causal, window, qo, kl = case
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(cuda, dt) for x in _fa_inputs(case))
    kw = dict(causal=causal, window=window, q_offset=_lanes(qo, cuda), kv_len=_lanes(kl, cuda))
    out, lse = flash_attention(q, k, v, **kw)
    ref_out, ref_lse = flash_attention_ref(q, k, v, **kw)
    tol = ATOL if dt == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-5)
    assert all(torch.count_nonzero(out[i]) == 0 for i, n in enumerate(kl or []) if n == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_CASES[:3] + BWD_CASES + [c for c in EDGE_CASES if c[2] > 1]
                         + CROSS_BWD_CASES, ids=lambda c: c[0])
def test_flash_bwd_kernel_matches_plain(cuda, dtype, case):
    """K3 against its plain version on the card; a kv_len 0 lane gives exact
    zeros."""
    name, *_, causal, window, qo, kl = case
    dt = getattr(torch, dtype)
    q, k, v, g = (torch.from_numpy(x).to(cuda, dt) for x in _bwd_inputs(case))
    kw = dict(causal=causal, window=window, q_offset=_lanes(qo, cuda), kv_len=_lanes(kl, cuda))
    out, lse = flash_attention(q, k, v, **kw)
    got = flash_attention_bwd(q, k, v, out, lse, g, **kw)
    want = flash_attention_bwd_ref(q, k, v, out, lse, g, **kw)
    tol = BWD_ATOL if dt == torch.float32 else 3e-2
    for d, w in zip(got, want):
        torch.testing.assert_close(d.float(), w.float(), atol=tol, rtol=tol)
    if kl is not None:
        for row in (i for i, n in enumerate(kl) if n == 0):
            assert all(torch.count_nonzero(d[row]) == 0 for d in got)


@pytest.mark.cuda
def test_flash_bwd_kernel_is_deterministic(cuda):
    """Two K3 calls on the same inputs give the same bits (one writer per
    element, a fixed order for the dk/dv warps' partial sums)."""
    case = EDGE_CASES[5]  # hd 128, sq 129, GQA 16/8
    _, *_, causal, window, qo, kl = case
    q, k, v, g = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in _bwd_inputs(case))
    out, lse = flash_attention(q, k, v, causal=causal)
    first = flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
    second = flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_flash_bwd_kernel_is_deterministic_hd256(cuda):
    """The same at hd 256, where two blocks share each row's dq and each
    key tile's dk/dv by column halves."""
    case = next(c for c in EDGE_CASES if c[0] == "window_40_across_tiles_hd256")
    _, *_, causal, window, qo, kl = case
    q, k, v, g = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in _bwd_inputs(case))
    out, lse = flash_attention(q, k, v, causal=causal, window=window)
    first = flash_attention_bwd(q, k, v, out, lse, g, causal=causal, window=window)
    second = flash_attention_bwd(q, k, v, out, lse, g, causal=causal, window=window)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_flash_bwd_reads_out_and_grad_through_strides(cuda):
    """The bf16 K3 forms delta from O and dO read through their strides: a
    padded (b, s, h, hd + 8) view and a transposed-layout gradient give the
    contiguous call's bits."""
    case = EDGE_CASES[1]  # hd 64, sq 65
    q, k, v, g = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in _bwd_inputs(case))
    out, lse = flash_attention(q, k, v)
    b, sq, h, hd = q.shape
    padded = torch.zeros(b, sq, h, hd + 8, dtype=q.dtype, device=cuda)[..., :hd]
    padded.copy_(out)
    g_t = g.transpose(1, 2).contiguous().transpose(1, 2)  # (b, sq, h, hd) view of (b, h, sq, hd)
    want = flash_attention_bwd(q, k, v, out, lse, g)
    got = flash_attention_bwd(q, k, v, padded, lse, g_t)
    assert all(torch.equal(a, w) for a, w in zip(got, want))


@pytest.mark.cuda
def test_flash_kernels_reject_misaligned_bf16(cuda):
    """The tensor-core instances raise on a head stride that is not a whole
    number of 16-byte steps, forward and backward; the f32 instance takes
    it."""
    wide = torch.randn(2, 32, 4, 65, device=cuda)
    q, q32 = wide.bfloat16()[..., :64], wide[..., :64]  # head stride 65
    k = torch.randn(2, 32, 2, 64, device=cuda)
    kb = k.bfloat16()
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, kb, kb)
    out, lse = flash_attention(q.contiguous(), kb, kb)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_bwd(q, kb, kb, out, lse, out)
    out32, _ = flash_attention(q32, k, k)
    torch.testing.assert_close(out32, flash_attention_ref(q32, k, k)[0], atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,trans_b", [(96, 70, 65, False), (256, 512, 128, True)])
def test_matmul_kernel_transposed_a_matches_plain(cuda, dtype, m, k, n, trans_b):
    """K2 with A read as the transposed view of a row-major (k, m) matrix,
    the backward's aᵀ g."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(1)
    act = torch.randn(k, m, device=cuda, generator=gen).to(dt)
    b = (torch.randn(n, k, device=cuda, generator=gen) / math.sqrt(k)).to(dt)
    b = b.T if trans_b else b.T.contiguous()
    got = hbp_matmul(act.T, b).float()
    want = matmul_ref(act.T, b).float()
    tol = 1e-4 if dt == torch.float32 else 2 ** -7
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


# K2's instances at their edges.  Each operand is a view of a matrix stored
# with a row pitch rounded up to 8 elements (so TMA can describe it) whose
# padding holds NaN: a kernel that reads past a ragged edge poisons its
# output.  layout (trans_a, trans_b): A stored (k, m) and B stored (n, k).
MM_LAYOUTS = [(False, False), (False, True), (True, False), (True, True)]
MM_EDGE_M = [1, 4, 8, 16, 17, 64, 65, 129, 512]
MM_MODES = {"bf16": (torch.bfloat16, None), "bf16_to_f32": (torch.bfloat16, torch.float32),
            "f32": (torch.float32, None)}


def _padded_operand(rows, cols, trans, dtype, device, gen, scale=1.0):
    """A (rows, cols) operand: a row-major matrix, or with ``trans`` the
    transposed view of a row-major (cols, rows) one, in storage whose rows
    are padded to a multiple of 8 elements and filled with NaN."""
    r, c = (cols, rows) if trans else (rows, cols)
    store = torch.full((r, -(-c // 8) * 8), float("nan"), dtype=dtype, device=device)
    view = store[:, :c]
    view.copy_(scale * torch.randn(r, c, device=device, generator=gen))
    return view.T if trans else view


def _mm_tol(dtype, out_dtype):
    return 2 ** -7 if (out_dtype or dtype) == torch.bfloat16 else 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MM_MODES))
@pytest.mark.parametrize("layout", MM_LAYOUTS, ids=lambda t: "AT%d_BT%d" % t)
@pytest.mark.parametrize("m", MM_EDGE_M)
def test_matmul_instances_at_edges(cuda, m, layout, mode):
    """Every instance against the plain version at ragged M, N and K (65,
    100, 2056), in all four layouts, with bf16, bf16 -> f32 and f32."""
    dtype, out_dtype = MM_MODES[mode]
    gen = torch.Generator(device=cuda).manual_seed(m)
    for n, k in ((65, 100), (100, 2056)):
        a = _padded_operand(m, k, layout[0], dtype, cuda, gen)
        b = _padded_operand(k, n, layout[1], dtype, cuda, gen, scale=k ** -0.5)
        inst = mm_mod.path(a, b)
        want_inst = ("fma" if dtype == torch.float32 else
                     "stream" if m <= 16 and not layout[0] else "wgmma")
        assert inst == want_inst
        got = hbp_matmul(a, b, out_dtype=out_dtype)
        assert got.dtype == (out_dtype or dtype) and got.shape == (m, n)
        tol = _mm_tol(dtype, out_dtype)
        torch.testing.assert_close(got.float(), matmul_ref(a, b, out_dtype).float(),
                                   atol=tol, rtol=tol, msg=f"{inst} n={n} k={k}")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", MM_LAYOUTS, ids=lambda t: "AT%d_BT%d" % t)
@pytest.mark.parametrize("m,n,k,bn", [(512, 2048, 2048, 64), (2048, 1024, 512, 128),
                                      (512, 6144, 2048, 192), (2048, 2048, 512, 256)])
def test_matmul_wgmma_widths(cuda, m, n, k, bn, layout):
    """Each wgmma tile width at a training shape that the plan gives it."""
    gen = torch.Generator(device=cuda).manual_seed(bn)
    a = _padded_operand(m, k, layout[0], torch.bfloat16, cuda, gen)
    b = _padded_operand(k, n, layout[1], torch.bfloat16, cuda, gen, scale=k ** -0.5)
    assert mm_mod.path(a, b) == "wgmma"
    assert mm_mod.plan(m, n, k, "wgmma", mm_mod._sm_count(cuda.index or 0)).tile_n == bn
    torch.testing.assert_close(hbp_matmul(a, b).float(), matmul_ref(a, b).float(),
                               atol=2 ** -7, rtol=2 ** -7)


# (label, m, n, k, dtype): split-K active in each instance that has it
MM_SPLIT_CASES = [("wgmma", 128, 256, 16384, torch.bfloat16),
                  ("stream", 8, 2048, 2048, torch.bfloat16),
                  ("fma", 4, 512, 4096, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MM_SPLIT_CASES, ids=lambda c: c[0])
def test_matmul_split_k_is_deterministic(cuda, case):
    """Two calls on the same inputs give the same bits with split-K on
    (the splits are summed in a fixed order, no atomics)."""
    inst, m, n, k, dtype = case
    gen = torch.Generator(device=cuda).manual_seed(3)
    a = torch.randn(m, k, device=cuda, generator=gen).to(dtype)
    b = (torch.randn(k, n, device=cuda, generator=gen) / math.sqrt(k)).to(dtype)
    assert mm_mod.path(a, b) == inst
    assert mm_mod.plan(m, n, k, inst, mm_mod._sm_count(cuda.index or 0)).splits > 1
    first, second = hbp_matmul(a, b), hbp_matmul(a, b)
    assert torch.equal(first, second)
    tol = _mm_tol(dtype, None)
    torch.testing.assert_close(first.float(), matmul_ref(a, b).float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [("wgmma", 512, 2048), ("stream", 8, 2048),
                                  ("wmma", 70, 100), ("fma", 64, 256)], ids=lambda c: c[0])
def test_matmul_graph_replay_matches_eager(cuda, case):
    """A K2 call captured in a CUDA graph and replayed gives the eager
    call's bits (the tensor maps and launch parameters are captured by
    value)."""
    inst, m, k = case
    dtype = torch.float32 if inst == "fma" else torch.bfloat16
    gen = torch.Generator(device=cuda).manual_seed(4)
    a = torch.randn(m, k, device=cuda, generator=gen).to(dtype)
    b = torch.randn(k, 1000, device=cuda, generator=gen).to(dtype)
    assert mm_mod.path(a, b) == inst  # wmma: a's row pitch, 100 elements
    eager = hbp_matmul(a, b)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = hbp_matmul(a, b)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_ragged_vocab_head(cuda, dtype):
    """seamless-m4t-large-v2's untied head, 256,206 columns (not a multiple
    of 8): the logits through the transposed ``lm_head`` view at 8 rows
    (bf16: ``stream``), 512 and 2048 (``wgmma``), whose output rows are no
    whole 16-byte steps, and both backward products of a 512-row logits
    chunk and of a training step's 4 x 512-row chunk, whose gradient TMA
    cannot describe (bf16: ``wmma``), against the plain version.  The
    gradient is drawn N(0, 1/64), so the products' entries are ~1.3
    (``dA``) and ~3-6 (``dB``) and the tolerance's atol is under 1% of a
    typical entry."""
    dt = getattr(torch, dtype)
    vocab, d = 256206, 1024
    gen = torch.Generator(device=cuda).manual_seed(5)
    head = (0.02 * torch.randn(vocab, d, device=cuda, generator=gen)).to(dt)
    tol = _mm_tol(dt, None)
    bf = dt == torch.bfloat16
    for rows, inst in ((8, "stream"), (512, "wgmma"), (2048, "wgmma")):
        h = torch.randn(rows, d, device=cuda, generator=gen).to(dt)
        assert mm_mod.path(h, head.T) == (inst if bf else "fma")
        torch.testing.assert_close(hbp_matmul(h, head.T).float(),
                                   matmul_ref(h, head.T).float(), atol=tol, rtol=tol)
        if rows == 8:
            continue
        g = (torch.randn(rows, vocab, device=cuda, generator=gen) / 8).to(dt)
        for a, b in ((g, head), (h.T, g)):  # dA = g W, dB = hᵀ g
            assert mm_mod.path(a, b) == ("wmma" if bf else "fma")
            before = hbp_matmul.wmma_launches
            got = hbp_matmul(a, b)
            assert hbp_matmul.wmma_launches == before + bf
            torch.testing.assert_close(got.float(), matmul_ref(a, b).float(), atol=tol, rtol=tol)


# -- K1q: attention over an int8 KV cache --------------------------------------

# (name, b, sq, sk, h, kvh, hd, causal, window, q_offset, kv_len)
Q8_CASES = [
    ("decode_rows_zero_lane", 3, 1, 16, 4, 2, 16, True, 0, [9, 3, 0], [10, 4, 0]),
    ("chunk_rows", 2, 4, 16, 4, 2, 16, True, 0, [4, 8], [8, 12]),
    ("decode_window", 2, 1, 16, 4, 2, 16, True, 3, [12, 5], [13, 6]),
    ("chunk_rows_window_hd256", 2, 24, 96, 4, 1, 256, True, 16, [72, 0], [96, 0]),
    ("decode_window_hd256", 3, 1, 96, 4, 1, 256, True, 16, [95, 40, 7], [96, 41, 0]),
]


def _q8_inputs(case, seed=11):
    """q f32, k/v int8 over the whole range, f32 (b, kvh) scales."""
    _, b, sq, sk, h, kvh, hd, *_ = case
    r = _rng(seed)
    q = r.standard_normal((b, sq, h, hd)).astype(np.float32)
    k, v = (r.integers(-127, 128, (b, sk, kvh, hd)).astype(np.int8) for _ in "kv")
    ks, vs = (r.uniform(0.005, 0.05, (b, kvh)).astype(np.float32) for _ in "kv")
    return q, k, v, ks, vs


@pytest.fixture(scope="module")
def jax_q8_refs():
    """The JAX kernel's quantized path (interpret mode) and its oracle on
    every K1q case, computed once."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import ref
    from repro.kernels.flash_attention import flash_attention as jax_fa

    out = {}
    for case in Q8_CASES:
        name, b, sq, sk, h, kvh, hd, causal, window, qo, kl = case
        q, k, v, ks, vs = _q8_inputs(case)
        kw = dict(causal=causal, window=window, q_offset=np.asarray(qo, np.int32),
                  kv_len=np.asarray(kl, np.int32), n_heads=h,
                  k_scale=jnp.asarray(ks.reshape(-1)), v_scale=jnp.asarray(vs.reshape(-1)))
        fq, fk, fv = (jnp.asarray(_fold(x)) for x in (q, k, v))
        out[name] = (_unfold(np.asarray(jax_fa(fq, fk, fv, interpret=True, **kw)), b),
                     _unfold(np.asarray(ref.flash_attention_ref(fq, fk, fv, **kw)), b))
    return out


@pytest.mark.parametrize("case", Q8_CASES, ids=lambda c: c[0])
def test_flash_attention_int8_ref_matches_jax(jax_q8_refs, case):
    """K1q's plain version (and both wrappers, which take it on the CPU)
    against the JAX quantized kernel in interpret mode and the JAX oracle:
    per-row lanes, a kv_len 0 lane with exact zeros."""
    name, b, sq, sk, h, kvh, hd, causal, window, qo, kl = case
    q, k, v, ks, vs = (torch.from_numpy(x) for x in _q8_inputs(case))
    kw = dict(causal=causal, window=window, q_offset=_lanes(qo), kv_len=_lanes(kl))
    plain, _ = flash_attention_ref(q, k, v, k_scale=ks, v_scale=vs, **kw)
    via_k1, _ = flash_attention(q, k, v, k_scale=ks, v_scale=vs, **kw)
    via_k1q, _ = flash_attention_int8(q, k, v, ks, vs, **kw)
    kern, oracle = jax_q8_refs[name]
    for got in (plain, via_k1, via_k1q):
        np.testing.assert_allclose(got.numpy(), kern, atol=ATOL)
        np.testing.assert_allclose(got.numpy(), oracle, atol=ATOL)
    for row in (i for i, n in enumerate(kl) if n == 0):
        assert torch.count_nonzero(plain[row]) == 0


def test_flash_attention_int8_rejects_unpaired_scales():
    q = torch.zeros(2, 1, 4, 16)
    k8 = torch.zeros(2, 8, 2, 16, dtype=torch.int8)
    s = torch.ones(2, 2)
    with pytest.raises(ValueError):  # one scale
        flash_attention(q, k8, k8, k_scale=s)
    with pytest.raises(TypeError):  # int8 without scales
        flash_attention(q, k8, k8)
    with pytest.raises(TypeError):  # scales with non-int8 k/v
        flash_attention(q, k8.float(), k8.float(), k_scale=s, v_scale=s)
    with pytest.raises(ValueError):  # K1q's own wrapper needs both
        flash_attention_int8(q, k8, k8, s, None)
    with pytest.raises(ValueError):  # scales of the wrong shape
        flash_attention_int8(q, k8, k8, torch.ones(2), torch.ones(2))


def test_kv_scale_and_quantize_kv_bit_equal_to_jax():
    """The int8 cache's scale and quantizer, on the same f32 input, give the
    same bits as JAX's: whole-slab, scalar and per-row valid counts (a 0
    row), and ties at .5 rounding half to even (an absmax of 127 makes the
    scale exactly 1)."""
    import jax.numpy as jnp

    from repro.models import common as jax_common
    from repro_torch.models import common as pt_common

    r = _rng(13)
    x = (4 * r.standard_normal((3, 6, 2, 8))).astype(np.float32)
    ties = np.zeros((2, 4, 2, 8), np.float32)
    ties[:, 0, :, 0] = 127.0
    ties[:, 1, :, :6] = [0.5, 1.5, 2.5, -0.5, -2.5, 126.5]
    ties[:, 2, :, :3] = [-126.5, 3.5, -3.5]
    for arr, valids in ((x, (None, 4, np.asarray([6, 0, 2], np.int32))), (ties, (None,))):
        for valid in valids:
            want_s = np.asarray(jax_common.kv_scale(jnp.asarray(arr), valid))
            got_s = pt_common.kv_scale(torch.from_numpy(arr), None if valid is None
                                       else torch.as_tensor(valid))
            np.testing.assert_array_equal(got_s.numpy().view(np.int32), want_s.view(np.int32))
            want_q = np.asarray(jax_common.quantize_kv(jnp.asarray(arr), jnp.asarray(want_s)))
            got_q = pt_common.quantize_kv(torch.from_numpy(arr), got_s)
            assert got_q.dtype == torch.int8
            np.testing.assert_array_equal(got_q.numpy(), want_q)
    q = pt_common.quantize_kv(torch.from_numpy(ties), torch.ones(2, 2))
    assert q[0, 1, 0, :6].tolist() == [0, 2, 2, 0, -2, 126]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", Q8_CASES, ids=lambda c: c[0])
def test_flash_int8_kernel_matches_plain(cuda, dtype, case):
    """K1q against its plain version on the card; a kv_len 0 lane gives
    exact zeros and the launch is counted as K1q's, not K1's."""
    name, *_, causal, window, qo, kl = case
    dt = getattr(torch, dtype)
    q, k, v, ks, vs = (torch.from_numpy(x).to(cuda) for x in _q8_inputs(case))
    q = q.to(dt)
    kw = dict(causal=causal, window=window, q_offset=_lanes(qo, cuda), kv_len=_lanes(kl, cuda))
    k1, k1q = flash_attention.launches, flash_attention_int8.launches
    out, lse = flash_attention(q, k, v, k_scale=ks, v_scale=vs, **kw)
    assert (flash_attention.launches, flash_attention_int8.launches) == (k1, k1q + 1)
    ref_out, ref_lse = flash_attention_ref(q, k, v, k_scale=ks, v_scale=vs, **kw)
    tol = ATOL if dt == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-5)
    for row in (i for i, n in enumerate(kl) if n == 0):
        assert torch.count_nonzero(out[row]) == 0


@pytest.mark.cuda
def test_mma_kv_tile_from_the_kernel(cuda):
    """K1q's cluster plan reads the K/V tile from the built kernel: 64 keys,
    and 32 at hd 256 (the tiles ``test_kv_splits_plan*`` plan with)."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    assert {hd: fa.mma_kv_tile(hd) for hd in fa.HEAD_DIMS} == {16: 64, 32: 64, 64: 64,
                                                                128: 64, 256: 32}
    assert fa.mma_kv_tile(48) == 0


# the engine's shapes (qwen3-1.7b: 8 slots, 16 query heads over 8 KV heads,
# hd 128, a 512-position cache): decode with an empty lane, and a 64-row
# continuation chunk at per-row offsets; (name, sq, q_offset, kv_len)
Q8_ENGINE_CASES = [
    ("decode_8x1_vs_512", 1, [0, 76, 127, 254, 255, 399, 511, 0],
     [1, 77, 128, 255, 256, 400, 512, 0]),
    ("chunk_8x64_vs_512", 64, [64 * i for i in range(8)], [64 * i + 64 for i in range(8)]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", Q8_ENGINE_CASES, ids=lambda c: c[0])
def test_flash_int8_mma_at_engine_shapes(cuda, case):
    """K1q's tensor-core instance against its plain version at the engine's
    decode and chunk shapes, over a cache quantized as the engine quantizes
    it (per-(row, KV head) absmax scales of N(0, 1) keys and values): the
    output within 2e-2 (bf16; P rounds to f16 before P V), the lse within
    1e-3, and exact zeros in the empty lane."""
    from repro_torch.models.common import kv_scale, quantize_kv

    name, sq, qo, kl = case
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    r = _rng(17)
    q = torch.from_numpy(r.standard_normal((8, sq, 16, 128)).astype(np.float32))
    q = q.to(cuda, torch.bfloat16)
    fp = [torch.from_numpy(r.standard_normal((8, 512, 8, 128)).astype(np.float32)).to(cuda)
          for _ in "kv"]
    ks, vs = (kv_scale(x) for x in fp)
    k8, v8 = quantize_kv(fp[0], ks), quantize_kv(fp[1], vs)
    kw = dict(causal=True, q_offset=_lanes(qo, cuda), kv_len=_lanes(kl, cuda))
    assert fa.fwd_path(q) == "mma"
    before = flash_attention_int8.launches
    out, lse = flash_attention_int8(q, k8, v8, ks, vs, **kw)
    assert flash_attention_int8.launches == before + 1
    ref_out, ref_lse = flash_attention_ref(q, k8, v8, k_scale=ks, v_scale=vs, **kw)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-5)
    for row in (i for i, n in enumerate(kl) if n == 0):
        assert torch.count_nonzero(out[row]) == 0


@pytest.mark.cuda
def test_flash_int8_mma_rejects_misaligned_cache(cuda):
    """The tensor-core instance raises on an int8 cache whose head stride is
    not a whole 16-byte step (24 int8); the FMA template (f32 q) takes it."""
    wide = torch.randint(-127, 128, (2, 32, 2, 24), dtype=torch.int8, device=cuda)
    k = wide[..., :16]
    s = torch.full((2, 2), 0.02, device=cuda)
    q = torch.randn(2, 1, 4, 16, device=cuda)
    kw = dict(q_offset=_lanes([31], cuda), kv_len=_lanes([32], cuda))
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_int8(q.bfloat16(), k, k, s, s, **kw)
    out, _ = flash_attention_int8(q, k, k, s, s, **kw)
    torch.testing.assert_close(out, flash_attention_ref(q, k, k, k_scale=s, v_scale=s, **kw)[0],
                               atol=ATOL, rtol=0)


# -- K5, K6, K7 and K4 on the card (the registry's scan, transpose, fft and
# matmul ops; tests/test_torch_substrate.py holds their plain versions to JAX)

def _bf16_ulp(x):
    mag = x.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,n,block", [(3, 512, 64), (2, 16384, None), (5, 12288, 12288),
                                          (3, 20000, 5000), (1, 100, 100)])
def test_scan_kernel_matches_plain(cuda, dtype, rows, n, block):
    """K5 against its leaf-structured plain version: f32 within 1e-6 of the
    running sum of |x| (the two sum each leaf in other orders), bf16 within
    one ulp plus that f32 slack (a last-bit difference of the f32 sums can
    move a rounding)."""
    from repro_torch.kernels import planner
    from repro_torch.kernels.bp_scan import bp_scan, bp_scan_plain

    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(rows, n, device=cuda, generator=g).to(dt)
    leaf = block or planner.plan_scan(x.shape, dt, planner.device_params(cuda))["block"]
    before = bp_scan.launches
    got = bp_scan(x, block=block).float()
    assert bp_scan.launches == before + 1
    want = bp_scan_plain(x, leaf).float()
    slack = 1e-6 * torch.cumsum(x.float().abs(), dim=-1) + 1e-6
    bound = slack if dt == torch.float32 else _bf16_ulp(torch.maximum(got, want)) + slack
    assert ((got - want).abs() <= bound).all(), (got - want).abs().max()
    with pytest.raises(ValueError, match="does not divide"):
        bp_scan(x[:, :96].contiguous(), block=64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,n,block", [(3, 2 ** 18, 2 ** 16), (2, 3 * 2 ** 15, 2 ** 15),
                                          (4, 2 ** 20, None)])
def test_scan_kernel_instances_and_determinism(cuda, dtype, rows, n, block):
    """K5's two instances on the same values (a view one element off 16
    bytes takes scalar) give the same bits, and two calls give the same
    bits; leaves longer than a tile with several a row (the leaves' chain
    and the offsets' second launch) and one leaf a row, within the
    tolerances of test_scan_kernel_matches_plain."""
    from repro_torch.kernels import planner
    from repro_torch.kernels.bp_scan import bp_scan, bp_scan_plain, path

    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(rows * n)
    step = 16 // torch.empty((), dtype=dt).element_size()
    x = torch.randn(rows, n + step, device=cuda, generator=g).to(dt)[:, step:]
    y = torch.empty(rows, n + 1, dtype=dt, device=cuda)[:, 1:]
    y.copy_(x)  # the same values, one element off 16 bytes
    assert path(x, block) == "vec" and path(y, block) == "scalar"
    got = bp_scan(x, block=block)
    assert torch.equal(bp_scan(x, block=block), got)
    assert torch.equal(bp_scan(y, block=block), got)
    leaf = block or planner.plan_scan(x.shape, dt, planner.device_params(cuda))["block"]
    want = bp_scan_plain(x, leaf).float()
    slack = 1e-6 * torch.cumsum(x.float().abs(), dim=-1) + 1e-6
    if dt == torch.float32:
        bound = slack
    else:
        # both sides round the leaf's own prefix to bf16 before the leaf
        # offset is added, from f32 sums in other orders: one ulp of that
        # prefix, then one of the result
        local = torch.cumsum(x.float().reshape(rows, -1, leaf), dim=-1).reshape(rows, n)
        bound = _bf16_ulp(torch.maximum(got.float(), want)) + _bf16_ulp(local) + slack
    assert ((got.float() - want).abs() <= bound).all(), (got.float() - want).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("block", [None, 2 ** 14])
def test_scan_kernel_in_a_cuda_graph(cuda, block):
    """K5 captured in a CUDA graph (its status words are zeroed inside the
    call) gives the uncaptured call's bits on every replay."""
    from repro_torch.kernels.bp_scan import bp_scan

    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(8, 2 ** 16, device=cuda, generator=g)
    bp_scan(x, block=block)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = bp_scan(x, block=block)
    for _ in range(2):
        x.copy_(torch.randn(8, 2 ** 16, device=cuda, generator=g))
        want = bp_scan(x, block=block)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "float64"])
@pytest.mark.parametrize("m,n,bt,morton", [(96, 160, 32, True), (256, 256, 64, True),
                                           (256, 256, 64, False), (1000, 24, 8, True),
                                           (4096, 64, None, True), (64, 128, 128, True),
                                           (2048, 2048, 128, True)])
def test_transpose_kernel_is_exact(cuda, dtype, m, n, bt, morton, offset):
    """Each K6 instance moves every element exactly: vec on the aligned
    layouts (all but int8 1000x24 at tile 8), scalar on the same matrices
    one element off 16 bytes; 2048^2 at tile 128 is a Morton grid of 16 x 16
    bt tiles."""
    from repro_torch.kernels.bi_transpose import bi_transpose, path

    dt = getattr(torch, dtype)
    x = torch.empty(m * n + offset, dtype=dt, device=cuda)[offset:].view(m, n)
    x.copy_(torch.randn(m, n, device=cuda) * 50)
    aligned = not offset and not (dtype == "int8" and m == 1000)
    assert path(x, bt) == ("vec" if aligned else "scalar")
    before = bi_transpose.launches
    got = bi_transpose(x, bt=bt, morton=morton)
    assert bi_transpose.launches == before + 1
    assert got.shape == (n, m) and torch.equal(got, x.T)


@pytest.mark.cuda
@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("rows,n,n1", [(4, 1024, None), (3, 512, None), (2, 256, 1),
                                       (2, 4096, 8), (256, 65536, None), (3, 2 ** 20, None),
                                       (5, 4096, 4096)])
def test_fft_kernel_matches_plain(cuda, rows, n, n1, real):
    """K7 (one bi_fft call: two kernels, one on a degenerate split, and no K2
    launch) against its plain two-pass version and torch.fft, normwise
    relative 1e-5 and 1e-4, on complex64 and real f32 input: both passes at
    each tile size (lines of 16-256 and 512-1024), and the one-pass split
    with n1 = 1 and n1 = n."""
    from repro_torch.kernels.bi_fft import bi_fft, bi_fft_plain, fft_ref

    g = torch.Generator(device=cuda).manual_seed(n + rows)
    x = torch.randn(rows, n, device=cuda, generator=g)
    if not real:
        x = torch.complex(x, torch.randn(rows, n, device=cuda, generator=g))
    k2, k7 = hbp_matmul.launches, bi_fft.launches
    got = bi_fft(x, n1=n1)
    assert bi_fft.launches == k7 + 1
    assert hbp_matmul.launches == k2
    assert got.dtype == torch.complex64 and got.shape == (rows, n)
    want = bi_fft_plain(x, n1=n1)
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-5 * scale
    assert (got - fft_ref(x)).abs().max() <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,n1", [(1, 8192, 1), (1, 2 ** 25, None)])
def test_fft_kernel_past_the_cap(cuda, rows, n, n1):
    """Lengths the kernel's 4096-line passes do not hold at the given split:
    a degenerate 8192 re-planned to 64 x 128 (two K7 kernels, one call);
    2^25 at 4096 x 8192, pass 1 alone, then pass 2 as a bi_fft of 8192 over
    4096 lines and the readout by K6 (two calls, one K6 launch a row).
    Against torch.fft.fft normwise 1e-4, and the plain version's bits."""
    from repro_torch.kernels.bi_fft import bi_fft, bi_fft_plain, fft_ref, split
    from repro_torch.kernels.bi_transpose import bi_transpose

    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.complex(*(torch.randn(rows, n, device=cuda, generator=g) for _ in "ri"))
    past = max(split(n, n1)) > 4096
    k7, k6 = bi_fft.launches, bi_transpose.launches
    got = bi_fft(x, n1=n1)
    assert bi_fft.launches - k7 == (2 if past else 1)
    assert bi_transpose.launches - k6 == (rows if past else 0)
    want = fft_ref(x)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    assert torch.equal(got, bi_fft_plain(x, n1=n1))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,n1", [(8, 65536, None), (4, 2048, 1)])
def test_fft_kernel_in_a_cuda_graph(cuda, rows, n, n1):
    """K7 captured in a CUDA graph after a warm-up call (its tables are
    on the card by then) gives the uncaptured call's result on replay."""
    from repro_torch.kernels.bi_fft import bi_fft

    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.complex(*(torch.randn(rows, n, device=cuda, generator=g) for _ in "ri"))
    want = bi_fft(x, n1=n1)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = bi_fft(x, n1=n1)
    x.copy_(torch.complex(*(torch.randn(rows, n, device=cuda, generator=g) for _ in "ri")))
    want2 = bi_fft(x, n1=n1)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want2) and not torch.equal(want, want2)


def _strassen_levels(n, cutoff):
    levels, edge = 0, n
    while edge > cutoff and edge % 2 == 0:
        edge, levels = edge // 2, levels + 1
    return levels


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,cutoff", [(256, 64), (192, 48), (130, 32)])
def test_strassen_kernel_matches_plain(cuda, dtype, n, cutoff):
    """K4 against its plain version (the same recursion on matmul_ref
    leaves): f32 runs the fused kernel, one launch and no K2 launch (the
    130 -> 65 leaf edge on its scalar instance); bf16 the composition, K2
    launching 7^levels times; f32 within 1e-4, bf16 within 2^-7 relative to
    the largest output (the operand combinations round alike, the leaves
    sum in other orders); a repeat call gives the same bits."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.strassen_matmul import strassen_matmul, strassen_matmul_plain

    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(n)
    a, b = (torch.randn(n, n, device=cuda, generator=g).to(dt) for _ in "ab")
    levels = _strassen_levels(n, cutoff)
    k2, k4 = hbp_matmul.launches, strassen_matmul.launches
    got = registry.dispatch("matmul", a, b, backend="strassen", cutoff=cutoff)
    f32 = dt == torch.float32
    assert hbp_matmul.launches - k2 == (0 if f32 else 7 ** levels)
    assert strassen_matmul.launches - k4 == (1 if f32 else 0)
    assert got.dtype == dt
    want = strassen_matmul_plain(a, b, cutoff=cutoff).float()
    tol = (1e-4 if f32 else 2 ** -7) * want.abs().max()
    assert (got.float() - want).abs().max() <= tol
    assert torch.equal(strassen_matmul(a, b, cutoff=cutoff), got)


@pytest.mark.cuda
@pytest.mark.parametrize("n,cutoff,layout", [(256, 32, (False, False)), (512, 64, (True, False)),
                                             (256, 64, (False, True)), (260, 65, (True, True)),
                                             (512, 128, (False, False)), (512, 128, (True, True))])
def test_strassen_kernel_levels_and_layouts(cuda, n, cutoff, layout):
    """The fused kernel past two levels (the outer level in the
    composition's combination step: 7 launches of two fused levels), on
    transposed views read in place (the backward's layouts; a leaf edge of
    65 on the scalar instance) and with whole 128 x 128 leaf tiles (the TMA
    store and reduce-add epilogue), against the plain version within 1e-4
    relative to the largest output, no K2 launch, the same bits twice."""
    from repro_torch.kernels.strassen_matmul import path, strassen_matmul, strassen_matmul_plain

    g = torch.Generator(device=cuda).manual_seed(n + cutoff)
    a, b = (torch.randn(n, n, device=cuda, generator=g) for _ in "ab")
    a = a.T.contiguous().T if layout[0] else a
    b = b.T.contiguous().T if layout[1] else b
    levels = _strassen_levels(n, cutoff)
    assert path(a, b, cutoff) == ("scalar" if (n >> min(levels, 2)) % 16 else "vec")
    k2, k4 = hbp_matmul.launches, strassen_matmul.launches
    got = strassen_matmul(a, b, cutoff=cutoff)
    assert hbp_matmul.launches == k2
    assert strassen_matmul.launches - k4 == 7 ** max(levels - 2, 0)
    want = strassen_matmul_plain(a, b, cutoff=cutoff)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    assert torch.equal(strassen_matmul(a, b, cutoff=cutoff), got)


@pytest.mark.cuda
def test_strassen_kernel_gradient_at_4096(cuda):
    """The f32 4096^2 gradient through backend="strassen": the forward and
    both backward products (g Bᵀ and Aᵀ g, re-planned onto Strassen over
    transposed views) are fused launches, no K2, each within 1e-4 of the
    plain version relative to its largest value."""
    from repro_torch.kernels.strassen_matmul import strassen_matmul, strassen_matmul_plain

    n = 4096
    g = torch.Generator(device=cuda).manual_seed(n)
    a, b, w = (torch.randn(n, n, device=cuda, generator=g) for _ in "abw")
    a.requires_grad_()
    b.requires_grad_()
    k2, k4 = hbp_matmul.launches, strassen_matmul.launches
    out = matmul(a, b, backend="strassen")
    (out * w).sum().backward()
    torch.cuda.synchronize()
    assert hbp_matmul.launches == k2 and strassen_matmul.launches - k4 == 3
    with torch.no_grad():
        for got, want in ((out, strassen_matmul_plain(a, b)),
                          (a.grad, strassen_matmul_plain(w, b.detach().T)),
                          (b.grad, strassen_matmul_plain(a.detach().T, w))):
            assert (got - want).abs().max() <= 1e-4 * want.abs().max()


