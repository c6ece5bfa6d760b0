"""The port's kernels against the JAX package's.

On the CPU the port's wrappers run their plain versions, so these tests hold
``matmul_ref`` and ``flash_attention_ref`` against the JAX Pallas kernels
(interpret mode) and the JAX oracles, on the same numpy inputs.  Tolerance:
f32 throughout, atol 1e-5 (the two sides sum in different orders).

The CUDA kernels themselves cannot run here; the tests marked ``cuda`` hold
them against their plain versions on the card and skip without one
(``PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_kernels.py`` on a
machine with a GPU).  ``chip_smoke.py`` checks them at the serving shapes.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import hbp_matmul as mm_mod  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref  # noqa: E402
from repro_torch.kernels.hbp_matmul import hbp_matmul, matmul_ref  # noqa: E402

ATOL = 1e-5

MM_SHAPES = [(8, 16, 24), (5, 7, 3), (16, 32, 64)]

# (name, b, sq, sk, h, kvh, hd, causal, window, q_offset, kv_len)
FA_CASES = [
    ("prefill_gqa", 2, 8, 8, 4, 2, 16, True, 0, None, None),
    ("prefill_mha_noncausal", 2, 8, 8, 2, 2, 16, False, 0, None, None),
    ("windowed", 1, 8, 8, 4, 2, 16, True, 3, None, None),
    ("decode_scalar", 2, 1, 16, 4, 2, 16, True, 0, [9], [10]),
    ("decode_rows_zero_lane", 2, 1, 16, 4, 2, 16, True, 0, [3, 0], [4, 0]),
    ("decode_rows_fully_masked", 2, 1, 16, 4, 1, 16, True, 2, [12, 3], [4, 4]),
]


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


@pytest.fixture(scope="module")
def jax_refs():
    """Every JAX reference of this module, computed once."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import ref
    from repro.kernels.flash_attention import flash_attention as jax_fa
    from repro.kernels.hbp_matmul import hbp_matmul as jax_mm

    out = {"mm": {}, "fa": {}}
    for i, (m, k, n) in enumerate(MM_SHAPES):
        r = _rng(i)
        a = r.standard_normal((m, k)).astype(np.float32)
        b = r.standard_normal((k, n)).astype(np.float32)
        out["mm"][(m, k, n)] = (a, b, np.asarray(jax_mm(jnp.asarray(a), jnp.asarray(b),
                                                        interpret=True)),
                                np.asarray(ref.matmul_ref(jnp.asarray(a), jnp.asarray(b))))
    for case in FA_CASES:
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
                                   (4, 151936, 2048), (5, 70, 37), (1, 1, 1)])
def test_matmul_plan_covers_k(m, n, k):
    """Split-K chunks are whole K steps and cover K exactly once."""
    bm, splits, kchunk = mm_mod.plan(m, n, k, sms=132)
    assert bm == (16 if m <= 16 else 64)
    assert kchunk % mm_mod.BK == 0
    assert (splits - 1) * kchunk < k <= splits * kchunk


@pytest.mark.parametrize("case", FA_CASES, ids=lambda c: c[0])
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
    with pytest.raises(ValueError):
        hbp_matmul(torch.zeros(2, 3, device="meta"), torch.zeros(3, 2, device="meta"))


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_CASES, ids=lambda c: c[0])
def test_flash_kernel_matches_plain(cuda, dtype, case):
    name, *_, causal, window, qo, kl = case
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(cuda, dt) for x in _fa_inputs(case))
    kw = dict(causal=causal, window=window, q_offset=_lanes(qo, cuda), kv_len=_lanes(kl, cuda))
    out, lse = flash_attention(q, k, v, **kw)
    ref_out, ref_lse = flash_attention_ref(q, k, v, **kw)
    tol = ATOL if dt == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-5)
