"""The port's kernel substrate against the JAX package's, on the CPU: the
Morton codec, the planner, K5 (``bp_scan``), K6 (``bi_transpose``), K7
(``bi_fft``), K4 (``strassen_matmul`` and the differentiable ``matmul``),
the policy's registry-backed fields, and the registry's resolution and
dispatch.

Inputs are made from a seed with numpy and go through both packages; the
JAX kernels run in interpret mode, as the JAX package's own tests run them,
and every JAX reference is computed once per module.  On the CPU each
wrapper of the port runs its plain version.  Tolerances:

* plans, Morton codes, transposes and the registry's names: exact;
* ``bp_scan``: f32 at rtol = atol = 2e-4 (``tests/test_kernels.py``'s
  bound), bf16 within one bf16 ulp of JAX's kernel (the two sides may sum
  a leaf in f32 in other orders, and a last-bit difference can move one
  rounding) and within ``tests/test_kernels.py``'s bf16 bound of the
  oracle, which rounds once;
* ``bi_fft``: rtol 1e-5 / atol 1e-4 against JAX (the same split in f32,
  the port's radix stages against JAX's dense DFT products; values are
  O(sqrt(n))), and normwise 1e-5 against ``np.fft.fft`` in complex128;
* ``strassen_matmul``: ``tests/test_strassen.py``'s tolerances; gradients
  of ``matmul`` rtol = atol = 1e-4 (f32 sums of products of f32 sums).

The rule by which the registry picks a backend per tensor device
(``registry.route``) is checked for ``cpu`` and ``cuda`` device types
without a card.
"""
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import morton as jax_morton  # noqa: E402
from repro.kernels import planner as jax_planner  # noqa: E402
from repro.kernels import policy as jax_policy  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels import registry as jax_registry  # noqa: E402
from repro.kernels.bi_fft import bi_fft as jax_bi_fft  # noqa: E402
from repro.kernels.bi_transpose import bi_transpose as jax_bi_transpose  # noqa: E402
from repro.kernels.bp_scan import bp_scan as jax_bp_scan  # noqa: E402
from repro.kernels.strassen_matmul import matmul as jax_matmul  # noqa: E402
from repro.kernels.strassen_matmul import strassen_matmul as jax_strassen  # noqa: E402
from repro_torch.core import costmodel  # noqa: E402
from repro_torch.kernels import morton, planner, policy, ref, registry  # noqa: E402
from repro_torch.kernels.bi_fft import MAX_PASS, bi_fft, bi_fft_plain  # noqa: E402
from repro_torch.kernels.bi_transpose import bi_transpose  # noqa: E402
from repro_torch.kernels.bp_scan import bp_scan, bp_scan_plain  # noqa: E402
from repro_torch.kernels.strassen_matmul import (  # noqa: E402
    matmul,
    strassen_matmul,
    strassen_matmul_plain,
)

bi_fft_mod = importlib.import_module("repro_torch.kernels.bi_fft")

JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}


def _t(a: np.ndarray, dtype="float32") -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


def _j(a: np.ndarray, dtype="float32"):
    return jnp.asarray(a, jnp.float32).astype(JAX_DTYPES[dtype])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _within_bf16_ulp(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    bad = np.abs(got - want) > ulp
    assert not bad.any(), f"{bad.sum()} elements beyond one bf16 ulp"


@pytest.fixture(autouse=True)
def _fresh_registry_state():
    registry.reset_warnings()
    planner.clear_device_params_cache()
    yield


# -- Morton codec ----------------------------------------------------------------

def test_morton_matches_jax():
    vals = list(range(0, 70)) + [255, 256, 1023, 4095, 65535]
    for v in vals:
        assert morton.part1by1(v) == jax_morton.part1by1(v)
        assert morton.compact1by1(v) == jax_morton.compact1by1(v)
        assert morton.morton_ij(v) == jax_morton.morton_ij(v)
    for i in range(0, 40, 3):
        for j in range(0, 40, 7):
            assert morton.morton_of(i, j) == jax_morton.morton_of(i, j)
    for nm, nn in [(1, 1), (2, 2), (4, 4), (8, 8), (3, 3), (2, 4), (4, 2), (6, 5)]:
        assert morton.supports_morton(nm, nn) == jax_morton.supports_morton(nm, nn)
        for flag in (True, False):
            d, jd = morton.grid_decode(nm, nn, morton=flag), jax_morton.grid_decode(
                nm, nn, morton=flag)
            assert [d(g) for g in range(nm * nn)] == [jd(g) for g in range(nm * nn)]
    # the codec runs on integer tensors as on ints
    g = torch.arange(64)
    i, j = morton.morton_ij(g)
    assert [(int(a), int(b)) for a, b in zip(i, j)] == [morton.morton_ij(v) for v in range(64)]


# -- the planner --------------------------------------------------------------------

SCAN_SHAPES = [(4, 1024), (3, 512), (2, 2 ** 20), (1, 100), (8, 96), (64, 2 ** 20)]
MM_SHAPES = [(128, 128, 128), (512, 512, 512), (1024, 1024, 1024), (2048, 2048, 2048),
             (4096, 4096, 4096), (8192, 8192, 8192), (192, 192, 192), (96, 96, 96),
             (256, 512, 128), (4, 2048, 6144), (512, 2048, 151936)]
MT_SHAPES = [(128, 128), (256, 128), (8192, 8192), (4096, 16384), (6144, 10240), (100, 60)]
ATT_SHAPES = [(1, 512, 128), (4, 4096, 128), (2048, 2048, 64), (64, 64, 16), (512, 512, 128)]
FFT_LENGTHS = [1, 2, 3, 96, 256, 512, 1024, 65536]


@pytest.mark.parametrize("fast_bytes", [None, "262144", "52428800"])
def test_plans_match_jax(monkeypatch, fast_bytes):
    if fast_bytes is None:
        monkeypatch.delenv("REPRO_FAST_BYTES", raising=False)
    else:
        monkeypatch.setenv("REPRO_FAST_BYTES", fast_bytes)
    jax_planner.clear_device_params_cache()
    jdp = jax_planner.device_params()
    dp = planner.device_params("cpu")
    assert (dp.platform, dp.fast_bytes, dp.line_bytes, dp.lane) == (
        jdp.platform, jdp.fast_bytes, jdp.line_bytes, jdp.lane)
    assert planner.device_params() is dp  # no card here: the CPU, memoized
    for name in ("float32", "bfloat16"):
        # a torch dtype and its name plan alike
        for dt in (getattr(torch, name), name):
            jdt = JAX_DTYPES[name]
            assert dp.sublane(dt) == jdp.sublane(jdt)
            assert planner.strassen_cutoff(dt) == jax_planner.strassen_cutoff(jdt)
            for shape in SCAN_SHAPES:
                assert planner.plan_scan(shape, dt) == jax_planner.plan_scan(shape, jdt)
            for m, k, n in MM_SHAPES:
                p = planner.plan_matmul(m, k, n, dt)
                assert p == jax_planner.plan_matmul(m, k, n, jdt)
                assert planner.plan_matmul_backend(m, k, n, dt) == \
                    jax_planner.plan_matmul_backend(m, k, n, jdt)
                assert planner.modeled_matmul_misses(m, k, n, dt, p) == \
                    jax_planner.modeled_matmul_misses(m, k, n, jdt, p)
            for m, n in MT_SHAPES:
                assert planner.plan_transpose(m, n, dt) == jax_planner.plan_transpose(m, n, jdt)
            for sq, sk, hd in ATT_SHAPES:
                for kv in (None, "int8"):
                    assert planner.plan_attention(
                        sq, sk, hd, dt, kv_dtype=None if kv is None else torch.int8) == \
                        jax_planner.plan_attention(sq, sk, hd, jdt,
                                                   kv_dtype=None if kv is None else jnp.int8)
    assert planner.plan_matmul_backend(64, 64, 64, "int8") == {"backend": "classical"}
    for n in FFT_LENGTHS:
        assert planner.plan_fft(n) == jax_planner.plan_fft(n)
    for d, cap, mult in [(0, 4, 1), (96, 64, 32), (100, 64, 128), (97, 50, 8), (2 ** 20, 2 ** 21, 128)]:
        assert planner.divisor_tile(d, cap, mult) == jax_planner.divisor_tile(d, cap, mult)


def test_planner_on_the_h100_and_costmodel():
    """The parameters a CUDA device gives (50 MiB L2, 128-byte lines) and
    the plans the copied envelopes derive from them; the costmodel copy is
    the JAX one's arithmetic."""
    from repro.core import costmodel as jax_costmodel

    h100 = planner.DeviceParams(platform="gpu", kind="NVIDIA H100 80GB HBM3",
                                fast_bytes=50 * 2 ** 20, line_bytes=128)
    assert planner.strassen_cutoff("float32", h100) == 2048
    assert planner.strassen_cutoff("bfloat16", h100) == 2048
    assert planner.plan_matmul_backend(8192, 8192, 8192, "float32", h100) == {
        "backend": "strassen", "cutoff": 2048}
    # no square product of qwen3-1.7b recurses: 2048 stays classical
    assert planner.plan_matmul_backend(2048, 2048, 2048, "bfloat16", h100) == {
        "backend": "classical"}
    assert planner.plan_scan((64, 2 ** 20), "float32", h100) == {"block": 2 ** 20}
    assert planner.plan_transpose(8192, 8192, "float32", h100) == {"bt": 1024}
    budget = planner._budget(h100)
    assert costmodel.oblivious_tile_edge(budget, 1, 12) == 1206
    assert costmodel.oblivious_tile_edge(budget, 2, 4) == 1478
    for args in [(1 << 20, 16), (699050, 16), (4369066, 32), (1024, 1)]:
        assert costmodel.strassen_crossover_edge(*args) == \
            jax_costmodel.strassen_crossover_edge(*args)
    for n in (256, 4096):
        for M, B in ((1 << 20, 16), (65536, 8)):
            assert costmodel.seq_cache_complexity_mm(n, n, n, M, B) == \
                jax_costmodel.seq_cache_complexity_mm(n, n, n, M, B)
            assert costmodel.seq_cache_complexity_strassen(n, M, B) == \
                jax_costmodel.seq_cache_complexity_strassen(n, M, B)
            assert costmodel.seq_cache_complexity_fft(n, M, B) == \
                jax_costmodel.seq_cache_complexity_fft(n, M, B)
            assert costmodel.seq_cache_complexity_scan(n, M, B) == \
                jax_costmodel.seq_cache_complexity_scan(n, M, B)
            assert costmodel.seq_cache_complexity_mt(n * n, M, B) == \
                jax_costmodel.seq_cache_complexity_mt(n * n, M, B)


# -- K5: bp_scan ----------------------------------------------------------------------

# tests/test_kernels.py:21's shapes
SCAN_CASES = [(1, 256, 64), (4, 1024, 128), (3, 512, 512)]


@pytest.fixture(scope="module")
def jax_scans():
    out = {}
    for rows, n, block in SCAN_CASES:
        x = np.random.default_rng(n).standard_normal((rows, n)).astype(np.float32)
        for dtype in ("float32", "bfloat16"):
            out[(rows, n, block, dtype)] = (x, _np(jax_bp_scan(_j(x, dtype), block=block)),
                                            _np(jax_ref.bp_scan_ref(_j(x, dtype))))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_bp_scan_matches_jax(jax_scans, case, dtype):
    x, want, want_ref = jax_scans[(*case, dtype)]
    xt = _t(x, dtype)
    got = bp_scan(xt, block=case[2])
    assert got.dtype == xt.dtype and got.shape == xt.shape
    assert torch.equal(got, bp_scan_plain(xt, case[2]))
    got_ref = ref.bp_scan_ref(xt)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(_np(got_ref), want_ref, rtol=2e-4, atol=2e-4)
    else:
        _within_bf16_ulp(_np(got), want)
        _within_bf16_ulp(_np(got_ref), want_ref)
        # the leaf structure rounds twice, the oracle once; where the leaf
        # offset cancels the leaf's prefix, the first rounding's ulp is many
        # of the result's, so the two are held to tests/test_kernels.py's
        # bf16 bound, as the JAX kernel is to its oracle
        np.testing.assert_allclose(_np(got), _np(got_ref), rtol=3e-2, atol=8e-2)


def test_bp_scan_planned_leaf_and_bad_leaf():
    x = _t(np.random.default_rng(0).standard_normal((2, 384)).astype(np.float32))
    block = planner.plan_scan(x.shape, x.dtype)["block"]
    assert torch.equal(bp_scan(x), bp_scan_plain(x, block))
    with pytest.raises(ValueError, match="does not divide"):
        bp_scan(x, block=100)
    with pytest.raises(TypeError):
        bp_scan(x.double())


# (dtype, base shape, view, block, instance): the kernel's 16-byte instance
# needs the pointer, the row pitch and the leaf edge in whole 16-byte steps
SCAN_PATHS = [
    ("float32", (4, 1024), (slice(None), slice(None)), None, "vec"),
    ("float32", (3, 20000), (slice(None), slice(None)), 5000, "vec"),
    ("float32", (4, 1025), (slice(None), slice(1, None)), None, "scalar"),  # off 4 bytes
    ("float32", (4, 1028), (slice(None), slice(4, None)), 256, "vec"),  # 16 bytes in
    ("float32", (5, 1024), (slice(1, None), slice(None)), 512, "vec"),  # a row in
    ("float32", (2, 1000), (slice(None), slice(None)), 250, "scalar"),  # 1000-byte leaf
    ("bfloat16", (3, 100), (slice(None), slice(None)), 100, "scalar"),  # 200-byte pitch
    ("bfloat16", (3, 104), (slice(None), slice(None)), 104, "vec"),
    ("bfloat16", (2, 1032), (slice(None), slice(8, None)), 256, "vec"),
    ("bfloat16", (2, 1028), (slice(None), slice(4, None)), 256, "scalar"),  # off 8 bytes
]


@pytest.mark.parametrize("case", SCAN_PATHS, ids=lambda c: f"{c[0]}_{c[1][0]}x{c[1][1]}_{c[4]}")
def test_bp_scan_path_on_views(case):
    """``bp_scan.path`` on aligned and misaligned views, and the wrapper on
    the view (its plain version on the CPU) equal to the plain version of
    the view's contiguous copy."""
    from repro_torch.kernels.bp_scan import path

    dtype, shape, view, block, want = case
    base = _t(np.random.default_rng(shape[1]).standard_normal(shape).astype(np.float32), dtype)
    x = base[view]
    assert path(x, block) == want
    leaf = block or planner.plan_scan(x.shape, x.dtype)["block"]
    assert torch.equal(bp_scan(x, block=block), bp_scan_plain(x.contiguous(), leaf))


# -- K6: bi_transpose ------------------------------------------------------------------

# (m, n, bt, morton): Morton grids, the row-major fallback (non-square and
# non-power-of-two grids), a planned tile
MT_CASES = [(128, 128, 64, True), (256, 128, 64, False), (64, 64, 64, True),
            (256, 256, 32, True), (96, 160, 32, True), (192, 192, 64, True),
            (100, 60, None, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MT_CASES, ids=lambda c: "x".join(map(str, c)))
def test_bi_transpose_matches_jax(case, dtype):
    m, n, bt, flag = case
    x = np.random.default_rng(m * n).standard_normal((m, n)).astype(np.float32)
    want = jax_bi_transpose(_j(x, dtype), bt=bt, morton=flag)
    got = bi_transpose(_t(x, dtype), bt=bt, morton=flag)
    assert got.is_contiguous() and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_bi_transpose_rejects_bad_tile():
    with pytest.raises(ValueError, match="does not divide"):
        bi_transpose(torch.zeros(96, 64), bt=48)
    with pytest.raises(ValueError):
        bi_transpose(torch.zeros(2, 3, 4))


# -- K7: bi_fft ---------------------------------------------------------------------------

# (rows, n, n1, complex input): the JAX test shapes, a non-square split
# (512 = 16 x 32), the degenerate split n1 = 1, odd rows, a real input
FFT_CASES = [(1, 256, None, True), (4, 1024, None, True), (2, 512, None, True),
             (2, 64, 1, True), (3, 128, None, True), (5, 256, 8, False)]


@pytest.fixture(scope="module")
def jax_ffts():
    out = {}
    for rows, n, n1, cplx in FFT_CASES:
        rng = np.random.default_rng(n + rows)
        x = rng.standard_normal((rows, n)).astype(np.float32)
        if cplx:
            x = (x + 1j * rng.standard_normal((rows, n))).astype(np.complex64)
        out[(rows, n, n1, cplx)] = (x, np.asarray(jax_bi_fft(jnp.asarray(x), n1=n1)),
                                    np.asarray(jax_ref.fft_ref(jnp.asarray(x))))
    return out


@pytest.mark.parametrize("case", FFT_CASES, ids=lambda c: "x".join(map(str, c)))
def test_bi_fft_matches_jax(jax_ffts, case):
    x, want, want_ref = jax_ffts[case]
    xt = torch.from_numpy(x)
    got = bi_fft(xt, n1=case[2])
    assert got.dtype == torch.complex64 and got.shape == xt.shape
    assert torch.equal(got, bi_fft_plain(xt, n1=case[2]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ref.fft_ref(xt).numpy(), want_ref, rtol=1e-5, atol=1e-4)


def test_bi_fft_rejects_non_power_of_two():
    x = torch.zeros(2, 96, dtype=torch.complex64)
    with pytest.raises(ValueError, match="power-of-two"):
        bi_fft(x)
    with pytest.raises(ValueError, match="power-of-two"):
        jax_bi_fft(jnp.zeros((2, 96), jnp.complex64))


def _fft_numpy_cases():
    """(rows, n, n1, real): every n from 2 to 2^14 at plan_fft's split, and
    at n1 = 1 and n1 = n (one pass of length n) where n is within the pass
    cap; odd rows, real f32 input at plan_fft's split."""
    cases = []
    for p in range(1, 15):
        n = 1 << p
        cases += [(3, n, None, False), (5, n, None, True)]
        if n <= MAX_PASS:
            cases += [(3, n, 1, False), (1, n, n, False)]
    return cases


@pytest.mark.parametrize("case", _fft_numpy_cases(), ids=lambda c: "x".join(map(str, c)))
def test_bi_fft_plain_matches_numpy(case):
    """The two-pass plain version (what ``bi_fft`` runs on the CPU) against
    numpy's complex128 FFT, normwise 1e-5."""
    rows, n, n1, real = case
    rng = np.random.default_rng(n + rows)
    x = rng.standard_normal((rows, n)).astype(np.float32)
    if not real:
        x = (x + 1j * rng.standard_normal((rows, n))).astype(np.complex64)
    xt = torch.from_numpy(x)
    got = bi_fft_plain(xt, n1=n1)
    assert got.dtype == torch.complex64 and got.shape == (rows, n)
    assert torch.equal(bi_fft(xt, n1=n1), got)
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("n,n1", [(8192, 1), (8192, 8192), (16384, 2), (16384, 1)])
def test_bi_fft_past_the_cap_matches_numpy(n, n1):
    """A caller's split with a pass longer than the kernel's tile is the
    same DFT at plan_fft's split: computed, not refused, and held to
    numpy's complex128 FFT normwise 1e-5, the wrapper equal to the plain
    version."""
    rng = np.random.default_rng(n + n1)
    x = (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))).astype(np.complex64)
    xt = torch.from_numpy(x)
    got = bi_fft(xt, n1=n1)
    assert bi_fft_mod.split(n, n1) == bi_fft_mod.split(n, None)
    assert got.dtype == torch.complex64 and got.shape == xt.shape
    assert torch.equal(got, bi_fft_plain(xt, n1=n1))
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


# n = 512 with the pass cap lowered to 16: n1 = 1 and n1 = n re-plan to
# plan_fft's 16 x 32, whose n2 = 32 is past the cap, so pass 2 recurses
# (8 x 4 ... a bi_fft of its own) and is read out by K6's plain version
LOW_CAP_CASES = [(3, 512, 1), (3, 512, 512), (2, 512, None)]


@pytest.fixture(scope="module")
def jax_low_cap_ffts():
    out = {}
    for rows, n, n1 in LOW_CAP_CASES:
        rng = np.random.default_rng(rows + n)
        x = (rng.standard_normal((rows, n)) + 1j * rng.standard_normal((rows, n)))
        x = x.astype(np.complex64)
        out[(rows, n, n1)] = (x, np.asarray(jax_bi_fft(jnp.asarray(x), n1=n1)))
    return out


@pytest.mark.parametrize("case", LOW_CAP_CASES, ids=lambda c: "x".join(map(str, c)))
def test_bi_fft_recursion_past_a_lowered_cap_matches_jax(jax_low_cap_ffts, monkeypatch, case):
    """MAX_PASS is read at call time: at 16, n = 512 runs pass 1 at n1 = 16
    and a nested bi_fft of length 32 for pass 2, equal to the plain version
    and to the JAX bi_fft (interpret mode) at rtol 1e-5 / atol 1e-4."""
    x, want = jax_low_cap_ffts[case]
    monkeypatch.setattr(bi_fft_mod, "MAX_PASS", 16)
    assert bi_fft_mod.split(case[1], case[2]) == (16, 32)
    xt = torch.from_numpy(x)
    got = bi_fft(xt, n1=case[2])
    assert torch.equal(got, bi_fft_plain(xt, n1=case[2]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    ref128 = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert np.abs(got.numpy() - ref128).max() <= 1e-5 * np.abs(ref128).max()


@pytest.mark.parametrize("p", range(0, 25))
def test_plan_fft_split_is_within_the_pass_cap(p):
    n1 = planner.plan_fft(1 << p)["n1"]
    assert n1 * ((1 << p) // n1) == 1 << p and max(n1, (1 << p) // n1) <= MAX_PASS


# -- K4: strassen_matmul and the differentiable matmul ------------------------------------

# tests/test_strassen.py:51's cases and tolerances
STRASSEN_CASES = [(128, 32), (256, 64), (192, 48)]
STRASSEN_TOL = {"float32": dict(rtol=2e-3, atol=2e-3), "bfloat16": dict(rtol=8e-2, atol=1.5)}


@pytest.fixture(scope="module")
def jax_strassens():
    out = {}
    for n, cutoff in STRASSEN_CASES + [(130, 32), (65, 32)]:
        rng = np.random.default_rng(n)
        a, b = (rng.standard_normal((n, n)).astype(np.float32) for _ in "ab")
        for dtype in ("float32", "bfloat16"):
            out[(n, cutoff, dtype)] = (a, b, _np(jax_strassen(_j(a, dtype), _j(b, dtype),
                                                              cutoff=cutoff)))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", STRASSEN_CASES + [(130, 32), (65, 32)],
                         ids=lambda c: "x".join(map(str, c)))
def test_strassen_matches_jax(jax_strassens, case, dtype):
    """Multi-level recursion (also 192 -> 96 -> 48), and edges that stop it
    (130: odd after one halving) or never start it (65)."""
    a, b, want = jax_strassens[(*case, dtype)]
    at, bt = _t(a, dtype), _t(b, dtype)
    got = strassen_matmul(at, bt, cutoff=case[1])
    assert got.dtype == at.dtype
    assert torch.equal(got, strassen_matmul_plain(at, bt, cutoff=case[1]))
    np.testing.assert_allclose(_np(got), want, **STRASSEN_TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(ref.matmul_ref(at, bt)), **STRASSEN_TOL[dtype])


# K4's leaf table (what the fused kernel runs): n = 64 at 1, 2 and 3 levels
LEAF_LEVELS = [1, 2, 3]


@pytest.fixture(scope="module")
def jax_leaf_refs():
    rng = np.random.default_rng(64)
    a, b = (rng.standard_normal((64, 64)).astype(np.float32) for _ in "ab")
    return a, b, {lv: _np(jax_strassen(_j(a), _j(b), cutoff=64 >> lv)) for lv in LEAF_LEVELS}


@pytest.mark.parametrize("levels", LEAF_LEVELS)
def test_strassen_leaf_plan_matches_jax(jax_leaf_refs, levels):
    """The fused kernel's leaf table, evaluated in torch in the kernel's
    order (``leaf_plan_plain``), against JAX's strassen_matmul within
    STRASSEN_TOL and against the plain recursion normwise 1e-5 (the
    products are added into C in another order; one level is the same
    order, so the same bits); operands read as transposed views give the
    same bits."""
    from repro_torch.kernels.strassen_matmul import leaf_plan_plain

    a, b, want = jax_leaf_refs
    at, bt = _t(a), _t(b)
    got = leaf_plan_plain(at, bt, levels)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), want[levels], **STRASSEN_TOL["float32"])
    plain = strassen_matmul_plain(at, bt, cutoff=64 >> levels)
    assert (got - plain).abs().max() <= 1e-5 * plain.abs().max()
    if levels == 1:
        assert torch.equal(got, plain)
    views = leaf_plan_plain(at.T.contiguous().T, bt.T.contiguous().T, levels)
    assert torch.equal(views, got)


@pytest.mark.parametrize("levels", LEAF_LEVELS)
def test_strassen_leaf_plan_structure(levels):
    """7^levels leaves, 2^levels terms at most per operand, 12^levels
    target writes (144 at two levels), and each of the 4^levels C
    sub-blocks written first by exactly one leaf, the earliest to touch
    it; the offsets follow the strides (a transposed view swaps them)."""
    from repro_torch.kernels.strassen_matmul import leaf_plan

    n, e = 64, 64 >> levels
    plan = leaf_plan(n, levels, (n, 1), (n, 1), (n, 1))
    assert len(plan) == 7 ** levels
    assert sum(len(ct) for _, _, ct in plan) == 12 ** levels
    assert all(len(t) in (1, 2, 4, 8) and len(t) <= 2 ** levels
               for at, bt, _ in plan for t in (at, bt))
    firsts = [o for _, _, ct in plan for o, _, f in ct if f]
    assert sorted(firsts) == sorted(r * e * n + c * e for r in range(2 ** levels)
                                    for c in range(2 ** levels))
    seen = set()
    for _, _, ct in plan:
        for o, s, f in ct:
            assert f == (o not in seen) and s in (1, -1)
            seen.add(o)
    tplan = leaf_plan(n, levels, (1, n), (n, 1), (n, 1))
    for (at, _, _), (tt, _, _) in zip(plan, tplan):
        assert [(o // n + (o % n) * n, s) for o, s in at] == list(tt)


def test_strassen_packed_table_matches_the_plan():
    """The 160-byte records the kernel reads hold the plan's offsets, signs,
    counts and first-writer bits; unused term slots have sign +1."""
    sm_mod = importlib.import_module("repro_torch.kernels.strassen_matmul")
    plan = sm_mod.leaf_plan(256, 2, (1, 256), (256, 1), (256, 1))
    rec = sm_mod._table(plan, torch.device("cpu")).numpy().view(sm_mod._LEAF)
    assert rec.dtype.itemsize == 160 and len(rec) == 49
    for r, (at, bt, ct) in zip(rec, plan):
        assert (r["na"], r["nb"], r["nc"]) == (len(at), len(bt), len(ct))
        for key, terms in (("a", at), ("b", bt)):
            assert list(r[key][:len(terms)]) == [o for o, _ in terms]
            assert list(r["s" + key]) == [s for _, s in terms] + [1.0] * (4 - len(terms))
        assert list(r["c"][:len(ct)]) == [o for o, _, _ in ct]
        assert list(r["sc"][:len(ct)]) == [s for _, s, _ in ct]
        assert r["first"] == sum(1 << i for i, (_, _, f) in enumerate(ct) if f)


# (m, k, n, backend, cutoff)
GRAD_CASES = [(128, 128, 128, "strassen", 32), (64, 64, 64, None, None),
              (48, 80, 24, "classical", None)]


@pytest.mark.parametrize("case", GRAD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_matmul_gradients_match_jax(case):
    m, k, n, backend, cutoff = case
    rng = np.random.default_rng(m + k + n)
    a, b = rng.standard_normal((m, k)).astype(np.float32), rng.standard_normal((k, n)).astype(np.float32)
    w = rng.standard_normal((m, n)).astype(np.float32)

    def jloss(x, y):
        return jnp.sum(jax_matmul(x, y, backend=backend, cutoff=cutoff) * w)

    jval = jloss(jnp.asarray(a), jnp.asarray(b))
    jda, jdb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    at, bt = _t(a).requires_grad_(), _t(b).requires_grad_()
    loss = (matmul(at, bt, backend=backend, cutoff=cutoff) * _t(w)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-5)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(jda), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jdb), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="unknown matmul backend"):
        matmul(at, bt, backend="winograd")


# -- the registry ----------------------------------------------------------------------------

def test_registry_names_and_specs_match_jax():
    assert registry.names() == jax_registry.names()
    for name in registry.names():
        spec, jspec = registry.get(name), jax_registry.get(name)
        # JAX's knobs, then the port's wrappers' own (the autotune's)
        extra = {"matmul": ("tile_n", "splits"), "attention": ("splits",)}.get(name, ())
        assert spec.pallas_only == jspec.pallas_only + extra
        assert spec.has_vjp == jspec.has_vjp
        assert (spec.needs is None) == (jspec.needs is None)
        assert (spec.simulator is None) == (jspec.simulator is None)
    with pytest.raises(KeyError):
        registry.get("conv")
    with pytest.raises(ValueError, match="already registered"):
        registry.register(registry.get("scan"))


def _dispatch_inputs(op):
    """(port args, JAX args, kwargs) for one op, from one seeded draw."""
    rng = np.random.default_rng(len(op))
    if op == "scan":
        x = rng.standard_normal((3, 512)).astype(np.float32)
        return (_t(x),), (_j(x),), {}
    if op == "matmul":
        a, b = rng.standard_normal((64, 48)).astype(np.float32), \
            rng.standard_normal((48, 80)).astype(np.float32)
        return (_t(a), _t(b)), (_j(a), _j(b)), {}
    if op == "transpose":
        x = rng.standard_normal((128, 64)).astype(np.float32)
        return (_t(x),), (_j(x),), {}
    if op == "fft":
        x = (rng.standard_normal((2, 256)) + 1j * rng.standard_normal((2, 256))).astype(np.complex64)
        return (torch.from_numpy(x),), (jnp.asarray(x),), {}
    # attention: the port's (b, s, heads, hd) layout against JAX's folded
    # (b * heads, s, hd), two heads of one batch row
    q, k, v = (rng.standard_normal((1, 64, 2, 16)).astype(np.float32) for _ in "qkv")
    fold = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3).reshape(2, 64, 16))  # noqa: E731
    return tuple(map(_t, (q, k, v))), tuple(map(fold, (q, k, v))), dict(causal=True, window=0)


def _unfold_attention(out):
    return np.asarray(out).reshape(1, 2, 64, 16).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("impl", [None, "auto", "jnp", "ref", "pallas"])
@pytest.mark.parametrize("op", ["scan", "matmul", "transpose", "attention", "fft"])
def test_dispatch_matches_jax(op, impl):
    args, jargs, kw = _dispatch_inputs(op)
    got = registry.dispatch(op, *args, impl=impl, **kw)
    want = jax_registry.dispatch(op, *jargs, impl=impl, **kw)
    want = _unfold_attention(want) if op == "attention" else np.asarray(want)
    got = got.detach().numpy()
    if op == "transpose":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    # a CPU tensor: auto and pallas run the kernel's plain version, jnp and
    # ref the oracle
    if impl in ("jnp", "ref"):
        spec = registry.get(op)
        kw2 = {k: v for k, v in kw.items()}
        torch.testing.assert_close(registry.dispatch(op, *args, impl=impl, **kw2),
                                   spec.ref(*args, **kw2), rtol=0, atol=0)


def test_dispatch_tiles_reach_the_kernel_and_plans_are_memoized():
    x = _t(np.random.default_rng(0).standard_normal((2, 256)).astype(np.float32))
    registry._PLANS.clear()
    assert torch.equal(registry.dispatch("scan", x, block=64), bp_scan_plain(x, 64))
    with policy.apply(variants={"scan": {"block": 128}}):
        assert torch.equal(registry.dispatch("scan", x), bp_scan_plain(x, 128))
        # the explicit call-site kwarg beats the policy's variant
        assert torch.equal(registry.dispatch("scan", x, block=32), bp_scan_plain(x, 32))
    registry.dispatch("scan", x)
    registry.dispatch("scan", x)
    assert [k[0] for k in registry._PLANS] == ["scan"]
    # the transpose's Morton flag and the fft split reach their wrappers
    y = _t(np.random.default_rng(1).standard_normal((64, 64)).astype(np.float32))
    assert torch.equal(registry.dispatch("transpose", y, bt=16, morton=False), y.T)
    z = torch.randn(2, 64, dtype=torch.complex64, generator=torch.Generator().manual_seed(0))
    assert torch.equal(registry.dispatch("fft", z, n1=4), bi_fft_plain(z, n1=4))
    # the matmul backend knob
    a = torch.randn(128, 128, generator=torch.Generator().manual_seed(0))
    assert torch.equal(registry.dispatch("matmul", a, a, backend="strassen", cutoff=32),
                       strassen_matmul_plain(a, a, cutoff=32))


def test_dropped_overrides_warn_once_or_raise(monkeypatch):
    x = _t(np.random.default_rng(0).standard_normal((2, 256)).astype(np.float32))
    jx = _j(np.asarray(x))
    jax_registry.reset_warnings()
    for dispatch in (registry.dispatch, jax_registry.dispatch):
        arg = x if dispatch is registry.dispatch else jx
        with pytest.warns(UserWarning, match="ignored on the ref path"):
            dispatch("scan", arg, impl="ref", block=64)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            dispatch("scan", arg, impl="ref", block=64)  # once per op
    with policy.apply(strict_tiles=True):
        with pytest.raises(ValueError, match="ignored on the ref path"):
            registry.dispatch("scan", x, impl="ref", block=64)
    with jax_policy.apply(strict_tiles=True):
        with pytest.raises(ValueError, match="ignored on the ref path"):
            jax_registry.dispatch("scan", jx, impl="ref", block=64)
    monkeypatch.setenv("REPRO_STRICT_TILES", "1")
    assert policy.current().strict_tiles and jax_policy.current().strict_tiles
    with policy.apply(variants={"transpose": {"bt": 32}}):
        with pytest.raises(ValueError, match=r"\['bt'\]"):
            registry.dispatch("transpose", x, impl="jnp")
    monkeypatch.setenv("REPRO_STRICT_TILES", "0")
    assert not policy.current().strict_tiles


class _OnCuda:
    """Stands in for a CUDA tensor where a rule reads only the device."""

    device = torch.device("cuda")


# (choice, device type, has_vjp, differentiable, fits) -> backend, or the
# exception on the card where JAX would fall back to its oracle quietly
ROUTE_CASES = [
    ("auto", "cpu", True, True, True, "pallas"),
    ("auto", "cuda", True, True, True, "pallas"),
    ("pallas", "cpu", True, True, True, "pallas"),
    ("pallas", "cuda", False, False, True, "pallas"),
    ("jnp", "cpu", True, True, True, "jnp"),
    ("ref", "cpu", False, False, True, "jnp"),
    ("jnp", "cuda", True, True, True, NotImplementedError),
    ("ref", "cuda", True, False, True, NotImplementedError),
    ("auto", "cpu", False, True, True, "jnp"),
    ("auto", "cuda", False, True, True, NotImplementedError),
    ("pallas", "cuda", False, True, True, NotImplementedError),
    ("auto", "cpu", True, True, False, "jnp"),
    ("auto", "cuda", True, True, False, NotImplementedError),
    ("auto", "meta", True, True, True, "pallas"),  # the kernels' output shapes
]


@pytest.mark.parametrize("case", ROUTE_CASES, ids=lambda c: "-".join(map(str, c[:5])))
def test_route_rule_per_device(case):
    choice, device_type, has_vjp, differentiable, fits, want = case
    spec = registry.KernelSpec(name="op", kernel=None, ref=None, plan=None, has_vjp=has_vjp)
    if isinstance(want, str):
        assert registry.route(spec, choice, device_type, differentiable=differentiable,
                              fits=fits) == want
    else:
        with pytest.raises(want, match="op"):
            registry.route(spec, choice, device_type, differentiable=differentiable,
                           fits=fits)


def test_resolve_and_dispatch_device_rule_without_a_card():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    # differentiable callers (the default): ops without a backward fall back
    # to the oracle on the CPU, as JAX's resolve does, and raise on the card
    for op in registry.names():
        if registry.get(op).has_vjp:
            assert registry.resolve(op, device=cpu) == registry.resolve(op, device=cuda) \
                == "pallas"
        else:
            assert registry.resolve(op, device=cpu) == "jnp"
            with pytest.raises(NotImplementedError, match="no backward"):
                registry.resolve(op, device=cuda)
            assert registry.resolve(op, device=cuda, differentiable=False) == "pallas"
    # the needs gate: a custom softmax scale
    assert registry.resolve("attention", device=cpu, softmax_scale=0.5) == "jnp"
    with pytest.raises(NotImplementedError, match="needs gate"):
        registry.resolve("attention", device=cuda, softmax_scale=0.5)
    with pytest.raises(NotImplementedError, match="needs gate"):
        registry.dispatch("attention", _OnCuda(), _OnCuda(), _OnCuda(), softmax_scale=0.5)
    with policy.apply(impl={"matmul": "ref"}):
        with pytest.raises(NotImplementedError, match="plain version"):
            registry.dispatch("matmul", _OnCuda(), _OnCuda())
    # interpret has no meaning on the card; on the CPU the plain version runs
    with pytest.raises(ValueError, match="interpret"):
        registry.dispatch("scan", _OnCuda(), interpret=True)
    with policy.apply(variants={"scan": {"interpret": True}}):
        with pytest.raises(ValueError, match="interpret"):
            registry.dispatch("scan", _OnCuda())
    x = torch.ones(2, 128)
    with policy.apply(interpret=True):
        with pytest.raises(ValueError, match="interpret"):
            registry.dispatch("scan", _OnCuda())
        assert torch.equal(registry.dispatch("scan", x), bp_scan_plain(x, 128))


def test_memoized_route_follows_the_policy(monkeypatch):
    # a route memoized under one policy does not outlive it: a scope, then
    # the environment, sends matmul to the oracle, which drops K2's tile
    # kwargs with a warning where the wrapper rejects them
    a = torch.randn(16, 16, generator=torch.Generator().manual_seed(0))
    want = ref.matmul_ref(a, a)
    assert torch.equal(registry.dispatch("matmul", a, a), want)
    with pytest.raises(TypeError):
        registry.dispatch("matmul", a, a, bm=16)
    with policy.apply(impl={"matmul": "ref"}):
        with pytest.raises(NotImplementedError, match="plain version"):
            registry.dispatch("matmul", _OnCuda(), _OnCuda())
        with pytest.warns(UserWarning, match="ignored on the ref path"):
            assert torch.equal(registry.dispatch("matmul", a, a, bm=16), want)
    with pytest.raises(TypeError):
        registry.dispatch("matmul", a, a, bm=16)
    registry.reset_warnings()
    monkeypatch.setenv("REPRO_IMPL", "matmul=ref")
    with pytest.warns(UserWarning, match="ignored on the ref path"):
        registry.dispatch("matmul", a, a, bm=16)
    monkeypatch.delenv("REPRO_IMPL")
    with pytest.raises(TypeError):
        registry.dispatch("matmul", a, a, bm=16)


@pytest.mark.parametrize("op", ["matmul", "attention"])
def test_forward_without_a_gradient_skips_autograd(op):
    # under no_grad (serving) the two model ops call their forward directly;
    # with a gradient to record they go through their autograd Function
    g = torch.Generator().manual_seed(0)
    if op == "matmul":
        args = [torch.randn(32, 32, generator=g) for _ in "ab"]
    else:
        args = [torch.randn(1, 8, 2, 16, generator=g) for _ in "qkv"]
    for x in args:
        x.requires_grad_(True)
    with torch.no_grad():
        plain = registry.dispatch(op, *args)
    recorded = registry.dispatch(op, *args)
    assert plain.grad_fn is None and recorded.grad_fn is not None
    assert torch.equal(plain, recorded.detach())


def test_policy_fields_and_parse_match_jax(monkeypatch):
    for op in registry.names():
        spec = f"{op}=pallas:interpret=true,*=auto"
        assert policy.parse_impl_spec(spec) == jax_policy.parse_impl_spec(spec)
        assert policy.ExecutionPolicy(impl={op: "jnp"}).impl_for(op) == "jnp"
    with pytest.raises(ValueError, match="unknown op"):
        policy.parse_impl_spec("conv=pallas")
    monkeypatch.setenv("REPRO_IMPL", "matmul=pallas:backend=classical")
    monkeypatch.setenv("REPRO_INTERPRET", "1")
    monkeypatch.setenv("REPRO_STRICT_TILES", "true")
    pol, jpol = policy.ambient(), jax_policy.ambient()
    assert (pol.interpret, pol.strict_tiles) == (jpol.interpret, jpol.strict_tiles) == (True, True)
    assert pol.describe() == jpol.describe()
    with policy.pin("attention", "jnp", reason="a test") as pinned:
        assert pinned.impl_for("attention") == "jnp" and pinned.reason == "a test"
        assert policy.current() is pinned
    with policy.pin_if(False, "attention", "jnp", reason="off") as nothing:
        assert nothing is None and policy.current().impl_for("attention") == "auto"
    with policy.pin_if(True, "fft", "ref", reason="on"):
        assert policy.current().impl_for("fft") == "ref"
