"""The port's simulator core (``repro_torch.core``: ``hbp``, ``machine``,
``layouts``, ``algorithms``, ``pws.PWS``, ``rws.RWS``) and its value-level
algorithms (``algorithms_torch``) against the JAX package's.

Each program is built at a small size by both packages and run on one
``Machine(p, M, B)`` under ``PWS`` and under a seeded ``RWS``: the ``Stats``
must be equal field for field (work, cache and block misses per core, every
steal with its time, priority, thief and victim, steal attempts, idle time,
makespan, usurpations).  The structural checks, the layouts and the
registry's ``simulator_program`` (node count and access trace) must agree
exactly.  ``algorithms_torch`` at f32 against ``algorithms_jax``: prefix
sums within rtol 1e-5 + atol 1e-4 (two cumsums summing in other orders),
Strassen within rtol 1e-4 + atol 1e-3 (seven-way combinations of N(0, 1)
256 x 256 products, entries up to ~60), the six-step FFT within 1e-5 of
the largest output, the BI layout ops bit for bit; list ranking and
connected components exactly equal.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import algorithms as jax_algorithms  # noqa: E402
from repro.core import algorithms_jax, hbp as jax_hbp, layouts as jax_layouts  # noqa: E402
from repro.core import machine as jax_machine, pws as jax_pws, rws as jax_rws  # noqa: E402
from repro.kernels import registry as jax_registry  # noqa: E402
from repro_torch.core import algorithms, algorithms_torch, costmodel, hbp, layouts  # noqa: E402
from repro_torch.core import machine, pws, rws  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402

P, M, B = 4, 256, 16
SIDES = {"port": (algorithms, hbp, machine, pws, rws),
         "jax": (jax_algorithms, jax_hbp, jax_machine, jax_pws, jax_rws)}

# name -> builder(algorithms module, hbp module): a program or a program list
PROGRAMS = {
    "MSum": lambda alg, h: alg.MSum(512, h.Memory(B)),
    "prefix_sums": lambda alg, h: alg.prefix_sums_programs(256, h.Memory(B)),
    "MTBI": lambda alg, h: alg.MTBI(16, h.Memory(B)),
    "RMtoBI": lambda alg, h: alg.RMtoBI(16, h.Memory(B)),
    "BItoRMDirect": lambda alg, h: alg.BItoRMDirect(16, h.Memory(B)),
    "BItoRMGapped": lambda alg, h: alg.bi_to_rm_gapped_programs(16, h.Memory(B)),
    "strassen": lambda alg, h: alg.strassen_program(16, h.Memory(B), base=4),
    "fft": lambda alg, h: alg.fft_program(256, h.Memory(B)),
    "list_ranking_gapped": lambda alg, h: alg.list_ranking_phase_programs(
        1024, h.Memory(B), gapped=True),
    "list_ranking_compact": lambda alg, h: alg.list_ranking_phase_programs(
        1024, h.Memory(B), gapped=False),
}


def _run(side, name, sched, p=P):
    alg, h, mach, pws_mod, rws_mod = SIDES[side]
    progs = PROGRAMS[name](alg, h)
    s = pws_mod.PWS() if sched == "pws" else rws_mod.RWS(seed=7)
    m = mach.Machine(p, M, B, scheduler=s)
    st = m.run_sequence(progs) if isinstance(progs, list) else m.run(progs)
    return dataclasses.asdict(st)


@pytest.mark.parametrize("sched", ["pws", "rws"])
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_stats_equal_jax(name, sched):
    got, want = _run("port", name, sched), _run("jax", name, sched)
    assert got == want
    assert got["accesses"] > 0 and got["finish_time"] > 0


@pytest.mark.parametrize("p", [1, 3])
def test_stats_equal_jax_other_core_counts(p):
    for sched in ("pws", "rws"):
        assert _run("port", "MSum", sched, p) == _run("jax", "MSum", sched, p)


def test_padded_machine_and_steal_costs_equal_jax():
    for side_p, side_j in ((machine, jax_machine),):
        got = side_p.Machine(P, M, B, scheduler=pws.PWS(steal_cost=3.0), padded=True).run(
            algorithms.MSum(256, hbp.Memory(B)))
        want = side_j.Machine(P, M, B, scheduler=jax_pws.PWS(steal_cost=3.0),
                              padded=True).run(jax_algorithms.MSum(256, jax_hbp.Memory(B)))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    got = machine.Machine(P, M, B, scheduler=rws.RWS(seed=1, steal_cost=2.0)).run(
        algorithms.MTBI(16, hbp.Memory(B)))
    want = jax_machine.Machine(P, M, B, scheduler=jax_rws.RWS(seed=1, steal_cost=2.0)).run(
        jax_algorithms.MTBI(16, jax_hbp.Memory(B)))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _progs(side, name):
    alg, h = SIDES[side][:2]
    progs = PROGRAMS[name](alg, h)
    return progs if isinstance(progs, list) else [progs]


@pytest.mark.parametrize("name", [n for n in PROGRAMS if n not in ("strassen", "fft")])
def test_structural_checks_equal_jax(name):
    for prog, jprog in zip(_progs("port", name), _progs("jax", name), strict=True):
        assert hbp.check_balance(prog) == jax_hbp.check_balance(jprog)
        assert hbp.check_limited_access(prog) == jax_hbp.check_limited_access(jprog)
        assert hbp.measure_cache_friendliness(prog, B) == \
            jax_hbp.measure_cache_friendliness(jprog, B)
        assert hbp.measure_block_sharing(prog, B) == jax_hbp.measure_block_sharing(jprog, B)


@pytest.mark.parametrize("name", ["strassen", "fft"])
def test_type2_structural_checks_equal_jax(name):
    prog, jprog = _progs("port", name)[0], _progs("jax", name)[0]
    assert hbp.check_limited_access(prog) == jax_hbp.check_limited_access(jprog)
    assert hbp.measure_cache_friendliness(prog, B) == jax_hbp.measure_cache_friendliness(jprog, B)


def test_layouts_equal_jax():
    rng = np.random.default_rng(0)
    r, c = rng.integers(0, 1 << 12, 500), rng.integers(0, 1 << 12, 500)
    np.testing.assert_array_equal(layouts.bi_index(r, c), jax_layouts.bi_index(r, c))
    z = rng.integers(0, 1 << 24, 500)
    for got, want in zip(layouts.bi_coords(z), jax_layouts.bi_coords(z)):
        np.testing.assert_array_equal(got, want)
    for n in (1, 2, 4, 16, 64):
        np.testing.assert_array_equal(layouts.rm_to_bi_perm(n), jax_layouts.rm_to_bi_perm(n))
        np.testing.assert_array_equal(layouts.bi_to_rm_perm(n), jax_layouts.bi_to_rm_perm(n))
        m = rng.standard_normal((n, n))
        np.testing.assert_array_equal(layouts.rm_to_bi(m), jax_layouts.rm_to_bi(m))
        flat = rng.standard_normal(n * n)
        np.testing.assert_array_equal(layouts.bi_to_rm(flat, n), jax_layouts.bi_to_rm(flat, n))
        np.testing.assert_array_equal(layouts.gapped_row_starts(n),
                                      jax_layouts.gapped_row_starts(n))
        assert layouts.gapped_size(n) == jax_layouts.gapped_size(n)
        assert layouts.inorder_positions(n) == jax_layouts.inorder_positions(n)
    for r_ in range(0, 5000, 37):
        assert layouts.gap_for(r_) == jax_layouts.gap_for(r_)
    for m_, n_ in ((1, 1024), (16, 1024), (64, 4096), (4096, 4096), (5000, 4096)):
        np.testing.assert_array_equal(layouts.gapped_list_positions(m_, n_),
                                      jax_layouts.gapped_list_positions(m_, n_))


def _trace(progs):
    """Every node of each program, SEQ children (Type 2 collections)
    included, in one fixed order, with its accesses."""
    out = []
    for prog in (progs if isinstance(progs, list) else [progs]):
        stack = [prog.root]
        while stack:
            v = stack.pop()
            seq = getattr(v, "seq_children", None)
            out.append((v.lo, v.hi, v.depth, prog.priority(v), seq is not None,
                        tuple(prog.head_accesses(v)),
                        tuple(prog.leaf_accesses(v) if v.is_leaf else prog.up_accesses(v))))
            if seq is not None:
                stack.extend(reversed(seq))
            elif not v.is_leaf:
                stack.extend((v.right, v.left))
    return out


@pytest.mark.parametrize("op, n", [("scan", 256), ("matmul", 16), ("transpose", 16),
                                   ("fft", 256)])
def test_simulator_program_matches_jax(op, n):
    got, want = registry.simulator_program(op, n), jax_registry.simulator_program(op, n)
    assert len(_trace(got)) == len(_trace(want)) > 1
    assert _trace(got) == _trace(want)
    with pytest.raises(KeyError, match="no registered simulator"):
        registry.simulator_program("attention", n)
    assert [s for s in registry.names() if registry.get(s).simulator is not None] == \
        ["fft", "matmul", "scan", "transpose"]


# -- algorithms_torch against algorithms_jax ----------------------------------------

def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("shape, block", [((1000,), 128), ((3, 4096), 256), ((2, 77), 32)])
def test_prefix_sums_match_jax(shape, block):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = algorithms_torch.prefix_sums(torch.from_numpy(x), block).numpy()
    np.testing.assert_allclose(got, _np(algorithms_jax.prefix_sums(jnp.asarray(x), block)),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, np.cumsum(x, -1), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n", [2, 8, 32])
def test_bi_layout_ops_match_jax(n):
    rng = np.random.default_rng(n)
    m = rng.standard_normal((n, n)).astype(np.float32)
    flat = torch.from_numpy(m.reshape(-1))
    jflat = jnp.asarray(m.reshape(-1))
    np.testing.assert_array_equal(algorithms_torch.rm_to_bi(torch.from_numpy(m)).numpy(),
                                  _np(algorithms_jax.rm_to_bi(jnp.asarray(m))))
    for f in ("bi_to_rm", "bi_to_rm_gapped", "mt_bi"):
        np.testing.assert_array_equal(getattr(algorithms_torch, f)(flat, n).numpy(),
                                      _np(getattr(algorithms_jax, f)(jflat, n)))
    bi = algorithms_torch.rm_to_bi(torch.from_numpy(m))
    np.testing.assert_array_equal(algorithms_torch.bi_to_rm(
        algorithms_torch.mt_bi(bi, n), n).numpy(), m.T)


@pytest.mark.parametrize("n, leaf", [(64, 64), (256, 64), (128, 16)])
def test_strassen_matches_jax(n, leaf):
    rng = np.random.default_rng(n + leaf)
    a, b = (rng.standard_normal((n, n)).astype(np.float32) for _ in "ab")
    got = algorithms_torch.strassen(torch.from_numpy(a), torch.from_numpy(b), leaf).numpy()
    want = _np(algorithms_jax.strassen(jnp.asarray(a), jnp.asarray(b), leaf))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got, a.astype(np.float64) @ b, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n", [16, 256, 4096])
def test_fft_six_step_matches_jax(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    got = algorithms_torch.fft_six_step(torch.from_numpy(x)).numpy()
    want = _np(algorithms_jax.fft_six_step(jnp.asarray(x)))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(got - np.fft.fft(x.astype(np.complex128))).max() <= 1e-5 * scale


@pytest.mark.parametrize("n", [10, 500, 5000])
def test_list_ranking_and_components_equal_jax(n):
    rng = np.random.default_rng(n)
    order = rng.permutation(n)
    succ = np.empty(n, dtype=np.int64)
    succ[order[:-1]] = order[1:]
    succ[order[-1]] = order[-1]
    got = algorithms_torch.list_ranking(succ)
    np.testing.assert_array_equal(got, algorithms_jax.list_ranking(succ))
    np.testing.assert_array_equal(algorithms_torch.list_ranking_oracle(succ),
                                  algorithms_jax.list_ranking_oracle(succ))
    np.testing.assert_array_equal(got, algorithms_torch.list_ranking_oracle(succ))
    edges = rng.integers(0, n, (n // 2, 2))
    np.testing.assert_array_equal(algorithms_torch.connected_components(n, edges),
                                  algorithms_jax.connected_components(n, edges))
    np.testing.assert_array_equal(algorithms_torch.connected_components(n, edges[:0]),
                                  algorithms_jax.connected_components(n, edges[:0]))


# -- the paper's bounds (``costmodel``), as tests/test_pws.py and
# -- tests/test_hbp_type2.py hold the JAX simulator to them, at their sizes

BOUND_P, BOUND_M, BOUND_B = 8, 512, 16


def _bound_run(progs, p=BOUND_P):
    m = machine.Machine(p, BOUND_M, BOUND_B, scheduler=pws.PWS())
    return m.run_sequence(progs) if isinstance(progs, list) else m.run(progs)


def _excess(build):
    """Cache misses under PWS on ``BOUND_P`` cores less the sequential ones."""
    return (_bound_run(build()).total_cache_misses()
            - _bound_run(build(), p=1).total_cache_misses())


def test_costmodel_equals_jax_on_a_grid():
    from repro.core import costmodel as jax_cost
    from repro_torch.core import costmodel as cost

    public = sorted(n for n in dir(jax_cost) if not n.startswith("_") and n not in
                    ("annotations", "math"))
    assert public == sorted(n for n in dir(cost) if not n.startswith("_") and n not in
                            ("annotations", "math"))
    assert cost.table1_asymptotics() == jax_cost.table1_asymptotics()
    for x in (0.5, 1, 2, 3, 1 << 20):
        assert cost.log2(x) == jax_cost.log2(x)
    for p in (1, 4, 8):
        for M_ in (256, 512, 1 << 20):
            for B_ in (8, 16, 64):
                assert cost.pws_cache_excess_bp(p, M_, B_) == jax_cost.pws_cache_excess_bp(p, M_, B_)
                assert cost.steals_bound(p, B_) == jax_cost.steals_bound(p, B_)
                for n in (4, 256, 1 << 14):
                    assert (cost.pws_block_excess_bp(p, B_, n)
                            == jax_cost.pws_block_excess_bp(p, B_, n))
                    for c in (1, 2):
                        for s_kind in ("sqrt", "quarter"):
                            kw = dict(c=c, s_kind=s_kind)
                            assert (cost.pws_cache_excess_type2(p, M_, B_, n, **kw)
                                    == jax_cost.pws_cache_excess_type2(p, M_, B_, n, **kw))
                            assert (cost.pws_block_excess_type2(p, B_, n, **kw)
                                    == jax_cost.pws_block_excess_type2(p, B_, n, **kw))
                    for mkn in ((n, n, n), (n, 3, 7)):
                        assert (cost.seq_cache_complexity_mm(*mkn, M_, B_)
                                == jax_cost.seq_cache_complexity_mm(*mkn, M_, B_))


def _steals_per_priority():
    st = _bound_run(algorithms.MSum(4096, hbp.Memory(BOUND_B)))
    for pr, cnt in st.steals_per_priority().items():
        assert cnt <= BOUND_P - 1, (pr, cnt)


def _steal_attempts():
    n = 4096
    st = _bound_run(algorithms.MSum(n, hbp.Memory(BOUND_B)))
    assert st.steal_attempts <= costmodel.steals_bound(BOUND_P, int(math.log2(n)) + 2)


def _scan_cache_excess():
    ex = _excess(lambda: algorithms.MSum(1 << 14, hbp.Memory(BOUND_B)))
    assert ex <= 4 * costmodel.pws_cache_excess_bp(BOUND_P, BOUND_M, BOUND_B), ex


def _mt_cache_excess():
    ex = _excess(lambda: algorithms.MTBI(64, hbp.Memory(BOUND_B)))
    assert ex <= 4 * costmodel.pws_cache_excess_bp(BOUND_P, BOUND_M, BOUND_B), ex


def _block_miss_excess():
    st = _bound_run(algorithms.MSum(1 << 14, hbp.Memory(BOUND_B)))
    bound = costmodel.pws_block_excess_bp(BOUND_P, BOUND_B, 1 << 14)
    assert st.total_block_misses() <= 2 * bound, (st.total_block_misses(), bound)


def _prefix_sums_excess():
    ex = _excess(lambda: algorithms.prefix_sums_programs(1 << 13, hbp.Memory(BOUND_B)))
    assert ex <= 8 * costmodel.pws_cache_excess_bp(BOUND_P, BOUND_M, BOUND_B), ex


def _strassen_type2():
    st = _bound_run(algorithms.strassen_program(16, hbp.Memory(BOUND_B), base=4))
    for pr, cnt in st.steals_per_priority().items():
        assert cnt <= BOUND_P - 1
    ex = _excess(lambda: algorithms.strassen_program(16, hbp.Memory(BOUND_B), base=4))
    bound = costmodel.pws_cache_excess_type2(BOUND_P, BOUND_M, BOUND_B, 16 * 16, c=1,
                                             s_kind="quarter")
    assert ex <= 8 * max(bound, 1), (ex, bound)


def _fft_type2():
    n = 1 << 10
    ex = _excess(lambda: algorithms.fft_program(n, hbp.Memory(BOUND_B)))
    bound = costmodel.pws_cache_excess_type2(BOUND_P, BOUND_M, BOUND_B, n, c=2,
                                             s_kind="sqrt")
    assert ex <= 8 * bound, (ex, bound)


BOUNDS = {
    "obs_4_3_steals_per_priority": _steals_per_priority,
    "cor_4_1_steal_attempts": _steal_attempts,
    "lemma_4_4_scan_cache_excess": _scan_cache_excess,
    "lemma_4_4_mt_cache_excess": _mt_cache_excess,
    "lemma_4_8_block_miss_excess": _block_miss_excess,
    "lemma_4_4_prefix_sums_excess": _prefix_sums_excess,
    "lemma_4_1_strassen_type2": _strassen_type2,
    "lemma_4_1_fft_type2": _fft_type2,
}


@pytest.mark.parametrize("name", list(BOUNDS))
def test_port_simulator_meets_the_papers_bounds(name):
    """The port's ``Machine`` under ``PWS`` within the bounds (and the
    constants) that tests/test_pws.py and tests/test_hbp_type2.py assert
    for the JAX simulator, at p 8, M 512, B 16."""
    BOUNDS[name]()
