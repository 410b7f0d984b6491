"""Golden-value unit tests for the CPU oracle.

Every assertion here pins a value from the reference's own printf test
harnesses (testFisher.c, testcss.c — see SURVEY.md §4), turning the
reference's eyeball tests into real asserted tests.  The oracle is then the
trusted parity anchor for the device kernels.
"""

import math

import numpy as np
import pytest

from divergence_tpu.oracle import reference as orc


# ----------------------------------------------------------------- FET ----


def test_fet_point_prob_goldens():
    # reference testFisher.c:467-472
    assert orc.fet_point_prob(1, 9, 11, 3) == pytest.approx(0.001346076, rel=1e-5)
    assert orc.fet_point_prob(0, 10, 12, 2) == pytest.approx(0.000033652, rel=1e-4)
    assert orc.fet_point_prob(9, 3, 1, 6) == pytest.approx(0.0166, rel=1e-2)


def test_fet_two_tailed_goldens():
    # reference testFisher.c:474-500
    assert orc.fet_two_tailed(2, 7, 8, 2) == pytest.approx(0.0230141, rel=1e-5)
    assert orc.fet_two_tailed(2, 3, 6, 4) == pytest.approx(0.6083916, rel=1e-5)
    # tables whose two-tail sum exceeds 1 clamp to 1 (cFisher.c:451-452)
    assert orc.fet_two_tailed(2, 2, 3, 3) == 1.0
    assert orc.fet_two_tailed(1, 3, 2, 3) == 1.0


def test_fet_c_replica_tie_semantics():
    """fet_two_tailed_c_replica reproduces the reference's fp-luck on
    interior second-tail ties (docs/PARITY.md deviation 7(b)) while the
    framework rule excludes them deterministically; off tie tables the
    two agree exactly.  The two tables below were dissected from
    randomized differential runs against the compiled C: x=2 ties the
    observed table at exactly 22/91, and the C's recurrence rounds one
    ulp below P0 and includes it."""
    from fractions import Fraction

    for f in [(4, 7, 0, 4), (4, 0, 7, 4)]:
        rep = orc.fet_two_tailed_c_replica(*f)
        ours = orc.fet_two_tailed(*f)
        assert rep == pytest.approx(0.5164835164835164, rel=1e-15)
        assert ours == pytest.approx(0.27472527472527475, rel=1e-15)

    rng = np.random.default_rng(3)
    checked = agreed = 0
    for _ in range(400):
        f = [int(x) for x in rng.integers(0, 13, size=4)]
        R1, C1 = f[0] + f[1], f[0] + f[2]
        n = sum(f)
        if n == 0:
            continue
        # exact tie detection over the support
        pobs = (Fraction(math.comb(R1, f[0]))
                * Fraction(math.comb(n - R1, C1 - f[0])))
        tied = any(
            Fraction(math.comb(R1, x))
            * Fraction(math.comb(n - R1, C1 - x)) == pobs
            for x in range(max(0, C1 - (n - R1)), min(R1, C1) + 1)
            if x != f[0]
        )
        if tied:
            continue
        checked += 1
        if orc.fet_two_tailed_c_replica(*f) == pytest.approx(
            orc.fet_two_tailed(*f), rel=1e-12
        ):
            agreed += 1
    assert checked > 200 and agreed == checked


def test_fet_two_tailed_vs_scipy():
    # Cross-check the Zar shortcut against scipy's two-sided FET on a grid.
    # The shortcut (cFisher.c:405-455) walks the minimum cell to zero
    # unconditionally; for tables observed near the mode this sums *across*
    # the mode and is conservative (p larger than scipy's minimum-likelihood
    # sum, clamped at 1).  For genuine tail tables the two agree.
    from scipy.stats import fisher_exact

    rng = np.random.default_rng(7)
    agree = 0
    total = 0
    for _ in range(300):
        f = [int(x) for x in rng.integers(0, 12, size=4)]
        ours = orc.fet_two_tailed(*f)
        sp = min(
            fisher_exact([[f[0], f[1]], [f[2], f[3]]],
                         alternative="two-sided")[1],
            1.0,
        )
        total += 1
        if ours == pytest.approx(sp, rel=1e-9, abs=1e-12):
            agree += 1
        else:
            # disagreement must be the conservative near-mode overshoot
            # (or a strict-vs-nonstrict tie on the second tail)
            assert ours > sp - 1e-9, (f, ours, sp)
    assert agree / total > 0.6


def test_shift_table_golden():
    # reference testFisher.c:450-465: [3,5,2,7] -> [2,3,7,5]
    assert orc._shift_table([3, 5, 2, 7]) == [2, 3, 7, 5]


def test_fetcount_golden():
    # reference testFisher.c:416-448, SNP index 0 of the 2-SNP fixture
    avals = np.array([3, 3, 0, -10000, 3, -3, 0, 0, 0, 3], dtype=float)
    bvals = np.array([-3, -3, 0, -10000, -3, -3, 3, 3, 3, 0], dtype=float)
    assert orc.fet_count(avals, bvals) == (4, 1, 3, 4)


def test_percentile_goldens():
    # reference testFisher.c:389-400
    vals = np.array(
        [43, 54, 56, 61, 62, 66, 68, 69, 69, 70, 71, 72, 77, 78, 79,
         85, 87, 88, 89, 93, 95, 96, 98, 99, 99], dtype=float)
    assert orc.percentile_interp(vals, 0.90) == pytest.approx(97.2)
    vals2 = np.arange(10, dtype=float)
    assert orc.percentile_interp(vals2, 0.5) == pytest.approx(4.5)


def test_std_mean_goldens():
    # reference testFisher.c:346-387
    vals = np.arange(1, 11, dtype=float)
    assert np.mean(vals) == pytest.approx(5.5)
    assert np.sqrt(np.mean((vals - vals.mean()) ** 2)) == pytest.approx(
        2.8722813232690143
    )


def test_binomial_goldens():
    # reference testFisher.c:410-414 (incl. the near-overflow C(67,31))
    assert math.comb(5, 3) == 10
    assert math.comb(40, 19) == 131282408400
    assert math.comb(67, 31) == 11923179284862717872


# ----------------------------------------------------------------- CSS ----


def test_compare_freq_golden():
    # reference testcss.c:337-367
    a = np.array([[0.75], [0.3], [0.2]])
    b = np.array([[0.2], [0.5], [0.75]])
    d = orc.compare_freq(a, b)
    assert d[0, 1] == pytest.approx(0.4333333333, rel=1e-6)
    assert d[1, 0] == pytest.approx(0.4333333333, rel=1e-6)
    assert d[0, 0] == 0 and d[1, 1] == 0


def test_compare_all_hand_computed():
    # reference testcss.c:369-420 fixture (prints without goldens);
    # pairwise mismatch counts verified by hand:
    # A0=(-3,0) A1=(3,3) B0=(3,-10000) B1=(-3,0)
    avals = np.array([[-3, 3], [0, 3]], dtype=float)   # [npos=2, asize=2]
    bvals = np.array([[3, -3], [-10000, 0]], dtype=float)
    d = orc.compare_all(avals, bvals)
    expected = np.array(
        [[0, 1, 1, 0],
         [1, 0, 0, 1],
         [1, 0, 0, 1],
         [0, 1, 1, 0]], dtype=float)
    np.testing.assert_array_equal(d, expected)


def test_fill_averages_golden():
    # reference testcss.c:422-473: offdiag i+j, avg = 80/25 = 3.2
    m = 5
    d = np.add.outer(np.arange(m), np.arange(m)).astype(float)
    np.fill_diagonal(d, 0.0)
    filled = orc.fill_averages(d)
    assert filled is not None
    assert filled[0, 0] == pytest.approx(3.2)
    assert filled[2, 2] == pytest.approx(3.2)
    assert filled[0, 1] == 1.0  # valued cells untouched

    # second part: zero out first/last col+row and diagonal -> discard
    d2 = d.copy()
    np.fill_diagonal(d2, 0.0)
    d2[:, 0] = 0; d2[:, m - 1] = 0; d2[0, :] = 0
    assert orc.fill_averages(d2) is None


def test_calc_dist_golden():
    # reference testcss.c:475-509
    a = np.array([[0.0, 1.0], [1.0, 2.0]])
    d = orc.calc_dist(a)
    assert d[0, 1] == pytest.approx(1.41421356)
    assert d[0, 0] == 0.0


def test_cmds_golden_distances():
    # reference testcss.c:569-630.  GSL eigenvector signs are arbitrary, and
    # CSS only consumes pairwise distances (css.c:221-222), so parity is on
    # the distance matrix of the embedding.
    dis = np.array(
        [[0, 4.05, 8.25, 5.57],
         [4.05, 0, 2.54, 2.69],
         [8.25, 2.54, 0, 2.11],
         [5.57, 2.69, 2.11, 0]])
    golden_x = np.array(
        [[4.62, 0.07], [0.09, -1.11], [-3.63, -0.34], [-1.08, 1.38]])
    x = orc.cmds(dis)
    np.testing.assert_allclose(
        orc.calc_dist(x), orc.calc_dist(golden_x), atol=0.02
    )


def test_stress_golden():
    # reference testcss.c:796-838
    delta = np.array(
        [[0, 5, 3, 4], [5, 0, 2, 2], [3, 2, 0, 1], [4, 2, 1, 0]], dtype=float)
    d = np.array(
        [[0, 1.068, 0.412, 1.065],
         [1.068, 0, 0.655, 0.706],
         [0.412, 0.655, 0, 0.792],
         [1.065, 0.706, 0.792, 0]])
    # the fixture's D is printed to 3 decimals in testcss.c, so the golden
    # only holds to ~1e-3
    assert orc._stress(delta, d) == pytest.approx(34.29899413, abs=2e-3)


def test_smacof_golden():
    # reference testcss.c:632-699: fixed init, deterministic trajectory
    dis = np.array(
        [[0, 5, 3, 4], [5, 0, 2, 2], [3, 2, 0, 1], [4, 2, 1, 0]], dtype=float)
    x0 = np.array(
        [[-0.266, -0.539], [0.451, 0.252], [0.016, -0.238], [-0.200, 0.524]])
    x, sigma = orc.smacof(dis, x0)
    golden = np.array(
        [[-1.457, -2.575], [1.730, 1.23], [-0.028, 0.16], [-0.245, 1.185]])
    np.testing.assert_allclose(x, golden, atol=0.01)


def test_css_golden():
    # reference testcss.c:701-751: 100-point ramp, expected 70.5975410337
    m, dims = 100, 2
    x = np.add.outer(np.arange(m), np.arange(dims)).astype(float)
    dist = orc.calc_dist(x)
    result = orc.css_score(dist, np.arange(50), np.arange(50, 100))
    assert result == pytest.approx(70.5975410337, abs=1e-5)


def test_setup_z_matrix_semantics():
    # reference testcss.c:888-908: Z = I - 1/m has 0.75 diag, -0.25 off
    m = 4
    z = np.eye(m) - np.ones((m, m)) / m
    assert z[0, 0] == pytest.approx(0.75)
    assert z[0, 1] == pytest.approx(-0.25)


def test_significance_estimator():
    # p = (hits+1)/(n+1) (css.c:750); an unbeatable score stops at `runs`
    dist = orc.calc_dist(np.random.default_rng(3).random((6, 2)))
    rng = np.random.default_rng(5)
    # score far above anything reachable -> zero hits, n = runs
    p = orc.significance(dist, 3, 3, 1e9, threshold=10, runs=500, rng=rng)
    assert p == pytest.approx(1 / 501)
    # score far below -> every permutation hits, stops at threshold
    rng = np.random.default_rng(5)
    p = orc.significance(dist, 3, 3, -1e9, threshold=10, runs=500, rng=rng)
    assert p == pytest.approx(11 / 11)


# ------------------------------------------------------------ windowing ----


def test_window_starts_match_reference_loop():
    # while (start + wsize <= regend + wstep) (css.c:117)
    starts = orc.window_starts(regend=10_000, wsize=2500, wstep=500)
    assert starts[0] == 0
    assert starts[-1] + 2500 <= 10_000 + 500
    assert starts[-1] + 500 + 2500 > 10_000 + 500
    # num windows == regend/wstep - 3 for the default geometry
    # (threadcss.c:60 quirk holds when wstep | regend)
    assert len(starts) == 10_000 // 500 - 3


def test_window_bounds_slide_right_semantics():
    pos = np.array([0, 5, 10, 10, 15, 20, 25])
    lo, hi = orc.window_bounds(pos, 5, 20)  # start <= pos <= stop
    assert (lo, hi) == (1, 6)
    lo, hi = orc.window_bounds(pos, 6, 9)
    assert (lo, hi) == (2, 2)  # empty window


def test_population_size():
    assert orc.population_size(np.array([2, 2, 2, 4, 4, 4])) == 3
    assert orc.population_size(np.array([7])) == 1
