"""Correctness envelope at modern resequencing panel sizes (m ~ 128-200).

A large panel exercises DIFFERENT code paths than the stickleback and
drosophila panels (11+10 / 2):

* FET leaves the table-LUT regime (the grid (asize+1)^2(bsize+1)^2
  dwarfs any chromosome, `kernels/fet.py:lut_active`) — the off-LUT
  per-SNP support scan and float aggregation must match the oracle;
* the CSS dissimilarity / MDS / MC pipeline runs with m x m matrices of
  up to 200 x 200 (the eigensolver's size range is pinned in
  tests/test_linalg.py);
* the shared-stream MC's rank evaluation grows as m^2 per permutation.

The reference handles arbitrary m (reference statistics/css/css.c:277-327,
reference statistics/css/comparative.c:25-34); these tests pin the same
generality.  ``chip_smoke.py`` phase 5 runs the m = 200 shape at
chromosome scale on the GPU.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from divergence_tpu.config import CssConfig, FetConfig, WindowConfig
from divergence_tpu.engine import run_css, run_fet
from divergence_tpu.engine.snp import SnpPair
from divergence_tpu.kernels import fet as kfet
from divergence_tpu.oracle import reference as orc

WCFG = WindowConfig(wsize=2500, wstep=500)
REGEND = 8_000


def _panel_pair(rng, asize, bsize, npos=160, regend=REGEND):
    positions = np.sort(
        rng.choice(np.arange(1, regend - 100), size=npos, replace=False)
    )
    p_a = rng.uniform(0.15, 0.95, size=(npos, 1))
    p_b = np.clip(p_a + rng.normal(0, 0.25, size=(npos, 1)), 0.05, 0.95)

    def draw(p, size):
        g = rng.random((npos, size))
        het = 2 * p * (1 - p)
        mat = np.where(g < p**2, 3.0, np.where(g < p**2 + het, 0.0, -3.0))
        miss = rng.random((npos, size)) < 0.02
        return np.where(miss, -10000.0, mat)

    return SnpPair(
        positions=positions, avals=draw(p_a, asize), bvals=draw(p_b, bsize)
    )


@pytest.mark.parametrize("asize,bsize", [(70, 58), (110, 90)])
def test_fet_large_panel_matches_oracle(rng, asize, bsize):
    """m=128 and m=200: the off-LUT FET path (support scan per SNP) must
    match the oracle's per-window scores; stddev stays finite/positive."""
    pair = _panel_pair(rng, asize, bsize)
    # a 160-SNP chromosome pads to 256 << 2*(asize+1)^2(bsize+1)^2:
    # the engine takes the off-LUT float path here
    assert not kfet.lut_active(asize, bsize, 256)
    cfg = FetConfig(window=WCFG, bootstrap_samples=40)
    scores, stddev = run_fet(pair, REGEND, cfg)

    from divergence_tpu.core.windows import plan_windows

    plan = plan_windows(pair.positions, REGEND, WCFG.wsize, WCFG.wstep)
    checked = 0
    for i in np.nonzero(plan.valid_mask() & (plan.npos > 0))[0][:4]:
        lo, n = int(plan.lo[i]), int(plan.npos[i])
        want, _, logs = orc.window_fet(
            pair.avals[lo : lo + n], pair.bvals[lo : lo + n], 0.95, 1
        )
        got = scores[int(plan.slot[i])]
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
        checked += 1
    assert checked == 4
    nz = scores != 0
    assert nz.any() and (stddev[nz] >= 0).all() and np.isfinite(stddev).all()


@pytest.mark.parametrize("asize,bsize", [(70, 58), (110, 90)])
def test_css_large_panel_matches_oracle(rng, asize, bsize):
    """m=128 / m=200 CSS end-to-end: dissimilarity + fill-averages +
    CMDS (large-m eigensolves) + score vs the oracle; MC p-values
    from the m^2-rank shared evaluator are sane."""
    pair = _panel_pair(rng, asize, bsize, npos=120)
    cfg = CssConfig(window=WCFG, mc_runs=300, mc_threshold=5,
                    precision="fast")
    scores, pvals = run_css(pair, REGEND, cfg)

    from divergence_tpu.core.windows import plan_windows

    plan = plan_windows(pair.positions, REGEND, WCFG.wsize, WCFG.wstep)
    checked = 0
    for i in np.nonzero(plan.valid_mask() & (plan.npos > 0))[0][:3]:
        lo, n = int(plan.lo[i]), int(plan.npos[i])
        want, _ = orc.window_css(
            pair.avals[lo : lo + n], pair.bvals[lo : lo + n]
        )
        got = scores[int(plan.slot[i])]
        if want < 0:
            assert got == 0.0
        else:
            np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-4)
        checked += 1
    assert checked == 3
    nz = scores != 0
    assert nz.any()
    assert ((pvals[nz] > 0) & (pvals[nz] <= 1)).all()


def test_binomial_c_replica_exact_and_overflow():
    """The reference's 64-bit binomial returns 0 on unavoidable overflow
    (reference statistics/fisher/cFisher.c:268-273) — its FET is garbage
    beyond ~64 counted alleles per table, while the framework's lgamma
    path has no size limit (docs/PARITY.md deviation 1).  Pin the
    bit-faithful replica on both sides of the 2^64 boundary."""
    import math

    # exact wherever the true value fits an unsigned long
    rng = np.random.default_rng(3)
    for _ in range(500):
        n = int(rng.integers(0, 68))
        k = int(rng.integers(0, n + 1))
        true = math.comb(n, k)
        if true <= 2**64 - 1:
            assert orc.binomial_c_replica(n, k) == true
    # just-fits vs just-overflows at the boundary
    assert orc.binomial_c_replica(67, 33) == math.comb(67, 33)
    assert orc.binomial_c_replica(68, 34) == 0
    assert orc.binomial_c_replica(128, 64) == 0
    # a stickleback-scale table never overflows; a resequencing-scale
    # table does — and the oracle still returns a finite correct p
    assert not orc.fet_c_binomial_overflows(5, 6, 4, 7)
    assert orc.fet_c_binomial_overflows(50, 58, 45, 47)
    p = orc.fet_two_tailed(50, 58, 45, 47)
    assert np.isfinite(p) and 0.0 < p <= 1.0


def test_fast_mode_no_underflow_at_extreme_tables():
    """A fully-divergent large-panel table has p ~ 1e-60 — below f32's
    ~1e-38 underflow.  The f32 score path computes -log10 p in log space
    (round-5 review finding 2: the exp-then-log form returned +inf, and
    the one-hot bootstrap's pad sanitizer then fabricated a finite
    stddev).  The score must be large, FINITE, and within the fast band
    of the f64 reference; the engine's stddev must be finite too."""
    a, b = 100, 100
    npos = 40
    positions = np.arange(1, npos + 1) * 50
    amat = np.full((npos, a), 3.0)
    bmat = np.full((npos, b), -3.0)
    # engine level: extreme window, fast mode
    pair = SnpPair(positions=positions, avals=amat, bvals=bmat)
    cfg = FetConfig(window=WCFG, bootstrap_samples=16, precision="fast")
    s, sd = run_fet(pair, 4_000, cfg)
    nz = s != 0
    assert nz.any()
    assert np.isfinite(s[nz]).all(), s[nz]
    assert np.isfinite(sd[nz]).all(), sd[nz]
    # kernel level: the per-SNP f32 score equals the f64 one in band
    maxs = kfet.support_size(a, b)
    nmax = 2 * (a + b) + 2
    tables = kfet.count_tables(jnp.asarray(amat), jnp.asarray(bmat))
    f32 = np.asarray(
        kfet.fet_two_tailed_neglog10(tables, maxs, nmax, jnp.float32)
    )
    f64 = np.asarray(
        -jnp.log10(kfet.fet_two_tailed(tables, maxs, nmax, jnp.float64))
    )
    assert np.isfinite(f32).all()
    assert (f32 > 38).all()  # beyond what linear f32 could represent
    np.testing.assert_allclose(f32, f64, rtol=1e-5)
