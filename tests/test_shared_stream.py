"""Shared-permutation MC stream (mc_stream="shared", round 4).

One genome-wide label permutation per draw, shared by every window —
the Westfall-Young permutation setup (the group labels being permuted
are the same individuals genome-wide), evaluated as ONE matmul per
chunk (kernels/perm.py:_shared_coeff).  These tests pin:

* per-permutation score parity against the oracle CSS
  (reference statistics/css/css.c:608-647) on explicitly decoded
  shared permutations;
* invariance of p-values under batch composition, window_batch size,
  device sharding, and chromosome partitioning (the stream references
  only (seed, chunk), so invariance holds by construction — these
  tests keep it that way);
* the estimator limits and statistical calibration (identical
  estimator p=(hits+1)/(n+1), reference statistics/css/css.c:750);
* engine-level equivalence of scores between stream modes (scores are
  permutation-free; only the null draws differ).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from divergence_tpu.kernels import perm as kperm


def _null_dists(seed, B, m):
    rng = np.random.default_rng(seed)
    d = rng.random((B, m, m))
    d = d + d.transpose(0, 2, 1)
    for i in range(B):
        np.fill_diagonal(d[i], 0.0)
    return d


def test_shared_scores_match_oracle_css():
    """Each shared permutation's kernel score equals the oracle CSS of
    the explicitly permuted panel (reference statistics/css/css.c:608-647)."""
    from divergence_tpu.oracle import reference as oracle

    a, b, K = 11, 10, 64
    m = a + b
    d = _null_dists(1, 1, m)[0]
    distf = jnp.asarray(d[None], dtype=jnp.float32)
    key = jax.random.PRNGKey(3)
    s = np.asarray(kperm._shared_perm_scores(distf, key, 5, a, b, K))[0]
    kc = jax.random.fold_in(key, 5)
    r = np.asarray(kperm._ranks(kc[None], K, m, "mix")[0])   # [m, K]
    for k in range(K):
        inv = np.empty(m, dtype=int)
        inv[r[:, k]] = np.arange(m)     # individual at rank t
        expected = oracle.css_score(d, inv[:a], inv[a:])
        assert abs(expected - s[k]) < 1e-5


def test_shared_coeff_matches_rank_scorer():
    """The matmul coefficient matrix reproduces _scores_from_ranks on
    identical (broadcasted) ranks — same math, matmul layout."""
    a, b, K = 7, 6, 32
    m = a + b
    B = 5
    distf = jnp.asarray(_null_dists(2, B, m), dtype=jnp.float32)
    key = jax.random.PRNGKey(11)
    s_shared = np.asarray(
        kperm._shared_perm_scores(distf, key, 2, a, b, K)
    )
    kc = jax.random.fold_in(key, 2)
    r1 = kperm._ranks(kc[None], K, m, "mix")[0]
    rB = jnp.broadcast_to(r1[None], (B, m, K))
    s_ref = np.asarray(
        kperm._scores_from_ranks(distf, rB, a, b, "broadcast")
    )
    np.testing.assert_allclose(s_shared, s_ref, atol=1e-5)


def test_shared_estimator_extremes():
    """All-hit windows stop at the threshold with p=1; no-hit windows
    run to the cap with p=1/(runs+1) (reference statistics/css/css.c:727-752)."""
    a, b = 5, 4
    d = _null_dists(3, 4, a + b)
    key = jax.random.PRNGKey(0)
    lo = kperm.significance(
        d, np.full(4, -1e30), a, b, 10, 2000, key, chunk=256,
        stream="shared",
    )
    hi = kperm.significance(
        d, np.full(4, 1e30), a, b, 10, 2000, key, chunk=256,
        stream="shared",
    )
    np.testing.assert_array_equal(lo.pvals, np.ones(4))
    np.testing.assert_array_equal(lo.nscores, np.full(4, 10))
    np.testing.assert_allclose(hi.pvals, 1.0 / 2001.0)
    np.testing.assert_array_equal(hi.nscores, np.full(4, 2000))


def test_shared_batch_composition_invariance():
    """Shared-stream p-values are a pure function of (seed, chunk
    sequence): any subset, reordering, padding, or window_batch split
    reproduces the full run's values bit-identically."""
    B, a, b = 30, 5, 4
    m = a + b
    d = _null_dists(7, B, m)
    scores = np.quantile(d.reshape(B, -1), 0.75, axis=-1)
    key = jax.random.PRNGKey(5)
    full = kperm.significance(
        d, scores, a, b, 5, 1500, key, chunk=128, stream="shared"
    )
    # arbitrary subset, different order
    idx = np.array([17, 3, 29, 0, 11, 23, 8])
    sub = kperm.significance(
        d[idx], scores[idx], a, b, 5, 1500, key, chunk=128,
        stream="shared",
    )
    np.testing.assert_array_equal(full.pvals[idx], sub.pvals)
    np.testing.assert_array_equal(full.nscores[idx], sub.nscores)
    # different window_batch -> different padding/stage splits
    small = kperm.significance(
        d, scores, a, b, 5, 1500, key, chunk=128, window_batch=8,
        stream="shared",
    )
    np.testing.assert_array_equal(full.pvals, small.pvals)
    np.testing.assert_array_equal(full.hits, small.hits)


def test_shared_sharded_matches_unsharded():
    """8-device window-axis sharding reproduces the single-device
    shared-stream p-values exactly (M is replicated per shard)."""
    from divergence_tpu.parallel import make_mesh, window_sharding

    B, a, b = 24, 5, 4
    d = _null_dists(21, B, a + b)
    scores = np.quantile(d.reshape(B, -1), 0.7, axis=-1)
    key = jax.random.PRNGKey(3)
    r0 = kperm.significance(
        d, scores, a, b, 5, 2000, key, chunk=128, stream="shared"
    )
    sh = window_sharding(make_mesh(8))
    r8 = kperm.significance(
        d, scores, a, b, 5, 2000, key, chunk=128, stream="shared",
        sharding=sh,
    )
    np.testing.assert_array_equal(r0.pvals, r8.pvals)
    np.testing.assert_array_equal(r0.nscores, r8.nscores)


def test_shared_statistical_calibration():
    """Observed score at the q-quantile of ITS OWN shared null ->
    p ~= 1-q: the estimator is calibrated against the stream that
    feeds it (2000 shared permutations, 3-sigma band)."""
    B, a, b = 8, 6, 5
    m = a + b
    d = _null_dists(13, B, m)
    key = jax.random.PRNGKey(77)
    # empirical null from the stream itself (chunks 0..15)
    distf = jnp.asarray(d, dtype=jnp.float32)
    null = np.concatenate(
        [
            np.asarray(
                kperm._shared_perm_scores(distf, key, k, a, b, 256)
            )
            for k in range(8)
        ],
        axis=1,
    )                                                     # [B, 2048]
    for q in (0.5, 0.9):
        scores = np.quantile(null, q, axis=1)
        mc = kperm.significance(
            d, scores, a, b, 10**9, 2000, key, chunk=256,
            stream="shared",
        )
        p_true = 1.0 - q
        sigma = np.sqrt(p_true * (1 - p_true) / 2000)
        assert np.all(np.abs(mc.pvals - p_true) < 5 * sigma + 1e-3), (
            q, mc.pvals,
        )


def test_shared_window_modes_statistically_consistent():
    """Same windows, both stream designs: identical scores, p-values
    within joint MC error (the marginal estimator law is identical)."""
    B, a, b = 16, 6, 5
    d = _null_dists(29, B, a + b)
    scores = np.quantile(d.reshape(B, -1), 0.85, axis=-1)
    key = jax.random.PRNGKey(101)
    runs = 4000
    ps = kperm.significance(
        d, scores, a, b, 10**9, runs, key, chunk=256, stream="shared"
    ).pvals
    pw = kperm.significance(
        d, scores, a, b, 10**9, runs, key, chunk=256, stream="window"
    ).pvals
    sigma = np.sqrt(ps * (1 - ps) / runs) + np.sqrt(pw * (1 - pw) / runs)
    assert np.all(np.abs(ps - pw) < 6 * sigma + 2e-3), (ps, pw)


def test_shared_requires_xla_backend():
    d = _null_dists(1, 4, 9)
    with pytest.raises(ValueError, match="per-window streams"):
        kperm.significance(
            d, np.zeros(4), 5, 4, 10, 100, jax.random.PRNGKey(0),
            stream="shared", backend="native",
        )


def test_config_native_backend_forces_window_stream():
    from divergence_tpu.config import CssConfig

    cfg = CssConfig(perm_backend="native")
    assert cfg.mc_stream == "window"


def test_approx_shared_stream_close_to_window():
    """Pearson-III moments from shared permutations fit the same null:
    log10 p within the moment-fit tolerance of the window-stream fit."""
    B, a, b = 12, 6, 5
    m = a + b
    d = _null_dists(31, B, m)
    key = jax.random.PRNGKey(5)
    # observed scores at the null's own 0.99 quantile: p ~ 1e-2, inside
    # the moment fit's specified range (not the extreme-tail
    # extrapolation regime; see test_approx_pvalues.py for tail bounds)
    distf = jnp.asarray(d, dtype=jnp.float32)
    null = np.concatenate(
        [
            np.asarray(
                kperm._shared_perm_scores(distf, key, k, a, b, 256)
            )
            for k in range(8)
        ],
        axis=1,
    )
    scores = np.quantile(null, 0.99, axis=1)
    ps = kperm.approx_significance(
        d, scores, a, b, key, chunk=512, n_chunks=4, stream="shared"
    ).pvals
    pw = kperm.approx_significance(
        d, scores, a, b, key, chunk=512, n_chunks=4, stream="window"
    ).pvals
    assert np.all(np.abs(np.log10(ps) - np.log10(pw)) < 0.5), (ps, pw)


def test_css_engine_shared_vs_window_scores_identical():
    """Engine-level: stream mode changes ONLY the p-values' null draws;
    scores (permutation-free) are bit-identical, p log10-close."""
    from divergence_tpu.config import CssConfig
    from divergence_tpu.engine import run_css
    from divergence_tpu.engine.snp import SnpPair

    rng = np.random.default_rng(19)
    npos, region = 300, 15_000
    positions = np.sort(
        rng.choice(np.arange(1, region, dtype=np.int64), npos, replace=False)
    )

    def draw(size):
        g = rng.random((npos, size))
        return np.where(g < 0.45, 3.0, np.where(g < 0.9, 0.0, -3.0))

    pair = SnpPair(positions=positions, avals=draw(6), bvals=draw(5))
    cfg = dict(precision="fast", mc_runs=2000, mc_threshold=5)
    s_s, p_s = run_css(
        pair, region, CssConfig(mc_stream="shared", **cfg)
    )
    s_w, p_w = run_css(
        pair, region, CssConfig(mc_stream="window", **cfg)
    )
    np.testing.assert_array_equal(s_s, s_w)
    nz = s_s != 0
    assert nz.any()
    assert np.all(
        np.abs(np.log10(p_s[nz]) - np.log10(p_w[nz])) < 1.0
    ), (p_s[nz], p_w[nz])


def test_css_multi_mixed_panel_sizes():
    """run_css_multi accepts per-chromosome population sizes:
    chromosomes group by (asize, bsize) and each
    group's MC matches the per-chromosome run_css bit-identically
    (reference statistics/CategoryClusterSeparationStat.py:32-80
    processes each region independently)."""
    from divergence_tpu.config import CssConfig
    from divergence_tpu.engine import run_css
    from divergence_tpu.engine.css_engine import run_css_multi
    from divergence_tpu.engine.snp import SnpPair

    rng = np.random.default_rng(23)
    region = 12_000

    def make_pair(na, nb, npos):
        positions = np.sort(
            rng.choice(
                np.arange(1, region, dtype=np.int64), npos, replace=False
            )
        )

        def draw(size):
            g = rng.random((npos, size))
            return np.where(g < 0.45, 3.0, np.where(g < 0.9, 0.0, -3.0))

        return SnpPair(
            positions=positions, avals=draw(na), bvals=draw(nb)
        )

    pairs = {
        "chr1": (make_pair(6, 5, 250), region),
        "chr2": (make_pair(4, 4, 200), region),   # different panel
        "chr3": (make_pair(6, 5, 220), region),   # same panel as chr1
    }
    cfg = CssConfig(precision="fast", mc_runs=1000, mc_threshold=5)
    multi = run_css_multi(pairs, cfg)
    for seqid, (pair, regend) in pairs.items():
        s1, p1 = run_css(pair, regend, cfg, seqid=seqid)
        np.testing.assert_array_equal(multi[seqid][0], s1)
        np.testing.assert_array_equal(multi[seqid][1], p1)
