"""Parity tests: device FET kernel vs the CPU oracle."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from divergence_tpu.kernels import fet as kfet
from divergence_tpu.oracle import reference as orc


def _random_tables(rng, n, hi=12):
    return rng.integers(0, hi, size=(n, 4)).astype(np.int32)


def test_two_tailed_parity_random_tables(rng):
    tables = _random_tables(rng, 500)
    nmax = int(tables.sum(1).max()) + 2
    maxs = nmax // 2 + 2
    got = np.asarray(kfet.fet_two_tailed(jnp.asarray(tables), maxs, nmax))
    want = np.array([orc.fet_two_tailed(*map(int, t)) for t in tables])
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)


def test_two_tailed_goldens():
    tables = jnp.asarray(
        [[2, 7, 8, 2], [2, 3, 6, 4], [2, 2, 3, 3], [1, 3, 2, 3], [0, 0, 0, 0]],
        dtype=jnp.int32,
    )
    got = np.asarray(kfet.fet_two_tailed(tables, maxs=12, nmax=24))
    np.testing.assert_allclose(
        got[:4], [0.0230141, 0.6083916, 1.0, 1.0], rtol=1e-5
    )
    assert got[4] == 1.0  # all-missing SNP: degenerate table clamps to 1


def test_count_tables(rng):
    avals = rng.choice([3.0, -3.0, 0.0, -10000.0], size=(5, 7, 11))
    bvals = rng.choice([3.0, -3.0, 0.0, -10000.0], size=(5, 7, 10))
    got = np.asarray(kfet.count_tables(jnp.asarray(avals), jnp.asarray(bvals)))
    for w in range(5):
        for k in range(7):
            assert tuple(got[w, k]) == orc.fet_count(avals[w, k], bvals[w, k])


def _batch_from_windows(windows, P, asize, bsize):
    B = len(windows)
    av = np.zeros((B, P, asize))
    bv = np.zeros((B, P, bsize))
    npos = np.zeros(B, dtype=np.int64)
    for i, (aw, bw) in enumerate(windows):
        n = aw.shape[0]
        av[i, :n] = aw
        bv[i, :n] = bw
        npos[i] = n
    return av, bv, npos


def test_window_scores_match_oracle(rng, panel):
    apos, aflat, bpos, bflat, positions, amat, bmat = panel
    asize, bsize = amat.shape[1], bmat.shape[1]
    wsize, wstep, regend, perc = 2500, 500, 20_000, 0.95

    windows = []
    oracle_scores = []
    for start in orc.window_starts(regend, wsize, wstep):
        lo, hi = orc.window_bounds(positions, int(start), int(start) + wsize)
        if hi - lo <= 0:
            continue
        aw, bw = amat[lo:hi], bmat[lo:hi]
        windows.append((aw, bw))
        s, _, _ = orc.window_fet(aw, bw, perc, nsamples=10)
        oracle_scores.append(s)

    P = int(max(w[0].shape[0] for w in windows))
    P = 1 << (P - 1).bit_length()
    av, bv, npos = _batch_from_windows(windows, P, asize, bsize)

    maxs = kfet.support_size(asize, bsize)
    scores, stddev = kfet.fet_window_batch(
        jnp.asarray(av),
        jnp.asarray(bv),
        jnp.asarray(npos),
        perc,
        jax.random.PRNGKey(0),
        nsamples=100,
        maxs=maxs,
        nmax=asize + bsize + 2,
    )
    np.testing.assert_allclose(
        np.asarray(scores), np.array(oracle_scores), rtol=1e-9, atol=1e-12
    )
    # stddev is RNG-stream dependent; assert statistical plausibility:
    # positive for windows with score dispersion, same order of magnitude
    # as an oracle rerun.
    stddev = np.asarray(stddev)
    assert (stddev >= 0).all()
    oracle_std = np.array(
        [
            orc.window_fet(aw, bw, perc, 100, np.random.default_rng(1))[1]
            for aw, bw in windows
        ]
    )
    big = oracle_std > 1e-3
    assert np.allclose(stddev[big], oracle_std[big], rtol=1.0, atol=0.05)


def test_sorted_percentile_matches_oracle(rng):
    for n in (1, 2, 5, 37, 100):
        vals = rng.standard_normal(n)
        for perc in (0.0, 0.5, 0.9, 0.95, 1.0):
            want = orc.percentile_interp(vals, perc)
            P = 128
            padded = np.full(P, -np.inf)
            padded[:n] = vals
            srt = jnp.sort(jnp.asarray(padded))[None, :]
            npos = jnp.asarray([n])
            idx, hi_idx, delta = kfet._interp_ranks(npos, perc)
            v_lo = kfet._sorted_pick(srt, npos, idx[..., None])[..., 0]
            v_hi = kfet._sorted_pick(srt, npos, hi_idx[..., None])[..., 0]
            got = (1.0 - delta) * v_lo + delta * v_hi
            assert np.asarray(got)[0] == pytest.approx(want, rel=1e-12), (n, perc)


def test_bootstrap_orderstat_distributional_parity(rng):
    """The order-statistic bootstrap must match the oracle's explicit
    resampling bootstrap in distribution: compare the stddev estimates
    window-by-window over many windows (both are ~6-10%-noisy estimates
    of the same population quantity with S=100)."""
    B, P, asize, bsize = 64, 64, 11, 10
    av = rng.choice([3.0, -3.0, 0.0, -10000.0], size=(B, P, asize),
                    p=[0.45, 0.35, 0.15, 0.05])
    bv = rng.choice([3.0, -3.0, 0.0, -10000.0], size=(B, P, bsize),
                    p=[0.45, 0.35, 0.15, 0.05])
    npos = np.full(B, P, dtype=np.int64)
    _, std_k = kfet.fet_window_batch(
        jnp.asarray(av), jnp.asarray(bv), jnp.asarray(npos),
        0.95, jax.random.PRNGKey(3),
        nsamples=400, maxs=kfet.support_size(asize, bsize),
        nmax=asize + bsize + 2,
    )
    std_k = np.asarray(std_k)
    g = np.random.default_rng(9)
    std_o = np.array([
        orc.window_fet(av[i], bv[i], 0.95, 400, g)[1] for i in range(B)
    ])
    # window-wise agreement within bootstrap noise
    both = np.maximum(std_k, std_o)
    ok = np.isclose(std_k, std_o, rtol=0.35, atol=0.02)
    assert ok.mean() > 0.9, (std_k[~ok], std_o[~ok])
    # aggregate agreement much tighter
    assert np.mean(std_k) == pytest.approx(np.mean(std_o), rel=0.05)


def test_shift_min_first_matches_oracle(rng):
    tables = rng.integers(0, 15, size=(300, 4)).astype(np.int32)
    got = np.asarray(kfet._shift_min_first(jnp.asarray(tables)))
    for t, g in zip(tables, got):
        want = orc._shift_table([int(x) for x in t])
        assert list(g) == want, (t, g, want)


def test_support_size_bound(rng):
    """The static support bound must cover every achievable table."""
    for asize, bsize in ((11, 10), (3, 2), (1, 1), (20, 20)):
        maxs = kfet.support_size(asize, bsize)
        for _ in range(200):
            # achievable tables only: homozygous counts within each panel
            f0 = int(rng.integers(0, asize + 1))
            f1 = int(rng.integers(0, asize - f0 + 1))
            f2 = int(rng.integers(0, bsize + 1))
            f3 = int(rng.integers(0, bsize - f2 + 1))
            s = orc._shift_table([f0, f1, f2, f3])
            hi = min(s[0] + s[1], s[0] + s[2])
            assert hi < maxs


def test_steps_max_covers_kernel_dtype_ranks():
    """Regression: the Renyi loop bound must be computed with the
    kernel's own dtype arithmetic.  A float32 (n-1)*perc can floor one
    BELOW the Python-f64 value, so the in-kernel t1 = n-1-idx exceeds a
    f64-derived bound, the capture mask never fires, and every bootstrap
    replicate's order statistic pins to the window max (stddev -> 0)."""
    percs = (0.05, 0.25, 0.29, 0.58, 0.84, 0.95, 0.999)
    old_formula_too_small = False
    for dtype in (jnp.float32, jnp.float64):
        for perc in percs:
            # fixed sizes plus every P <= 1024 where f32 rank rounding
            # disagrees with f64 at the batch size itself (the only
            # place the old f64-only formula could be undersized)
            divergent = [
                n
                for n in range(2, 1025)
                if int(np.floor(np.float32(n - 1) * np.float32(perc)))
                != int((n - 1) * perc)
            ]
            for P in (64, 333, 1024, *divergent[:8]):
                npos = jnp.arange(1, P + 1)
                idx, _, _ = kfet._interp_ranks(npos, perc, dtype=dtype)
                t1 = int(np.max(np.asarray(npos - 1 - idx)))
                bound = kfet._steps_max(P, perc, dtype)
                assert t1 <= bound, (float(perc), P, dtype, t1, bound)
                old = P - 1 - int((P - 1) * perc)
                if t1 > old:
                    old_formula_too_small = True
    # the sweep must include at least one case the round-1 f64-only
    # formula got wrong, or this test guards nothing
    assert old_formula_too_small


def test_bootstrap_stddev_nonzero_at_f32_rounding_boundary(rng):
    """End-to-end guard at a (npos, perc) where f32 rank rounding
    disagrees with f64: fast-mode bootstrap stddev must not collapse."""
    # find a window size whose f32 idx floors below the f64 idx
    perc, n_div = 0.84, None
    for n in range(4, 1024):
        f32_idx = int(np.floor(np.float32(n - 1) * np.float32(perc)))
        if f32_idx < int((n - 1) * perc):
            n_div = n
            break
    assert n_div is not None
    asize, bsize = 11, 10
    aw = rng.choice([3.0, -3.0, 0.0], size=(n_div, asize))
    bw = rng.choice([3.0, -3.0], size=(n_div, bsize))
    av, bv, npos = _batch_from_windows([(aw, bw)], n_div, asize, bsize)
    maxs = kfet.support_size(asize, bsize)
    _, std = kfet.fet_window_batch(
        jnp.asarray(av), jnp.asarray(bv), jnp.asarray(npos),
        perc, jax.random.key(5), 100, maxs, 2 * (asize + bsize) + 2,
        fast=True,
    )
    assert float(std[0]) > 0.0


def test_snp_logs_lut_path_bit_identical(rng):
    """fet_snp_logs' table-LUT fast path (active when the possible-table
    grid is much smaller than the chromosome) must be bit-identical to
    the direct per-SNP support scan."""
    asize, bsize = 3, 2
    G = (asize + 1) ** 2 * (bsize + 1) ** 2
    N = 4 * G  # comfortably past the 2G <= N static switch
    av = rng.choice([3.0, -3.0, 0.0, -10000.0], size=(N, asize))
    bv = rng.choice([3.0, -3.0, 0.0, -10000.0], size=(N, bsize))
    maxs = kfet.support_size(asize, bsize)
    nmax = asize + bsize + 2
    for fast in (False, True):
        dtype = jnp.float32 if fast else jnp.float64
        got = kfet.fet_snp_logs(
            jnp.asarray(av), jnp.asarray(bv), maxs, nmax, fast=fast
        )
        tables = kfet.count_tables(jnp.asarray(av), jnp.asarray(bv))
        # the per-precision score function (linear f64 / log-space f32,
        # round 5 — the f32 variant never materializes p, so large-panel
        # underflow can't poison it)
        direct = kfet._neglog10_p(tables, maxs, nmax, dtype)
        if not fast:
            # f64: bitwise — the exact-parity anchor
            assert (np.asarray(got) == np.asarray(direct)).all()
        else:
            # f32: the log-space score's reductions vectorize
            # differently for the [G] grid vs the [N] per-SNP shape
            # (last-ulp); the switch being panel-STATIC means only one
            # branch ever runs for a given panel, so cross-branch
            # bitwise identity is not load-bearing — roundoff agreement
            # is the invariant
            np.testing.assert_allclose(
                np.asarray(got), np.asarray(direct), rtol=1e-6, atol=1e-7
            )
        # f32 log-space agrees with the f64 linear reference within the
        # fast-mode band wherever both are finite and away from ties
        if fast:
            ref = -jnp.log10(
                kfet.fet_two_tailed(tables, maxs, nmax, dtype=jnp.float64)
            )
            np.testing.assert_allclose(
                np.asarray(got), np.asarray(ref), rtol=2e-5, atol=2e-5
            )


def test_bootstrap_stddev_batching_invariant(rng):
    """The bootstrap stream is slot-pinned (perm.slot_keys): evaluating a
    set of windows as ONE batch or as arbitrary sub-batches must give
    bit-identical stddev (docs/PARITY.md "Stream identity")."""
    N, B, P = 512, 24, 32
    snp_logs = jnp.asarray(rng.exponential(size=N))
    lo = rng.integers(0, N - P, size=B)
    npos = rng.integers(1, P + 1, size=B)
    slot = rng.permutation(np.arange(100, 100 + B))
    key = jax.random.PRNGKey(13)

    def agg(sel):
        return kfet.fet_aggregate_windows(
            snp_logs, jnp.asarray(lo[sel]), jnp.asarray(npos[sel]),
            jnp.asarray(slot[sel]), 0.95, key, nsamples=50, P=P,
        )

    s_all, d_all = agg(np.arange(B))
    for split in (2, 3):
        parts = np.array_split(np.arange(B), split)
        s_cat = np.concatenate([np.asarray(agg(p)[0]) for p in parts])
        d_cat = np.concatenate([np.asarray(agg(p)[1]) for p in parts])
        assert (np.asarray(s_all) == s_cat).all()
        assert (np.asarray(d_all) == d_cat).all()


def test_rank_path_bit_identical(rng):
    """The rank-space aggregation (int32 sort over LUT ranks,
    fet_snp_ranks_joint + fet_aggregate_all_ranks — round 5) must be
    BIT-identical to the float path (fet_snp_logs_joint +
    fet_aggregate_all) in both precisions: same multiset of values per
    window, same rank arithmetic, same slot-pinned bootstrap stream."""
    asize, bsize = 3, 2
    G = (asize + 1) ** 2 * (bsize + 1) ** 2
    N = 4 * G
    vals = jnp.asarray(
        rng.choice([3.0, -3.0, 0.0, -10000.0], size=(N, asize + bsize))
    )
    maxs = kfet.support_size(asize, bsize)
    nmax = asize + bsize + 2
    assert kfet.lut_active(asize, bsize, N)

    B, P, Bp = 24, 32, 8
    lo = rng.integers(0, N - P, size=B)
    npos = rng.integers(0, P + 1, size=B)  # include empty windows
    slot = rng.permutation(np.arange(50, 50 + B))
    rows = jnp.asarray(np.stack([lo, npos, slot]).astype(np.int64))
    # plan-ordered variant (ascending lo) — the two-stage gather's
    # contract (engine rows are always in plan order)
    order = np.argsort(lo, kind="stable")
    rows_sorted = jnp.asarray(
        np.stack([lo[order], npos[order], slot[order]]).astype(np.int64)
    )
    key = jax.random.PRNGKey(3)

    for fast in (False, True):
        snp_logs = kfet.fet_snp_logs_joint(vals, asize, maxs, nmax, fast=fast)
        lut_sorted, ranks = kfet.fet_snp_ranks_joint(
            vals, asize, maxs, nmax, fast=fast
        )
        # the compressed representation reconstructs the per-SNP logs
        assert (
            np.asarray(jnp.take(lut_sorted, ranks)) == np.asarray(snp_logs)
        ).all()
        want = np.asarray(kfet.fet_aggregate_all(
            snp_logs, rows, key, Bp=Bp, P=P, perc=0.95, nsamples=40,
            fast=fast,
        ))
        got = np.asarray(kfet.fet_aggregate_all_ranks(
            lut_sorted, ranks, rows, key, Bp=Bp, P=P, perc=0.95,
            nsamples=40, fast=fast,
        ))
        assert (got == want).all()
        assert np.count_nonzero(got[0]) > 0
        # two-stage gather (round 5): same values through a
        # dynamic_slice + local gather — bit-identical at any valid L
        for L in (kfet.slice_span_bound(
            np.sort(lo), B, Bp, P, N
        ), N // 2):
            if L is None:
                continue
            got_l = np.asarray(kfet.fet_aggregate_all_ranks(
                lut_sorted, ranks, rows_sorted, key, Bp=Bp, P=P,
                perc=0.95, nsamples=40, fast=fast, L=L,
            ))
            want_l = np.asarray(kfet.fet_aggregate_all_ranks(
                lut_sorted, ranks, rows_sorted, key, Bp=Bp, P=P,
                perc=0.95, nsamples=40, fast=fast,
            ))
            assert (got_l == want_l).all()


def test_pick_gather_fallback_matches_onehot(rng, monkeypatch):
    """The large-B*S*P gather fallback for the bootstrap picks must be
    bit-identical to the one-hot contraction (the gate is a pure memory
    tradeoff; round-5 review asked for the branch to be CI-covered
    rather than first exercised on a huge production chromosome)."""
    import jax

    from divergence_tpu.config import FetConfig, WindowConfig
    from divergence_tpu.engine import run_fet
    from divergence_tpu.engine.snp import SnpPair

    npos, region = 600, 30_000
    positions = np.sort(rng.choice(np.arange(1, region), npos, replace=False))
    av = rng.choice([3.0, -3.0, 0.0, -10000.0], size=(npos, 5))
    bv = rng.choice([3.0, -3.0, 0.0, -10000.0], size=(npos, 4))
    cfg = FetConfig(window=WindowConfig(2500, 500), bootstrap_samples=8)
    out = {}
    for label, fits in (("onehot", True), ("gather", False)):
        monkeypatch.setattr(kfet, "_onehot_pick_fits", lambda *a: fits)
        jax.clear_caches()  # the gate is trace-time; force a retrace
        pair = SnpPair(positions=positions, avals=av, bvals=bv)
        for prec in ("exact", "fast"):
            cfg_p = FetConfig(
                window=cfg.window, bootstrap_samples=8, precision=prec
            )
            out[(label, prec)] = run_fet(pair, region, cfg_p)
    monkeypatch.undo()
    jax.clear_caches()
    for prec in ("exact", "fast"):
        s1, sd1 = out[("onehot", prec)]
        s2, sd2 = out[("gather", prec)]
        np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
        np.testing.assert_array_equal(np.asarray(sd1), np.asarray(sd2))
