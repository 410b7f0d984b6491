"""Parity tests: device CSS kernels vs the CPU oracle."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from divergence_tpu.kernels import css as kcss
from divergence_tpu.kernels import perm as kperm
from divergence_tpu.oracle import reference as orc


def _window_batch(rng, B=12, P=64, asize=5, bsize=4):
    vals = rng.choice([3.0, -3.0, 0.0, -10000.0], size=(B, P, asize + bsize),
                      p=[0.4, 0.3, 0.2, 0.1])
    npos = rng.integers(3, P + 1, size=B)
    mask = np.arange(P)[None, :] < npos[:, None]
    vals = np.where(mask[..., None], vals, 0.0)
    return vals, npos


def test_dissimilarity_counts_vs_oracle(rng):
    vals, npos = _window_batch(rng)
    mask = jnp.arange(vals.shape[1])[None, :] < jnp.asarray(npos)[:, None]
    got = np.asarray(kcss.dissimilarity_counts(jnp.asarray(vals), mask))
    for b in range(vals.shape[0]):
        aw = vals[b, : npos[b], :5]
        bw = vals[b, : npos[b], 5:]
        want = orc.compare_all(aw, bw)
        np.testing.assert_array_equal(got[b], want)


def test_fill_averages_vs_oracle(rng):
    vals, npos = _window_batch(rng)
    mask = jnp.arange(vals.shape[1])[None, :] < jnp.asarray(npos)[:, None]
    dis = kcss.dissimilarity_counts(jnp.asarray(vals), mask)
    filled, keep = kcss.fill_averages(dis)
    filled, keep = np.asarray(filled), np.asarray(keep)
    for b in range(vals.shape[0]):
        want = orc.fill_averages(np.asarray(dis)[b])
        if want is None:
            assert not keep[b]
        else:
            assert keep[b]
            np.testing.assert_allclose(filled[b], want, rtol=1e-12)


def test_cmds_distance_parity(rng):
    # random dissimilarity-like symmetric matrices
    for _ in range(10):
        m = 9
        d = rng.random((m, m)) * 5
        d = (d + d.T) / 2
        np.fill_diagonal(d, 0)
        x_orc = orc.cmds(d)
        x_dev = np.asarray(kcss.cmds(jnp.asarray(d)[None]))[0]
        np.testing.assert_allclose(
            orc.calc_dist(x_dev), orc.calc_dist(x_orc), rtol=1e-8, atol=1e-10
        )


def test_cmds_golden_fixture():
    dis = np.array(
        [[0, 4.05, 8.25, 5.57],
         [4.05, 0, 2.54, 2.69],
         [8.25, 2.54, 0, 2.11],
         [5.57, 2.69, 2.11, 0]])
    golden_x = np.array(
        [[4.62, 0.07], [0.09, -1.11], [-3.63, -0.34], [-1.08, 1.38]])
    x = np.asarray(kcss.cmds(jnp.asarray(dis)[None]))[0]
    np.testing.assert_allclose(
        orc.calc_dist(x), orc.calc_dist(golden_x), atol=0.02
    )


def test_css_score_golden():
    # testcss.c:701-751: 100-point ramp -> 70.5975410337
    m = 100
    x = np.add.outer(np.arange(m), np.arange(2)).astype(float)
    dist = orc.calc_dist(x)
    got = np.asarray(
        kcss.css_from_dist(jnp.asarray(dist)[None], 50, 50)
    )[0]
    assert got == pytest.approx(70.5975410337, abs=1e-5)


def test_smacof_golden_fixture():
    dis = np.array(
        [[0, 5, 3, 4], [5, 0, 2, 2], [3, 2, 0, 1], [4, 2, 1, 0]], dtype=float)
    x0 = np.array(
        [[-0.266, -0.539], [0.451, 0.252], [0.016, -0.238], [-0.200, 0.524]])
    x, sigma = kcss.smacof(jnp.asarray(dis)[None], jnp.asarray(x0)[None])
    golden = np.array(
        [[-1.457, -2.575], [1.730, 1.23], [-0.028, 0.16], [-0.245, 1.185]])
    np.testing.assert_allclose(np.asarray(x)[0], golden, atol=0.01)
    want_x, want_sig = orc.smacof(dis, x0)
    np.testing.assert_allclose(np.asarray(x)[0], want_x, rtol=1e-9)
    assert np.asarray(sigma)[0] == pytest.approx(want_sig, rel=1e-9)


def test_smacof_batch_freeze_matches_serial(rng):
    # different windows converge at different iterations; the frozen batch
    # must equal per-window serial runs
    B, m = 6, 7
    dis = rng.random((B, m, m)) * 4
    dis = (dis + dis.swapaxes(-1, -2)) / 2
    for b in range(B):
        np.fill_diagonal(dis[b], 0)
    x0 = rng.random((B, m, 2))
    x, sig = kcss.smacof(jnp.asarray(dis), jnp.asarray(x0))
    for b in range(B):
        want_x, want_sig = orc.smacof(dis[b], x0[b])
        np.testing.assert_allclose(np.asarray(x)[b], want_x, rtol=1e-8)
        assert np.asarray(sig)[b] == pytest.approx(want_sig, rel=1e-8)


def test_window_batch_scores_vs_oracle(rng):
    vals, npos = _window_batch(rng, B=16, P=64)
    got_s, got_d, got_v = kcss.css_window_batch(
        jnp.asarray(vals[..., :5]),
        jnp.asarray(vals[..., 5:]),
        jnp.asarray(npos),
        jax.random.PRNGKey(0),
        asize=5,
        bsize=4,
        mds=0,
    )
    got_s = np.asarray(got_s)
    got_v = np.asarray(got_v)
    got_d = np.asarray(got_d)
    for b in range(vals.shape[0]):
        aw = vals[b, : npos[b], :5]
        bw = vals[b, : npos[b], 5:]
        score, dist = orc.window_css(aw, bw, mds=0)
        if dist is None:
            assert not got_v[b]
        else:
            assert got_v[b]
            assert got_s[b] == pytest.approx(score, rel=1e-8, abs=1e-10)
            np.testing.assert_allclose(got_d[b], dist, rtol=1e-7, atol=1e-9)


def test_drosophila_window_batch(rng):
    B, P = 4, 32
    fa = rng.random((B, P, 1))
    fb = rng.random((B, P, 1))
    npos = rng.integers(2, P + 1, size=B)
    mask = np.arange(P)[None, :] < npos[:, None]
    s, d, v = kcss.css_window_batch(
        jnp.asarray(np.where(mask[..., None], fa, 0)),
        jnp.asarray(np.where(mask[..., None], fb, 0)),
        jnp.asarray(npos),
        jax.random.PRNGKey(0),
        asize=1,
        bsize=1,
        drosophila=True,
        mds=0,
    )
    for b in range(B):
        score, dist = orc.window_css(
            fa[b, : npos[b]], fb[b, : npos[b]], drosophila=True, mds=0
        )
        assert np.asarray(v)[b]
        assert np.asarray(s)[b] == pytest.approx(score, rel=1e-8)


def test_permutation_estimator_extremes(rng):
    # unbeatable score: zero hits -> p = 1/(runs+1); trivially beaten
    # score: threshold hits at permutation `threshold` -> p = (T+1)/(T+1)
    B, m = 3, 9
    x = rng.random((B, m, 2))
    dist = np.stack([orc.calc_dist(x[b]) for b in range(B)])
    hi = np.full(B, 1e9)
    lo = np.full(B, -1e9)
    res_hi = kperm.significance(
        dist, hi, 5, 4, threshold=10, runs=1000, key=jax.random.PRNGKey(0),
        chunk=256,
    )
    np.testing.assert_allclose(res_hi.pvals, 1.0 / 1001)
    assert (res_hi.nscores == 1000).all()
    res_lo = kperm.significance(
        dist, lo, 5, 4, threshold=10, runs=1000, key=jax.random.PRNGKey(0),
        chunk=256,
    )
    np.testing.assert_allclose(res_lo.pvals, 1.0)
    assert (res_lo.nscores == 10).all()


def _numpy_mix_bits(keys, K, m):
    """Host reconstruction of kernels/perm._mix_bits."""
    st = np.asarray(jax.random.key_data(keys), dtype=np.uint64)
    ctr = np.arange(K * m, dtype=np.uint64)[None, :]

    def mix(x):
        M = np.uint64(0xFFFFFFFF)
        x = ((x ^ (x >> np.uint64(16))) * np.uint64(0x7FEB352D)) & M
        x = ((x ^ (x >> np.uint64(15))) * np.uint64(0x846CA68B)) & M
        return x ^ (x >> np.uint64(16))

    h = mix((mix(st[:, 0:1] ^ ctr) + st[:, 1:2]) & np.uint64(0xFFFFFFFF))
    return h.reshape(len(st), K, m)


@pytest.mark.parametrize("bitgen", ["mix", "threefry"])
def test_perm_scores_exact_vs_numpy_reconstruction(rng, bitgen):
    """_perm_scores must equal an explicit numpy CSS of the SAME
    permutations (reconstructed by stable argsort of the identical
    draws — f32 uniforms for threefry, raw u32 counter bits for mix) —
    pins the rank encoding, tie-break, chain weights and group
    indicator, including degenerate group sizes."""
    import jax.numpy as jnp

    for asize, bsize in ((11, 10), (5, 4), (1, 6), (2, 2)):
        m = asize + bsize
        B, K = 4, 16
        d = rng.random((B, m, m)) * 2
        d = d + d.transpose(0, 2, 1)
        for i in range(B):
            np.fill_diagonal(d[i], 0.0)
        keys = kperm.window_keys(
            jax.random.PRNGKey(7),
            jnp.full(B, 3, dtype=jnp.int64),
            jnp.arange(B, dtype=jnp.int64),
        )
        got = np.asarray(
            kperm._perm_scores(
                jnp.asarray(d, dtype=jnp.float32), keys, asize, bsize, K,
                bitgen=bitgen,
            )
        )
        if bitgen == "mix":
            x = _numpy_mix_bits(keys, K, m)
        else:
            x = np.asarray(
                jax.vmap(
                    lambda k: jax.random.uniform(
                        k, (K, m), dtype=jnp.float32
                    )
                )(keys)
            )
        w = np.zeros(m - 1)
        if asize > 1:
            w[: asize - 1] = 1.0 / (asize * asize * (asize - 1))
        if bsize > 1:
            w[asize:] = 1.0 / (bsize * bsize * (bsize - 1))
        for b in range(B):
            for k in range(K):
                p = np.argsort(x[b, k], kind="stable")
                D = d[b]
                between = D[np.ix_(p[:asize], p[asize:])].mean()
                chain = sum(
                    w[i] * D[p[i], p[i + 1]] for i in range(m - 1)
                )
                want = between - m * chain
                assert got[b, k] == pytest.approx(want, abs=2e-4), (
                    asize, bsize, b, k,
                )


def test_perm_scores_matmul_form_matches_broadcast(rng):
    """The +-1-identity matmul form must score the SAME permutations as
    the fused broadcast form to f32 rounding, including degenerate
    group sizes, and the form must plumb through mc_significance with
    an unchanged estimator."""
    import jax
    import jax.numpy as jnp

    for asize, bsize in ((11, 10), (5, 4), (1, 6), (2, 2)):
        m = asize + bsize
        B, K = 5, 33
        d = rng.random((B, m, m))
        d = d + d.transpose(0, 2, 1)
        for i in range(B):
            np.fill_diagonal(d[i], 0.0)
        keys = kperm.window_keys(
            jax.random.PRNGKey(3),
            jnp.zeros(B, dtype=jnp.int64),
            jnp.arange(B, dtype=jnp.int64),
        )
        distf = jnp.asarray(d, dtype=jnp.float32)
        bc = np.asarray(
            kperm._perm_scores(distf, keys, asize, bsize, K)
        )
        mm = np.asarray(
            kperm._perm_scores(distf, keys, asize, bsize, K, form="matmul")
        )
        np.testing.assert_allclose(mm, bc, atol=5e-4), (asize, bsize)

    # estimator parity through the adaptive loop (non-borderline scores)
    d = rng.random((6, 21, 21))
    d = d + d.transpose(0, 2, 1)
    for i in range(6):
        np.fill_diagonal(d[i], 0.0)
    keys = kperm.window_keys(
        jax.random.PRNGKey(5),
        jnp.zeros(6, dtype=jnp.int64),
        jnp.arange(6, dtype=jnp.int64),
    )
    scores = jnp.full(6, -1e9, dtype=jnp.float64)   # every perm hits
    out_bc = kperm.mc_significance(
        jnp.asarray(d), scores, keys, 11, 10, 32, 64, 10
    )
    out_mm = kperm.mc_significance(
        jnp.asarray(d), scores, keys, 11, 10, 32, 64, 10, form="matmul"
    )
    for a, b in zip(out_bc, out_mm):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_permutation_pvalues_statistical(rng):
    # p-values must agree with the oracle MC within Monte-Carlo error
    m, asize, bsize = 9, 5, 4
    x = rng.random((m, 2)) * 2
    dist = orc.calc_dist(x)
    score = orc.css_score(dist, np.arange(asize), np.arange(asize, m))
    res = kperm.significance(
        dist[None],
        np.array([score * 0.8]),
        asize,
        bsize,
        threshold=200,
        runs=20_000,
        key=jax.random.PRNGKey(1),
        chunk=2048,
    )
    p_orc = orc.significance(
        dist, asize, bsize, score * 0.8, 200, 20_000,
        np.random.default_rng(7),
    )
    # both estimate the same tail probability
    p = res.pvals[0]
    se = np.sqrt(p * (1 - p) / res.nscores[0]) + np.sqrt(
        p_orc * (1 - p_orc) / 20_000
    )
    assert abs(p - p_orc) < 6 * se + 1e-3, (p, p_orc)


def test_cmds_smacof_refinement_vs_oracle(rng):
    """mds=2 (CMDS init refined by SMACOF): deterministic path, batch
    kernel vs serial oracle on pairwise distances."""
    B, P, asize, bsize = 6, 48, 5, 4
    av = rng.choice([3.0, -3.0, 0.0], size=(B, P, asize))
    bv = rng.choice([3.0, -3.0, 0.0], size=(B, P, bsize))
    npos = np.full(B, P, dtype=np.int64)
    s, dist, valid = kcss.css_window_batch(
        jnp.asarray(av),
        jnp.asarray(bv),
        jnp.asarray(npos),
        jax.random.PRNGKey(0),
        asize=asize,
        bsize=bsize,
        mds=2,
        smacof_iters=50,
    )
    s = np.asarray(s)
    valid = np.asarray(valid)
    for b in range(B):
        want, wdist = orc.window_css(
            av[b], bv[b], mds=2, smacof_max_iters=50
        )
        if wdist is None:
            assert not valid[b]
            continue
        assert valid[b]
        assert s[b] == pytest.approx(want, rel=1e-6, abs=1e-8)


def test_smacof_scores_batching_invariant(rng):
    """SMACOF restart inits are slot-pinned (perm.slot_keys): scoring a
    set of windows as one batch or as arbitrary sub-batches must pick
    bit-identical embeddings, hence scores (docs/PARITY.md "Stream
    identity")."""
    B, P, asize, bsize = 12, 32, 5, 4
    vals, npos = _window_batch(rng, B=B, P=P, asize=asize, bsize=bsize)
    av, bv = vals[..., :asize], vals[..., asize:]
    slot = rng.permutation(np.arange(40, 40 + B))
    key = jax.random.PRNGKey(21)

    def score(sel):
        s, _, valid = kcss.css_window_batch(
            jnp.asarray(av[sel]), jnp.asarray(bv[sel]),
            jnp.asarray(npos[sel]), key, asize=asize, bsize=bsize,
            mds=1, smacof_iters=60, slot=jnp.asarray(slot[sel]),
        )
        return np.asarray(s), np.asarray(valid)

    s_all, v_all = score(np.arange(B))
    for split in (2, 3):
        parts = np.array_split(np.arange(B), split)
        s_cat = np.concatenate([score(p)[0] for p in parts])
        v_cat = np.concatenate([score(p)[1] for p in parts])
        assert (s_all == s_cat).all()
        assert (v_all == v_cat).all()
