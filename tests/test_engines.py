"""End-to-end engine parity: run_fet / run_css vs the serial CPU oracle."""

import numpy as np
import pytest

from divergence_tpu.config import CssConfig, FetConfig, WindowConfig
from divergence_tpu.engine import run_css, run_fet
from divergence_tpu.engine.snp import SnpPair
from divergence_tpu.oracle import reference as orc


@pytest.fixture(scope="module")
def pair(panel):
    apos, aflat, bpos, bflat, positions, amat, bmat = panel
    return SnpPair.from_flat(aflat, bflat, apos, bpos, 11, 10)


REGEND = 20_000
WCFG = WindowConfig(wsize=2500, wstep=500)


def test_fet_engine_matches_oracle(panel, pair):
    apos, aflat, bpos, bflat, *_ = panel
    scores, stddev = run_fet(pair, REGEND, FetConfig(window=WCFG))
    want_s, want_d = orc.compute_fet(
        aflat, bflat, apos, bpos, REGEND, WCFG.wsize, WCFG.wstep
    )
    np.testing.assert_allclose(scores, want_s, rtol=1e-9, atol=1e-12)
    # stddev: different RNG stream; same support and magnitude
    assert ((stddev > 0) == (want_d > 0)).mean() > 0.9
    both = (stddev > 1e-3) & (want_d > 1e-3)
    assert np.allclose(stddev[both], want_d[both], rtol=1.5, atol=0.05)


def test_css_engine_matches_oracle(panel, pair):
    apos, aflat, bpos, bflat, *_ = panel
    cfg = CssConfig(window=WCFG, mc_runs=2000, mc_chunk=512)
    scores, pvals = run_css(pair, REGEND, cfg)
    want_s, want_p = orc.compute_css(
        aflat, bflat, apos, bpos, REGEND, WCFG.wsize, WCFG.wstep,
        runs=2000,
    )
    np.testing.assert_allclose(scores, want_s, rtol=1e-7, atol=1e-9)
    # p-values: same estimator, independent RNG streams
    nz = want_s != 0
    assert (pvals[nz] > 0).all()
    assert ((pvals == 0) == (want_p == 0)).all()
    # MC agreement within generous statistical bounds
    # Per-window agreement: both estimates stop at ~10 hits, so each has
    # relative sd ~ 1/sqrt(10); with independent RNG streams the ratio
    # stays within a generous x6 band (>5 sigma) and the median ratio
    # near 1.  (Correlation is meaningless when most windows share the
    # same p.)
    ratio = pvals[nz] / want_p[nz]
    assert (ratio > 1 / 6).all() and (ratio < 6).all(), ratio
    assert 0.7 < np.median(ratio) < 1.4


def test_css_engine_smacof_runs(pair):
    cfg = CssConfig(
        window=WCFG, mds=1, mc_runs=500, mc_chunk=256
    )
    scores, pvals = run_css(pair, REGEND, cfg)
    cfg2 = CssConfig(window=WCFG, mds=2, mc_runs=500, mc_chunk=256)
    scores2, _ = run_css(pair, REGEND, cfg2)
    cfg0 = CssConfig(window=WCFG, mds=0, mc_runs=500, mc_chunk=256)
    scores0, _ = run_css(pair, REGEND, cfg0)
    nz = scores0 != 0
    # SMACOF embeddings differ from CMDS but measure the same separation:
    # scores correlate strongly across MDS back-ends
    assert (scores[nz] != 0).all()
    assert np.corrcoef(scores[nz], scores0[nz])[0, 1] > 0.8
    assert np.corrcoef(scores2[nz], scores0[nz])[0, 1] > 0.8


def test_empty_region():
    pair = SnpPair(
        positions=np.array([50_000]),
        avals=np.full((1, 3), 3.0),
        bvals=np.full((1, 3), 3.0),
    )
    s, d = run_fet(pair, 10_000, FetConfig(window=WCFG))
    assert not s.any() and not d.any()
    s, p = run_css(pair, 10_000, CssConfig(window=WCFG, mc_runs=100))
    assert not s.any() and not p.any()


def test_misaligned_populations_rejected():
    with pytest.raises(ValueError, match="position sets differ"):
        SnpPair.from_flat(
            np.zeros(6), np.zeros(4), np.array([1, 1, 2, 2, 3, 3]),
            np.array([1, 1, 4, 4]), 2, 2,
        )


def test_drosophila_engine_matches_oracle(rng):
    """Frequency-track mode end-to-end: 2 pseudo-individuals whose values
    are minor-allele frequencies (reference css.c:245-264); permutation
    p == 1 for every scored window (2-element permutations always tie)."""
    from divergence_tpu.config import CssConfig

    npos, region = 300, 20_000
    positions = np.sort(
        rng.choice(np.arange(1, region), npos, replace=False)
    )
    fa = rng.uniform(0.0, 1.0, (npos, 1))
    fb = rng.uniform(0.0, 1.0, (npos, 1))
    pair = SnpPair(positions=positions, avals=fa, bvals=fb)
    cfg = CssConfig(window=WCFG, drosophila=True, mc_runs=500)
    scores, pvals = run_css(pair, region, cfg)

    want_s, want_p = orc.compute_css(
        fa.ravel(),
        fb.ravel(),
        positions,
        positions,
        region,
        WCFG.wsize,
        WCFG.wstep,
        runs=500,
        drosophila=True,
    )
    np.testing.assert_allclose(scores, want_s, rtol=1e-9, atol=1e-12)
    nz = scores != 0
    assert nz.any()
    np.testing.assert_allclose(pvals[nz], 1.0)
    np.testing.assert_allclose(want_p[nz], 1.0)


def test_fast_precision_mode(panel, pair):
    """precision='fast' (float32 compute): scores agree with the exact
    path to ~1e-5 relative, structure (zero/nonzero pattern) identical."""
    s64, d64 = run_fet(pair, REGEND, FetConfig(window=WCFG))
    s32, d32 = run_fet(
        pair, REGEND, FetConfig(window=WCFG, precision="fast")
    )
    np.testing.assert_array_equal(s64 != 0, s32 != 0)
    nz = s64 != 0
    np.testing.assert_allclose(s32[nz], s64[nz], rtol=2e-4)
    assert (d32[nz] >= 0).all()

    c64, p64 = run_css(pair, REGEND, CssConfig(window=WCFG, mc_runs=500))
    c32, p32 = run_css(
        pair,
        REGEND,
        CssConfig(window=WCFG, mc_runs=500, precision="fast"),
    )
    nz = c64 != 0
    np.testing.assert_array_equal(c64 != 0, c32 != 0)
    np.testing.assert_allclose(c32[nz], c64[nz], rtol=2e-3, atol=1e-4)


def test_large_chromosome_batch_split(rng):
    """More windows than one device batch (max_batch=4096): the engine
    splits into multiple batches and still fills every slot correctly."""
    region = 2_600_000
    npos = 9000
    positions = np.sort(
        rng.choice(np.arange(1, region, dtype=np.int64), npos, replace=False)
    )
    av = rng.choice([3.0, -3.0, 0.0], size=(npos, 3))
    bv = rng.choice([3.0, -3.0, 0.0], size=(npos, 3))
    pair = SnpPair(positions=positions, avals=av, bvals=bv)
    cfg = FetConfig(window=WCFG, bootstrap_samples=4)
    scores, stddev = run_fet(pair, region, cfg)
    assert len(scores) == region // WCFG.wstep
    # spot-check a handful of windows against the oracle
    from divergence_tpu.core.windows import plan_windows

    plan = plan_windows(positions, region, WCFG.wsize, WCFG.wstep)
    valid = np.nonzero(plan.valid_mask())[0]
    assert len(valid) > 4200, "fixture must exceed one 4096 batch"
    for i in rng.choice(valid, 12, replace=False):
        lo, n = int(plan.lo[i]), int(plan.npos[i])
        want, _, _ = orc.window_fet(
            av[lo : lo + n], bv[lo : lo + n], 0.95, 2
        )
        got = scores[plan.slot[i]]
        assert got == pytest.approx(want, rel=1e-9, abs=1e-12)


def test_multi_chromosome_engines_match_looped(rng):
    """run_fet_multi / run_css_multi must reproduce per-chromosome looped
    results exactly (deterministic parts) for a 3-chromosome genome."""
    from divergence_tpu.engine.css_engine import run_css_multi
    from divergence_tpu.engine.fet_engine import run_fet_multi

    pairs = {}
    for c in range(3):
        npos, region = 250, 15_000
        positions = np.sort(
            rng.choice(np.arange(1, region), npos, replace=False)
        )
        av = rng.choice([3.0, -3.0, 0.0], size=(npos, 5))
        bv = rng.choice([3.0, -3.0, 0.0], size=(npos, 4))
        pairs[f"chr{c}"] = (
            SnpPair(positions=positions, avals=av, bvals=bv),
            region,
        )

    fcfg = FetConfig(window=WCFG, bootstrap_samples=4)
    multi = run_fet_multi(pairs, fcfg)
    for seqid, (pair, regend) in pairs.items():
        s, d = run_fet(pair, regend, fcfg, seqid=seqid)
        np.testing.assert_array_equal(multi[seqid][0], s)
        np.testing.assert_array_equal(multi[seqid][1], d)

    ccfg = CssConfig(window=WCFG, mc_runs=300, mc_chunk=128)
    multi = run_css_multi(pairs, ccfg)
    for seqid, (pair, regend) in pairs.items():
        s, p = run_css(pair, regend, ccfg, seqid=seqid)
        np.testing.assert_allclose(multi[seqid][0], s, rtol=1e-12)
        # per-window RNG streams are (seed, seqid, slot)-pinned, so the
        # genome-wide MC reproduces the per-chromosome MC bit-for-bit
        np.testing.assert_array_equal(multi[seqid][1], p)


def test_css_prefix_budget_fallback(rng, monkeypatch):
    """Above the prefix element budget the engine falls back to the
    per-bucket gather kernel with identical scores (and identical
    stream-pinned p-values)."""
    from divergence_tpu.engine import css_engine

    npos, region = 300, 15_000
    positions = np.sort(rng.choice(np.arange(1, region), npos, replace=False))
    av = rng.choice([3.0, -3.0, 0.0], size=(npos, 5))
    bv = rng.choice([3.0, -3.0, 0.0], size=(npos, 4))
    pair = SnpPair(positions=positions, avals=av, bvals=bv)
    cfg = CssConfig(window=WCFG, mc_runs=300, mc_chunk=128)

    s_pref, p_pref = run_css(pair, region, cfg, seqid="chrZ")
    monkeypatch.setattr(css_engine, "PREFIX_MAX_ELEMS", 1)
    pair2 = SnpPair(positions=positions, avals=av, bvals=bv)
    s_gath, p_gath = run_css(pair2, region, cfg, seqid="chrZ")
    np.testing.assert_allclose(s_pref, s_gath, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(p_pref, p_gath)


def test_css_gather_unroll_large_m(rng, monkeypatch):
    """The gather path at a large panel (m = 70, exact mode: ``lax.map``
    over f64 window slices with m x m eigensolves) produces the same
    scores/p as the prefix path."""
    from divergence_tpu.engine import css_engine

    npos, region = 120, 8_000
    positions = np.sort(rng.choice(np.arange(1, region), npos, replace=False))
    av = rng.choice([3.0, -3.0, 0.0], size=(npos, 40))
    bv = rng.choice([3.0, -3.0, 0.0], size=(npos, 30))
    pair = SnpPair(positions=positions, avals=av, bvals=bv)
    cfg = CssConfig(window=WCFG, mc_runs=300, mc_chunk=128)

    s_pref, p_pref = run_css(pair, region, cfg, seqid="chrZ")
    monkeypatch.setattr(css_engine, "PREFIX_MAX_ELEMS", 1)
    pair2 = SnpPair(positions=positions, avals=av, bvals=bv)
    s_gath, p_gath = run_css(pair2, region, cfg, seqid="chrZ")
    np.testing.assert_allclose(s_pref, s_gath, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(p_pref, p_gath)


def test_compact_int16_upload_identical(rng):
    """device_values(compact=True) uploads int16 for integral genotype
    codes; FET and CSS results are identical to the float upload (both
    kernels only ==-compare the values: reference statistics/fisher/cFisher.c:208-238,
    statistics/css/css.c:277-327)."""
    npos, region = 400, 20_000
    positions = np.sort(rng.choice(np.arange(1, region), npos, replace=False))
    av = rng.choice([3.0, -3.0, 0.0, -10000.0], size=(npos, 6))
    bv = rng.choice([3.0, -3.0, 0.0, -10000.0], size=(npos, 5))

    pair = SnpPair(positions=positions, avals=av, bvals=bv)
    a16, b16 = pair.device_values(compact=True)
    assert a16.dtype == np.int16 and b16.dtype == np.int16
    # the non-compact view of int16-safe values is DERIVED from the
    # cached int16 upload (float dtype, same values, no second transfer)
    af, bf = pair.device_values()
    assert af.dtype == np.float64 and bf.dtype == np.float64
    np.testing.assert_array_equal(np.asarray(a16), np.asarray(af))
    np.testing.assert_array_equal(np.asarray(b16), np.asarray(bf))

    # mixed-order consumers: a fresh pair asked float-first also ends up
    # with both views backed by the one int16 joint upload
    pair_m = SnpPair(positions=positions, avals=av, bvals=bv)
    am, _ = pair_m.device_values()
    assert am.dtype == np.float64
    assert getattr(pair_m, "_device_joint_i16", None) is not None
    # and the joint array is the A|B concatenation the engines consume
    j = pair_m.device_values_joint(compact=True)
    assert j.dtype == np.int16 and j.shape[1] == 11
    np.testing.assert_array_equal(
        np.asarray(j[:npos, :6], dtype=np.float64), av
    )
    np.testing.assert_array_equal(
        np.asarray(j[:npos, 6:], dtype=np.float64), bv
    )

    fcfg = FetConfig(window=WCFG)
    ccfg = CssConfig(window=WCFG, mc_runs=200, mc_chunk=64)
    s_c, d_c = run_fet(pair, region, fcfg, seqid="chrC")
    cs_c, cp_c = run_css(pair, region, ccfg, seqid="chrC")

    # force the genuine float-upload path (the only remaining way now
    # that the public API derives float views from the int16 upload);
    # the dtype assert guards against the private cache attr drifting
    pair_f = SnpPair(positions=positions, avals=av, bvals=bv)
    object.__setattr__(pair_f, "_i16_ok", False)
    assert pair_f.device_values(compact=True)[0].dtype != np.int16
    s_f, d_f = run_fet(pair_f, region, fcfg, seqid="chrC")
    cs_f, cp_f = run_css(pair_f, region, ccfg, seqid="chrC")
    np.testing.assert_array_equal(s_c, s_f)
    np.testing.assert_array_equal(d_c, d_f)
    np.testing.assert_array_equal(cs_c, cs_f)
    np.testing.assert_array_equal(cp_c, cp_f)


def test_compact_upload_noninteger_fallback(rng):
    """Non-integral values (drosophila frequency tracks) refuse the
    int16 form."""
    positions = np.arange(1, 51, dtype=np.int64)
    fa = rng.uniform(0.001, 0.999, size=(50, 1))
    fb = rng.uniform(0.001, 0.999, size=(50, 1))
    pair = SnpPair(positions=positions, avals=fa, bvals=fb)
    a, b = pair.device_values(compact=True)
    assert a.dtype == np.float64 and b.dtype == np.float64


def test_engine_rank_path_matches_float_path(rng, monkeypatch):
    """run_fet's LUT-rank dispatch (active when the table grid is small
    vs the chromosome, round 5) is bit-identical to the float dispatch
    on the SAME inputs — verified end-to-end by forcing lut_active off."""
    from divergence_tpu.kernels import fet as kfet

    asize, bsize = 3, 2
    n = 600  # pads to 1024 >> 2*(4^2*3^2)=288 -> rank path active
    positions = np.sort(
        rng.choice(np.arange(1, 20_000), size=n, replace=False)
    )
    av = rng.choice([3.0, -3.0, 0.0, -10000.0], size=(n, asize))
    bv = rng.choice([3.0, -3.0, 0.0, -10000.0], size=(n, bsize))
    for precision in ("exact", "fast"):
        cfg = FetConfig(window=WCFG, precision=precision)
        pair1 = SnpPair(positions=positions, avals=av, bvals=bv)
        assert kfet.lut_active(asize, bsize, 1024)
        s_rank, d_rank = run_fet(pair1, REGEND, cfg)
        monkeypatch.setattr(kfet, "lut_active", lambda *a: False)
        pair2 = SnpPair(positions=positions, avals=av, bvals=bv)
        s_float, d_float = run_fet(pair2, REGEND, cfg)
        monkeypatch.undo()
        np.testing.assert_array_equal(s_rank, s_float)
        np.testing.assert_array_equal(d_rank, d_float)
        assert np.count_nonzero(s_rank) > 0
