"""Randomized differential fuzzing against the compiled reference C.

Generates random panels (population sizes, genotype mixes, window
geometries, drosophila mode), runs the unmodified reference binaries
(baseline/build.sh, DUMP_SCORES mode) and this framework's oracle and
engine on the same GTrack pair, and compares the deterministic
per-window score columns slot by slot.

Every mismatch is ATTRIBUTED automatically:

- FET: re-scored with :func:`oracle.reference.fet_two_tailed_c_replica`
  (the bit-faithful replica of the C's IEEE op sequence).  If the
  replica matches the C, the mismatch is the C's own floating-point
  tie accident — docs/PARITY.md deviation 7(b) — not a framework bug.
- FET large panels: a window whose tables provably hit the C's 64-bit
  binomial overflow->0 path (:func:`oracle.reference
  .fet_c_binomial_overflows`, re-running the C's gcd-reduction
  algorithm in exact integers) is the reference emitting garbage
  (deviation 1) — the framework's lgamma path has no size limit.
- CSS: deviation 8's three sub-cases are detected mechanically — a
  degenerate 2nd/3rd eigenvalue of the double-centered matrix (retained
  2-D subspace solver-arbitrary), a mathematically-zero 2nd eigenvalue
  (the reference NaNs-or-not on its solver's sign noise), and for mds=2
  a perturb-and-refine stability probe (flat SMACOF stress valleys
  where a 1e-13 nudge of the start flips the eps-stopped score).
- CSS fast lane (f32, mds=2): SMACOF's absolute eps-stop is noise-
  dominated at f32 stress resolution, so the f32 path stops anywhere
  along the optimizer trajectory — attributed by the trajectory probe
  (:func:`_fast_smacof_trajectory`: the fast score must lie in the
  score range swept by the f64 trajectory from the CMDS init or an
  f32-scale-perturbed init; PARITY.md "Precision modes").

Anything NOT attributable to a documented deviation is a BUG and makes
the run exit nonzero.  This harness found the FET tie-rule divergence
that round 2 fixed (6 windows across 160 trials) AND a baseline-shim
bug (gsl_shim dgemm read C at beta=0, NaN-poisoning the reference's
reused scratch matrices across windows — real BLAS treats beta=0 as
write-only).

The helpers here (:func:`write_gtrack`, :func:`run_ref`,
:func:`ensure_binaries`, :func:`draw_trial`) are the single shared
implementation — tests/test_ref_c_differential.py imports them.

Run: ``python -m divergence_tpu.tools.fuzz_ref --trials 40 [--seed0 N]
[--sparse] [--fast] [--big-panels]``.  ``--fast`` adds the f32 engine
lane: the round-3 fast-mode NaN was found by manual
driving because this fuzzer only compared exact-mode columns.
``--big-panels`` draws 20-110 individuals per population (round 5),
straddling the FET LUT bound so the off-LUT path and large-m CSS are
differentially tested against the compiled C, not just the oracle.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[2]
BASELINE = REPO / "baseline"
CODES = np.array([3.0, -3.0, 0.0, -10000.0])


def ensure_binaries() -> bool:
    """Build (or rebuild) the reference baseline binaries when any
    input source is newer than the oldest output — a stale gsl_shim or
    faketime build would report phantom 'bugs'.  Returns False when the
    toolchain is unavailable."""
    outs = [
        BASELINE / "build" / n
        for n in ("bench_ref_fet", "bench_ref_css", "bench_ref_fet_strict",
                  "bench_ref_css_strict", "libfaketime.so")
    ]
    srcs = [
        BASELINE / "bench_ref_fet.c",
        BASELINE / "bench_ref_css.c",
        BASELINE / "gslshim" / "gsl_shim.c",
        BASELINE / "faketime.c",
        BASELINE / "build.sh",
    ]
    stale = not all(o.exists() for o in outs) or any(
        s.stat().st_mtime > min(o.stat().st_mtime for o in outs)
        for s in srcs
    )
    if stale:
        r = subprocess.run(
            ["bash", str(BASELINE / "build.sh")],
            capture_output=True,
            text=True,
        )
        if r.returncode != 0:
            return False
    return True


def write_gtrack(path, positions, mat) -> None:
    """Valued-points rows in the layout the baseline drivers read
    (5 '#' header lines, then seqid/pos/value; %.17g so frequency
    tracks round-trip exactly — the C parses this file while
    oracle/engine use the in-memory array)."""
    with open(path, "w") as f:
        for _ in range(5):
            f.write("#h\n")
        for k in range(positions.shape[0]):
            p = int(positions[k])
            for v in mat[k]:
                f.write(f"chr1\t{p}\t{v:.17g}\n")


def run_ref(binary, fa, fb, dump, extra=(), env=None, aux=False):
    """Run a baseline driver in serial DUMP_SCORES mode; returns the
    score column ([:, 1]) or (score, aux) when ``aux``."""
    e = dict(os.environ, DUMP_SCORES=str(dump))
    if env:
        e.update(env)
    r = subprocess.run(
        [str(binary), str(fa), str(fb), "serial", *map(str, extra)],
        capture_output=True,
        text=True,
        timeout=600,
        env=e,
    )
    if r.returncode != 0:
        raise RuntimeError(r.stderr[-300:])
    rows = np.loadtxt(dump, ndmin=2)
    if rows.size == 0:
        empty = np.zeros(0)
        return (empty, empty) if aux else empty
    if aux:
        return rows[:, 1], rows[:, 2]
    return rows[:, 1]


def draw_trial(rng: np.random.Generator, dros: bool, sparse: bool = False,
               big: bool = False):
    """One fuzz trial's panel + geometry (the canonical draw sequence —
    tests replaying a specific trial, e.g. the tie-heavy t6, import
    this so the claim can't silently drift).  ``sparse`` widens the
    step draw to wstep in [50, 3*wsize] (non-overlapping sampling is
    reference-legal); ``big`` draws modern-resequencing panel sizes
    (20..110 per population), straddling the FET LUT bound
    (asize+1)(bsize+1) <= 1024 so the off-LUT path is differentially
    exercised against the compiled C; the default sequence is
    unchanged."""
    npos = int(rng.integers(30, 1500))
    region = int(npos * rng.integers(15, 100))
    wsize = int(rng.integers(200, 5000))
    hi = 3 * wsize if sparse else wsize + 1
    wstep = int(rng.integers(50, hi))
    positions = np.sort(rng.choice(np.arange(1, region), npos, replace=False))
    if dros:
        asize = bsize = 1
        amat = rng.uniform(0, 1, (npos, 1))
        bmat = rng.uniform(0, 1, (npos, 1))
    else:
        lo, top = (20, 111) if big else (1, 14)
        asize = int(rng.integers(lo, top))
        bsize = int(rng.integers(lo, top))
        conc = rng.choice(
            [np.array([3, 3, 1.5, .4]), np.array([1, 1, 1, 3]),
             np.array([8, 1, 1, 1])]
        )
        probs = rng.dirichlet(conc)
        amat = rng.choice(CODES, size=(npos, asize), p=probs)
        bmat = rng.choice(CODES, size=(npos, bsize), p=probs)
    return positions, amat, bmat, asize, bsize, wsize, wstep


def _window_mds_unstable(orc, amat, bmat, positions, start, wsize, mds,
                         asize, bsize, rtol=1e-6, pert=1e-12):
    """True when the window's MDS solution is solver-dependent
    (docs/PARITY.md deviation 8): a tied 2nd/3rd CMDS eigenvalue makes
    the retained 2-D subspace arbitrary; a mathematically-zero 2nd
    eigenvalue makes the reference's sqrt NaN-or-not on sign noise; and
    for mds=2 a perturb-and-refine probe detects flat SMACOF stress
    valleys.  Also True for discarded/empty windows and for m < 3
    panels (a 2x2 dissimilarity centers to rank <= 1: the 2nd
    eigenvalue is mathematically zero by construction)."""
    lo, hi = orc.window_bounds(positions, start, start + wsize)
    if hi <= lo:
        return True
    dis = orc.compare_all(amat[lo:hi], bmat[lo:hi])
    filled = orc.fill_averages(dis)
    if filled is None:
        return True
    m = filled.shape[0]
    if m < 3:
        return True
    d2 = filled ** 2
    j = np.eye(m) - np.ones((m, m)) / m
    evals = np.sort(np.linalg.eigvalsh(-0.5 * j @ d2 @ j))[::-1]
    lead = max(abs(evals[0]), 1.0)
    if abs(evals[1] - evals[2]) <= rtol * lead:
        return True
    # mathematically-zero 2nd eigenvalue: whether the reference NaNs
    # (sqrt of its solver's -0-dust) is sign-noise luck — deviation 8(c)
    if abs(evals[1]) <= rtol * lead:
        return True
    if mds != 2:
        return False
    x0 = orc.cmds(filled)
    groups = (np.arange(asize), np.arange(asize, asize + bsize))

    def refined_score(x_init):
        x, _ = orc.smacof(filled, x_init, 300, 1e-6)
        return orc.css_score(orc.calc_dist(x), *groups)

    # random ADDITIVE perturbations at the solver's init-error scale
    # (``pert``): on flat stress valleys the eps-stop lands at
    # init-dependent points and a 1e-13 nudge flips the refined score
    # by 1e-2 (observed on fuzz trial t20/slot 165, where the
    # reference's own answer depends on its eigensolver's last ulp).
    # The f32 fast lane probes at pert=1e-6 — the f32 CMDS init's
    # rounding scale — because the f64 oracle's own scores scatter by
    # ~30% under 1e-6 nudges on such windows (measured on trial
    # t25/slot 354: eight 1e-6-perturbed inits -> scores 0.33..0.47),
    # so f32-vs-f64 divergence there is init sensitivity, not a bug.
    # A multiplicative nudge is pure scaling, which SMACOF contracts,
    # and detects nothing.
    s = refined_score(x0)
    prng = np.random.default_rng(0)
    scale = float(np.max(np.abs(x0))) or 1.0
    # 8 draws, not 3: a bifurcated stress surface can send most nudges
    # to the base basin and only occasionally cross — fuzz t45 (seed0
    # 1000) scored -0.4696 on 4 of 5 draws at pert=1e-12 and -0.4383
    # (the engine's basin) on the 5th, with the compiled C in a third
    # basin at -0.567; 3 samples called that window "stable".  The
    # window's spectrum was NOT degenerate (64% relative gap) — basin
    # choice on such surfaces flips on sub-ulp init differences, which
    # is exactly deviation 8(b).
    for _ in range(8):
        s_pert = refined_score(
            x0 + prng.normal(size=x0.shape) * pert * scale
        )
        if not np.isclose(s, s_pert, rtol=1e-6, atol=1e-8):
            return True
    return False


def _fast_smacof_trajectory(orc, amat, bmat, positions, start, wsize,
                            asize, bsize, fast_val) -> bool:
    """True when a fast-mode (f32) mds=2 score is a legitimate SMACOF
    stop point: it lies in the score range swept by the f64 optimizer
    trajectory started from the CMDS init or from f32-rounding-scale
    (1e-6) perturbations of it.

    Why this is the right differential: the reference/oracle eps-stop
    compares ABSOLUTE stress improvement against 1e-6 (css.c:907-938);
    for windows whose stress is large, f32 stress resolution is orders
    of magnitude coarser than that, so the f32 loop stops wherever
    rounding noise dips the apparent improvement below eps — any point
    on the trajectory.  Measured (seeds 9201/9212/9218/9225): fast
    scores land inside the f64 trajectory range on unconverged windows
    (t1/slot 6 runs all 301 iterations; t18/slot 38's trajectory sweeps
    [-57.6, -3.1] and fast = -51.6), and inside a 1e-6-perturbed-init
    trajectory on flat-valley windows (t25).  A genuinely wrong
    evaluator (wrong weights, wrong groups) would land OFF every
    trajectory and still fail this probe."""
    lo, hi = orc.window_bounds(positions, start, start + wsize)
    if hi <= lo:
        return False
    filled = orc.fill_averages(orc.compare_all(amat[lo:hi], bmat[lo:hi]))
    if filled is None:
        return False
    groups = (np.arange(asize), np.arange(asize, asize + bsize))
    x0 = orc.cmds(filled)

    def traj_range(x):
        d = orc.calc_dist(x)
        lo_s = hi_s = orc.css_score(d, *groups)
        s_prev, s_cur = None, orc._stress(filled, d)
        k = 0
        while k == 0 or (s_prev - s_cur > 1e-6 and k <= 300):
            s_prev = s_cur
            k += 1
            x = orc._guttman(x, d, filled)
            d = orc.calc_dist(x)
            s_cur = orc._stress(filled, d)
            sc = orc.css_score(d, *groups)
            lo_s, hi_s = min(lo_s, sc), max(hi_s, sc)
        return lo_s, hi_s

    # f32-replica CMDS init (numpy f32 centering + eigh): the closest
    # host-side stand-in for the exact init the f32 engine starts from —
    # on flat-valley windows random 1e-6 nudges can miss the engine's
    # valley but this init lands in it
    f32 = filled.astype(np.float32)
    d2 = f32 * f32
    b32 = -0.5 * (
        d2 - d2.mean(-1, keepdims=True) - d2.mean(-2, keepdims=True)
        + d2.mean()
    )
    w32, v32 = np.linalg.eigh(b32)
    vals32 = w32[::-1][:2].astype(np.float64)
    vals32[(vals32 < 0) & (vals32 > -1e-5 * max(abs(vals32[0]), 1.0))] = 0.0
    x32 = (
        v32[:, ::-1][:, :2].astype(np.float64) * np.sqrt(vals32)[None, :]
    )

    lo_v, hi_v = traj_range(x0)
    scale = float(np.max(np.abs(x0))) or 1.0
    prng = np.random.default_rng(0)
    # nudge ladder: 1e-6 = f32 arithmetic rounding; 1e-5 = the measured
    # f32 EIGENSOLVE init error (t25/slot 170: the engine's f32 CMDS
    # init deviates 6e-6 from f64 and its f64-refined score lands at
    # 0.330 vs the fast engine's 0.338 — while 1e-6 nudges never leave
    # the f64 init's 0.2697 valley)
    starts = [x32] + [
        x0 + prng.normal(size=x0.shape) * pert * scale
        for pert in (1e-6, 1e-6, 1e-5, 1e-5, 1e-5, 1e-5)
    ]
    for xs in starts:
        if lo_v - 0.02 * max(abs(lo_v), abs(hi_v), 1.0) <= fast_val \
                <= hi_v + 0.02 * max(abs(lo_v), abs(hi_v), 1.0):
            return True
        if np.isnan(xs).any():
            continue
        plo, phi = traj_range(xs)
        lo_v, hi_v = min(lo_v, plo), max(hi_v, phi)
    slack = 0.02 * max(abs(lo_v), abs(hi_v), 1.0)
    return lo_v - slack <= fast_val <= hi_v + slack


def _fast_fet_check(tag, stats, orc, compute_fet, run_fet, FetConfig, w,
                    pair, regend, eng_s, av, bv, apos, bpos, wsize, wstep):
    """Fast-mode (f32) FET lane: NaN / zero-structure checks plus a
    tolerance-banded score comparison against the exact engine.  Out-of-
    band slots are attributed to the f32 tie rule (kernels/fet.py uses
    tie_rtol=1e-5 in f32 vs 1e-12 in f64 — a table in the widened band
    flips its second-tail inclusion) by re-scoring with the oracle under
    the widened band and requiring the fast score to land in the bracket
    [exact, tie-widened] (+f32 slack).  Anything else is a bug."""
    fast_s, _ = run_fet(
        pair, regend,
        FetConfig(window=w, bootstrap_samples=2, precision="fast"),
    )
    if np.isnan(fast_s).any():
        stats["bugs"].append(
            f"{tag}: FET fast NaN slots "
            f"{np.nonzero(np.isnan(fast_s))[0][:5].tolist()}"
        )
        return
    zmis = np.nonzero(
        ((eng_s == 0.0) != (fast_s == 0.0))
        & (np.maximum(np.abs(eng_s), np.abs(fast_s)) > 1e-4)
    )[0]
    for i in zmis:
        stats["bugs"].append(
            f"{tag}: FET fast zero-structure slot {i} "
            f"exact={eng_s[i]} fast={fast_s[i]}"
        )
    # The f32 score's absolute roundoff grows with the support-scan
    # length: a p = sum of O(m) point probs each carrying ~1e-7 relative
    # error through f32 lgamma sums, so a p == 1 table can read 1 - m*eps
    # and score ~1e-5 at m ~ 140 where exact scores -0.0 (observed:
    # big-panels t8 a=49 b=88, fast 1.016e-5 vs exact -0.0).  Anchor the
    # near-zero floor at the m=21-tuned 1e-5 and scale with m; scores of
    # any significance are O(1), so the band stays ~4 orders below them.
    m = pair.avals.shape[1] + pair.bvals.shape[1]
    atol = max(1e-5, 1e-6 * m)
    bad = np.nonzero(~np.isclose(fast_s, eng_s, rtol=1e-3, atol=atol))[0]
    if not len(bad):
        return
    tie_s, _ = compute_fet(
        av, bv, apos, bpos, regend, wsize, wstep,
        two_tailed=lambda *f: orc.fet_two_tailed(*f, tie_rtol=1e-5),
    )
    for i in bad:
        lo = min(eng_s[i], tie_s[i])
        hi = max(eng_s[i], tie_s[i])
        if lo - 1e-3 * abs(lo) - atol <= fast_s[i] <= hi + 1e-3 * abs(hi) + atol:
            stats["fet_fast_tie_windows"] += 1
        else:
            stats["bugs"].append(
                f"{tag}: FET fast slot {i} exact={eng_s[i]} "
                f"fast={fast_s[i]} tie_widened={tie_s[i]}"
            )


def _fast_css_check(tag, stats, orc, run_css, CssConfig, w, pair, regend,
                    eng_c, amat, bmat, positions, wsize, wstep, mds, dros,
                    asize, bsize):
    """Fast-mode (f32) CSS lane: the round-3 fast-mode NaN (f32
    eigenvalue dust on near-singular double-centered matrices,
    kernels/css.py) was found by manual driving, not by this fuzzer —
    this lane checks it mechanically.  NaN-structure mismatches and
    out-of-band scores are attributed via the MDS-degeneracy probe at
    f32 scale (rtol=1e-4: a 2nd eigenvalue or eigengap inside f32
    eigensolve noise makes the retained subspace precision-dependent);
    anything else is a bug."""
    fast_c, _ = run_css(
        pair, regend,
        CssConfig(window=w, mc_threshold=1, mc_runs=2, mds=mds,
                  drosophila=dros, precision="fast"),
    )

    def unstable(i):
        return not dros and _window_mds_unstable(
            orc, amat, bmat, positions, i * wstep, wsize, mds,
            asize, bsize, rtol=1e-4, pert=1e-6,
        )

    nan_ex, nan_fa = np.isnan(eng_c), np.isnan(fast_c)
    for i in np.nonzero(nan_ex != nan_fa)[0]:
        if unstable(int(i)):
            stats["css_fast_degenerate_windows"] += 1
        else:
            stats["bugs"].append(
                f"{tag}: CSS fast NaN-structure mds={mds} slot {i} "
                f"exact={eng_c[i]} fast={fast_c[i]}"
            )
    both = ~nan_ex & ~nan_fa
    zmis = np.nonzero(
        both & ((eng_c == 0.0) != (fast_c == 0.0))
        & (np.maximum(np.abs(eng_c), np.abs(fast_c)) > 1e-4)
    )[0]
    for i in zmis:
        stats["bugs"].append(
            f"{tag}: CSS fast zero-structure slot {i} "
            f"exact={eng_c[i]} fast={fast_c[i]}"
        )
    # band per MDS mode: mds=0 is a single eigensolve (f32 error ~1e-5);
    # mds=2 refines through 300 SMACOF iterations whose f32 path drifts
    # from the f64 path on the way to the eps-stop — 0.05-0.3% relative
    # score differences are normal optimizer-path divergence, not bugs
    # (measured over the first smoke campaign, seeds 9100-9107)
    rtol = 1e-2 if mds == 2 else 1e-3
    bad = np.nonzero(
        both & ~np.isclose(fast_c, eng_c, rtol=rtol, atol=1e-6)
    )[0]
    for i in bad:
        if unstable(int(i)):
            stats["css_fast_degenerate_windows"] += 1
        elif mds == 2 and not dros and _fast_smacof_trajectory(
            orc, amat, bmat, positions, int(i) * wstep, wsize,
            asize, bsize, float(fast_c[i]),
        ):
            stats["css_fast_trajectory_windows"] += 1
        else:
            stats["bugs"].append(
                f"{tag}: CSS fast mds={mds} dros={dros} slot {i} "
                f"exact={eng_c[i]} fast={fast_c[i]}"
            )


def fuzz(trials: int, seed0: int, sparse: bool = False,
         fast: bool = False, big: bool = False) -> dict:
    from divergence_tpu.config import CssConfig, FetConfig, WindowConfig
    from divergence_tpu.engine.css_engine import run_css
    from divergence_tpu.engine.fet_engine import run_fet
    from divergence_tpu.engine.snp import SnpPair
    from divergence_tpu.oracle import compute_css, compute_fet
    from divergence_tpu.oracle import reference as orc

    if not ensure_binaries():
        raise RuntimeError("baseline toolchain unavailable")
    fet_bin = BASELINE / "build" / "bench_ref_fet"
    css_bin = BASELINE / "build" / "bench_ref_css"

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="fuzzref_"))
    stats = {"trials": 0, "fet_tie_windows": 0, "fet_overflow_windows": 0,
             "css_degenerate_windows": 0, "workdir": str(tmp), "bugs": []}
    if fast:
        stats["fet_fast_tie_windows"] = 0
        stats["css_fast_degenerate_windows"] = 0
        stats["css_fast_trajectory_windows"] = 0

    for trial in range(trials):
        if trial and trial % 25 == 0:
            # every trial draws fresh shapes, so XLA:CPU's in-process
            # executable cache grows without bound — a 150-trial
            # campaign died of host OOM at trial ~132 ("LLVM
            # compilation error: Cannot allocate memory", rc=139).
            # Dropping the caches bounds RSS; correctness is unaffected
            # (shapes rarely repeat across trials anyway).
            import jax

            jax.clear_caches()
        rng = np.random.default_rng(seed0 + trial)
        dros = trial % 6 == 5
        positions, amat, bmat, asize, bsize, wsize, wstep = draw_trial(
            rng, dros, sparse=sparse, big=big
        )
        regend = int(positions[-1]) + 1
        if regend // wstep == 0:
            continue
        fa, fb = tmp / "a.gtrack", tmp / "b.gtrack"
        write_gtrack(fa, positions, amat)
        write_gtrack(fb, positions, bmat)
        geom = {"WSIZE": str(wsize), "WSTEP": str(wstep)}
        w = WindowConfig(wsize=wsize, wstep=wstep)
        apos = np.repeat(positions, asize)
        bpos = np.repeat(positions, bsize)
        av = amat.reshape(-1).astype(np.float64)
        bv = bmat.reshape(-1).astype(np.float64)
        pair = SnpPair(positions=positions, avals=amat, bvals=bmat)
        tag = (f"t{trial} dros={dros} a={asize} b={bsize} "
               f"n={len(positions)} w={wsize}/{wstep}")
        stats["trials"] += 1
        n_bugs_before = len(stats["bugs"])

        if not dros:
            ref = run_ref(fet_bin, fa, fb, tmp / "f.dump", env=geom)
            orc_s, _ = compute_fet(av, bv, apos, bpos, regend, wsize, wstep)
            eng_s, _ = run_fet(
                pair, regend, FetConfig(window=w, bootstrap_samples=2)
            )
            if not np.allclose(orc_s, eng_s, rtol=1e-9, atol=1e-12):
                stats["bugs"].append(f"{tag}: FET oracle != engine")
            if fast:
                _fast_fet_check(
                    tag, stats, orc, compute_fet, run_fet, FetConfig, w,
                    pair, regend, eng_s, av, bv, apos, bpos, wsize, wstep,
                )
            bad = np.nonzero(
                ~np.isclose(ref, orc_s, rtol=1e-9, atol=1e-12)
            )[0]
            if len(bad):
                rep_s, _ = compute_fet(
                    av, bv, apos, bpos, regend, wsize, wstep,
                    two_tailed=orc.fet_two_tailed_c_replica,
                )

                def _window_c_overflows(slot):
                    # deviation 1: the reference's 64-bit binomial
                    # returns 0 on overflow (>= ~64 counted alleles per
                    # table), so its p for that SNP is 0/inf/NaN and the
                    # window's score column is garbage; the framework's
                    # lgamma path has no size limit.
                    lo, hi = orc.window_bounds(
                        positions, slot * wstep, slot * wstep + wsize
                    )
                    return any(
                        orc.fet_c_binomial_overflows(
                            *orc.fet_count(amat[k], bmat[k])
                        )
                        for k in range(lo, hi)
                    )

                for i in bad:
                    if np.isclose(ref[i], rep_s[i], rtol=1e-12, atol=1e-14):
                        stats["fet_tie_windows"] += 1  # deviation 7(b)
                    elif _window_c_overflows(int(i)):
                        stats["fet_overflow_windows"] += 1  # deviation 1
                    else:
                        stats["bugs"].append(
                            f"{tag}: FET slot {i} ref={ref[i]} "
                            f"orc={orc_s[i]} replica={rep_s[i]}"
                        )

        mds = int(rng.integers(0, 2)) * 2
        refc = run_ref(
            css_bin, fa, fb, tmp / "c.dump",
            extra=(regend, mds, int(dros)),
            env={**geom, "CSS_TRESHOLD": "1", "CSS_RUNS": "2"},
        )
        orc_c, _ = compute_css(
            av, bv, apos, bpos, regend, wsize, wstep,
            threshold=1, runs=2, mds=mds, drosophila=dros,
        )
        eng_c, _ = run_css(
            pair, regend,
            CssConfig(window=w, mc_threshold=1, mc_runs=2, mds=mds,
                      drosophila=dros),
        )
        if fast:
            _fast_css_check(
                tag, stats, orc, run_css, CssConfig, w, pair, regend,
                eng_c, amat, bmat, positions, wsize, wstep, mds, dros,
                asize, bsize,
            )
        # equal_nan: a genuinely negative 2nd eigenvalue NaNs the window
        # on BOTH sides (reference sqrt and ours) — that is agreement.
        # Classify each mismatching SLOT once (the probe is expensive
        # and a ref-vs-oracle mismatch almost always doubles as
        # ref-vs-engine).
        bad_slots: dict[int, list[str]] = {}
        for name, ours in (("oracle", orc_c), ("engine", eng_c)):
            for i in np.nonzero(
                ~np.isclose(refc, ours, rtol=1e-6, atol=1e-8,
                            equal_nan=True)
            )[0]:
                bad_slots.setdefault(int(i), []).append(
                    f"{name}={ours[i]}"
                )
        for i, sides in sorted(bad_slots.items()):
            if not dros and _window_mds_unstable(
                orc, amat, bmat, positions, i * wstep, wsize,
                mds, asize, bsize,
            ):
                stats["css_degenerate_windows"] += 1  # deviation 8
            else:
                stats["bugs"].append(
                    f"{tag}: CSS mds={mds} dros={dros} slot {i} "
                    f"ref={refc[i]} {' '.join(sides)}"
                )

        if len(stats["bugs"]) > n_bugs_before:
            # preserve the repro inputs (a.gtrack/b.gtrack get
            # overwritten by the next trial)
            shutil.copy(fa, tmp / f"trial{trial}_a.gtrack")
            shutil.copy(fb, tmp / f"trial{trial}_b.gtrack")
            print(
                f"[fuzz] BUGS {tag} "
                f"(+{len(stats['bugs']) - n_bugs_before}; inputs kept "
                f"in {tmp})",
                file=sys.stderr,
            )
        else:
            print(f"[fuzz] ok {tag}", file=sys.stderr)
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=40)
    ap.add_argument("--seed0", type=int, default=5000)
    ap.add_argument("--sparse", action="store_true",
                    help="widen the step draw to wstep <= 3*wsize")
    ap.add_argument("--big-panels", action="store_true",
                    help="draw 20..110 individuals per population "
                    "(straddles the FET LUT bound; exercises the "
                    "off-LUT path and large-m CSS vs the compiled C)")
    ap.add_argument("--fast", action="store_true",
                    help="add the precision='fast' (f32) engine lane: "
                    "NaN/zero-structure checks + tolerance-banded "
                    "comparison vs the exact engine, mismatches "
                    "attributed to the f32 tie band / MDS degeneracy")
    args = ap.parse_args(argv)
    stats = fuzz(args.trials, args.seed0, sparse=args.sparse,
                 fast=args.fast, big=args.big_panels)
    print(json.dumps(stats, indent=2))
    return 1 if stats["bugs"] else 0


if __name__ == "__main__":
    sys.exit(main())
