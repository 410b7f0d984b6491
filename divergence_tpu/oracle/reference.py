"""NumPy oracle of the reference semantics (CPU, serial).

Every function here restates — in independent NumPy/Python code — the exact
math of the reference C kernels, so the device kernels can be parity-tested
against a bit-careful CPU ground truth:

* FET:  reference statistics/fisher/cFisher.c
        (fetcount :208-238, fet :405-455, fet_p :473-483,
         percentile :136-144, calc_std :590-597)
* CSS:  reference statistics/css/css.c
        (compare_all :277-327, compare_freq :245-264, fill_averages :337-366,
         cmds :505-560, calc_dist :573-587, css :608-647,
         significance_treshold :727-752, smacof :907-938,
         smacof_runs :852-884)
* Windowing: reference statistics/css/comparative.c (slide_right :49-71)
  and the driver loops (reference statistics/css/css.c :117-136, reference statistics/fisher/cFisher.c :81-99).

Known deliberate deviations (documented, all RNG-stream-only):

* RNG: the reference seeds ``nrand48``/``drand48`` from wall-clock time
  (reference statistics/css/css.c:112-115), so its own bootstrap/permutation/SMACOF outputs are not
  reproducible run-to-run.  The oracle uses a seeded ``numpy.random
  .Generator``; deterministic quantities (FET window scores, CSS scores
  under CMDS) are bit-comparable, stochastic ones (bootstrap stddev,
  permutation p, SMACOF inits) are statistically comparable.
* ``binomial`` overflow: the reference returns 0 on unavoidable unsigned
  overflow (reference statistics/fisher/cFisher.c:268-273), corrupting p-values for huge tables.  The
  oracle uses exact Python integers; for the panel sizes this code targets
  (tables with n <= a few hundred) the two agree exactly.
"""

from __future__ import annotations

import math

import numpy as np

# ---------------------------------------------------------------------------
# Window planning (reference statistics/css/comparative.c:49-71 + driver loops)
# ---------------------------------------------------------------------------


def window_starts(regend: int, wsize: int, wstep: int) -> np.ndarray:
    """Start positions of every evaluated sliding window.

    The reference loop runs ``while (start + wsize <= regend + wstep)``
    with ``start`` stepping by ``wstep`` from 0 (reference statistics/css/css.c:117-135)."""
    if regend + wstep < wsize:
        return np.zeros(0, dtype=np.int64)
    n = (regend + wstep - wsize) // wstep + 1
    return np.arange(n, dtype=np.int64) * wstep


def window_bounds(pos: np.ndarray, start: int, stop: int) -> tuple[int, int]:
    """Row-index range [lo, hi) of SNP rows with start <= pos <= stop.

    Matches ``slide_right`` (reference statistics/css/comparative.c:49-71): the left pointer skips
    positions < start, the right pointer includes positions <= stop."""
    lo = int(np.searchsorted(pos, start, side="left"))
    hi = int(np.searchsorted(pos, stop, side="right"))
    return lo, hi


def population_size(pos: np.ndarray) -> int:
    """Run length of the first position (reference statistics/css/comparative.c:25-34)."""
    if len(pos) == 0:
        return 0
    size = 1
    while size < len(pos) and pos[size] == pos[0]:
        size += 1
    return size


# ---------------------------------------------------------------------------
# FET
# ---------------------------------------------------------------------------


def fet_count(avals: np.ndarray, bvals: np.ndarray) -> tuple[int, int, int, int]:
    """2x2 allele table for one SNP (reference statistics/fisher/cFisher.c:208-238).

    ``avals``/``bvals`` are the genotype codes of all individuals of each
    group at this SNP; only homozygous-major (3) and homozygous-minor (-3)
    individuals are counted."""
    f0 = int(np.sum(avals == 3))
    f1 = int(np.sum(avals == -3))
    f2 = int(np.sum(bvals == 3))
    f3 = int(np.sum(bvals == -3))
    return f0, f1, f2, f3


def _binom(n: int, k: int) -> int:
    if k < 0 or k > n:
        return 0
    return math.comb(n, k)


def fet_point_prob(a: int, b: int, c: int, d: int) -> float:
    """Hypergeometric point probability of one table (reference statistics/fisher/cFisher.c:473-483).

    Computed with exact integer binomials, then one float division — the
    same rounding pattern as the reference's (non-overflowing) path."""
    nom = _binom(a + b, a) * _binom(c + d, c)
    denom = _binom(a + b + c + d, a + c)
    if denom == 0:
        return math.nan
    return float(nom) / float(denom)


def _shift_table(f: list[int]) -> list[int]:
    """Rotate the table in clockwise order so the minimum cell leads
    (reference statistics/fisher/cFisher.c:327-346).  ``min`` ties resolve to the first index, like the
    reference's ``min_idx``."""
    cw = [f[0], f[1], f[3], f[2]]
    idx = cw.index(min(cw))
    rot = [cw[(idx + i) % 4] for i in range(4)]
    return [rot[0], rot[1], rot[3], rot[2]]


# Relative tolerance for probability ties on the second tail.  The
# reference compares `P2 < P0` (strict — ties EXCLUDED,
# reference statistics/fisher/cFisher.c:440): the first opposite-extreme
# P2 comes straight from fet_p, whose integer binomials and single
# division are exact for these panel sizes, so a rational tie compares
# bit-equal and the C deterministically excludes the whole second tail.
# (Randomized differential runs against the compiled C caught this:
# tie-including gave p = 1.0 where the C gives ~0.52.)  This framework
# replicates the exclusion, treating probabilities within FET_TIE_RTOL
# of P0 as tied (our lgamma path computes the tie only approximately).
# Residual ambiguity: a mathematically tied table reached through the
# C's multiplicative recurrence (an interior second-tail table, not the
# extreme) carries ~1e-16/step rounding in the C, so ITS inclusion is
# FP-noise-dependent in the reference itself; we deterministically
# exclude.  Distinct hypergeometric probabilities of N <= ~40 tables
# differ by far more than 1e-12 relative, so the tolerance cannot
# misclassify genuinely different tables.
FET_TIE_RTOL = 1e-12


def fet_two_tailed(
    f0: int, f1: int, f2: int, f3: int, tie_rtol: float = FET_TIE_RTOL
) -> float:
    """Two-tailed Fisher exact p via the Feldman-Klinger/Zar short cut
    (reference statistics/fisher/cFisher.c:405-455), including the P > 1 clamp.

    Second-tail probability ties are EXCLUDED like the reference's
    strict `P2 < P0` (see FET_TIE_RTOL above for the exactness argument
    and the one residual interior-tie ambiguity).  ``tie_rtol`` widens
    the tie band — pass 1e-5 to reproduce the f32 fast path's dtype-
    scaled tie rule (kernels/fet.py) for mismatch attribution."""
    R1, R2 = f0 + f1, f2 + f3
    C1, C2 = f0 + f2, f1 + f3

    f = _shift_table([f0, f1, f2, f3])
    a, b, c, d = f

    p0 = fet_point_prob(a, b, c, d)
    total = p0
    p1 = p0
    # first tail: walk the minimum cell down to zero
    while a > 0:
        b += 1
        c += 1
        p1 = (1.0 * a * d) / (b * c) * p1
        total += p1
        a -= 1
        d -= 1

    if R1 == R2 or C1 == C2:
        total = 2.0 * total
    else:
        # second tail: from the most extreme opposite table, walk inward
        # while strictly more extreme than the observed table.  NB: the
        # reference builds the extreme from the table state left behind by
        # the first-tail walk (f mutated in place, reference statistics/fisher/cFisher.c:422-436) — the
        # margins are the same, but the branch taken in create_table
        # depends on the walked-to cells.
        f = _create_opposite_extreme([a, b, c, d])
        f = _shift_table(f)
        a, b, c, d = f
        p2 = fet_point_prob(a, b, c, d)
        while p2 < p0 * (1.0 - tie_rtol):
            total += p2
            if b == 0 or c == 0:
                break
            a += 1
            d += 1
            p2 = (1.0 * b * c) / (a * d) * p2
            b -= 1
            c -= 1

    # snap round-off-shy-of-1 totals to exactly 1: when the second-tail
    # walk stops at a tie with the OBSERVED table, the exact total is the
    # whole support = 1; the reference reaches 1 from above (its noisy
    # recurrence double-counts, then the >1 clamp fires,
    # reference statistics/fisher/cFisher.c:451-452) while our sum lands
    # one ulp below.  Distinct genuine totals near 1 differ by at least
    # the minimum table probability (>= ~1e-12 for these panel sizes).
    if total > 1.0 - 1e-12:
        return 1.0
    return min(total, 1.0)


def fet_two_tailed_c_replica(f0: int, f1: int, f2: int, f3: int) -> float:
    """Bit-faithful replica of the reference's `fet`
    (reference statistics/fisher/cFisher.c:405-455) — identical IEEE
    operation sequence, STRICT `P2 < P0` with no tie tolerance, plain
    >1 clamp.  This reproduces even the reference's floating-point
    accidents: an exact interior-tie table whose recurrence-computed P2
    rounds one ulp below P0 gets INCLUDED here exactly as the compiled C
    includes it (docs/PARITY.md deviation 7(b)), because every product,
    division, and add happens in the same order on the same doubles.
    Used by differential tests to separate "we differ from the C"
    (a bug) from "the C differs from its own exact math" (fp luck the
    framework rule, :func:`fet_two_tailed`, deliberately does not copy).
    """
    R1, R2 = f0 + f1, f2 + f3
    C1, C2 = f0 + f2, f1 + f3
    f = _shift_table([f0, f1, f2, f3])
    a, b, c, d = f
    p0 = fet_point_prob(a, b, c, d)
    total = p0
    p1 = p0
    while a > 0:
        b += 1
        c += 1
        p1 = (1.0 * a * d) / (b * c) * p1
        total += p1
        a -= 1
        d -= 1
    if R1 == R2 or C1 == C2:
        total = 2.0 * total
    else:
        f = _create_opposite_extreme([a, b, c, d])
        f = _shift_table(f)
        a, b, c, d = f
        p2 = fet_point_prob(a, b, c, d)
        while p2 < p0:
            total += p2
            if b == 0 or c == 0:
                break
            a += 1
            d += 1
            p2 = (1.0 * b * c) / (a * d) * p2
            b -= 1
            c -= 1
    return min(total, 1.0)


_ULONG_MAX = 2**64 - 1


def binomial_c_replica(n: int, k: int) -> int:
    """Exact replica of the reference's 64-bit ``binomial``
    (reference statistics/fisher/cFisher.c:256-283): the rosetta-code
    incremental product with gcd reduction, returning **0 on the
    'unavoidable overflow' path** when the running product cannot fit an
    unsigned long even after reduction.  For valid 0 <= k <= n the true
    binomial is >= 1, so a 0 return unambiguously means the compiled C
    overflowed — the root cause of the reference's NaN/garbage FET
    scores beyond ~64 counted alleles per table (found by the round-5
    ``--big-panels`` fuzz lane).  Python ints are exact, and the C's
    guards fire BEFORE any multiplication can wrap, so this replica is
    bit-faithful."""
    if k == 0 or k == n:
        return 1
    if k == 1:
        return n
    if k > n:
        return 0
    if k > n // 2:
        k = n - k
    result = 1
    for i in range(1, k + 1):
        if result >= _ULONG_MAX // n:
            g = math.gcd(n, i)
            n_red, i_red = n // g, i // g
            g = math.gcd(result, i_red)
            result //= g
            i_red //= g
            if result >= _ULONG_MAX // n_red:
                return 0
            result = result * n_red // i_red
        else:
            result = result * n // i
        n -= 1
    return result


def _fet_p_c_overflows(a: int, b: int, c: int, d: int) -> bool:
    """True when the reference's ``fet_p`` (reference
    statistics/fisher/cFisher.c:473-483) evaluates a binomial that hits
    the overflow->0 path for this table: its p comes out 0, inf, or NaN
    and poisons every downstream recurrence of ``fet``."""
    return (
        binomial_c_replica(a + b, a) == 0
        or binomial_c_replica(c + d, c) == 0
        or binomial_c_replica(a + b + c + d, a + c) == 0
    )


def fet_c_binomial_overflows(f0: int, f1: int, f2: int, f3: int) -> bool:
    """True when the reference's ``fet`` would compute EITHER of its two
    ``fet_p`` call sites (P0 on the shifted table, P2 on the opposite
    extreme, reference statistics/fisher/cFisher.c:417,438) through an
    overflowing binomial — the table's reference p-value is then
    garbage (0/inf/NaN) regardless of what the recurrences do with it.
    Used by the differential fuzzer to attribute large-panel
    reference-vs-framework mismatches (docs/PARITY.md deviation 1): the
    framework's lgamma path has no such size limit."""
    R1, R2 = f0 + f1, f2 + f3
    C1, C2 = f0 + f2, f1 + f3
    f = _shift_table([f0, f1, f2, f3])
    a, b, c, d = f
    if _fet_p_c_overflows(a, b, c, d):
        return True
    if R1 == R2 or C1 == C2:
        return False
    # the first-tail loop runs a to 0 before create_table
    b, c, d, a = b + a, c + a, d - a, 0
    f = _shift_table(_create_opposite_extreme([a, b, c, d]))
    return _fet_p_c_overflows(f[0], f[1], f[2], f[3])


class CRand48:
    """glibc rand48-family replica (nrand48/drand48 LCG:
    X' = (0x5DEECE66D X + 0xB) mod 2^48) — exact integer arithmetic, so
    the stream matches the compiled reference bit-for-bit once its
    wall-clock seed is pinned (baseline/faketime.c)."""

    A = 0x5DEECE66D
    C = 0xB
    MASK = (1 << 48) - 1
    RAND_MAX = 2147483647

    def __init__(self, x: int):
        self.x = x & self.MASK

    @classmethod
    def from_nrand_state(cls, s0: int, s1: int = 0, s2: int = 0):
        """unsigned short state[3] layout: X = s2<<32 | s1<<16 | s0.
        The reference memcpy's a 16-bit truncation of time(NULL) into
        state[0] (reference statistics/fisher/cFisher.c:77-79)."""
        return cls((s2 << 32) | (s1 << 16) | s0)

    @classmethod
    def from_srand48(cls, seed: int):
        """srand48 semantics: X = seed<<16 | 0x330E."""
        return cls(((seed & 0xFFFFFFFF) << 16) | 0x330E)

    def nrand48(self) -> int:
        self.x = (self.A * self.x + self.C) & self.MASK
        return self.x >> 17

    def drand48(self) -> float:
        self.x = (self.A * self.x + self.C) & self.MASK
        return math.ldexp(self.x, -48)

    def random_int(self, n: int) -> int:
        """random_int_nrand48 (reference statistics/fisher/cFisher.c:547-554):
        modulo-bias-free draw in [0, n)."""
        limit = self.RAND_MAX - (self.RAND_MAX + 1) % n
        r = self.nrand48()
        while r > limit:
            r = self.nrand48()
        return r % n


def compute_fet_c_replica(
    avals: np.ndarray,
    bvals: np.ndarray,
    apos: np.ndarray,
    bpos: np.ndarray,
    regend: int,
    wsize: int,
    wstep: int,
    perc: float = 0.95,
    nsamples: int = 100,
    time_seed: int = 42,
) -> tuple[np.ndarray, np.ndarray]:
    """Bit-faithful replica of the serial C `compute` INCLUDING the
    bootstrap stddev column (reference statistics/fisher/cFisher.c:38-115)
    under a pinned clock (LD_PRELOAD baseline/build/libfaketime.so with
    FAKE_TIME=``time_seed``): exact rand48 stream, the C's op order for
    percentile/mean/std, p-values via :func:`fet_two_tailed_c_replica`,
    and ONE nrand48 state threaded across all windows in scan order.
    Quirk preserved: `percentile` sorts the per-SNP scores IN PLACE
    (reference statistics/fisher/cFisher.c:136), so the bootstrap draws
    from the SORTED array."""
    asize = population_size(apos)
    bsize = population_size(bpos)
    nslots = regend // wstep
    scores = np.zeros(nslots, dtype=np.float64)
    stddev = np.zeros(nslots, dtype=np.float64)
    st = CRand48.from_nrand_state(time_seed & 0xFFFF)
    for start in window_starts(regend, wsize, wstep):
        lo, hi = window_bounds(apos, int(start), int(start) + wsize)
        blo, bhi = window_bounds(bpos, int(start), int(start) + wsize)
        npos = (hi - lo) // asize
        if npos <= 0:
            continue
        aw = avals[lo : lo + npos * asize].reshape(npos, asize)
        bw = bvals[blo : blo + npos * bsize].reshape(npos, bsize)
        logs = np.empty(npos, dtype=np.float64)
        for k in range(npos):
            f = fet_count(aw[k], bw[k])
            logs[k] = -1.0 * math.log10(fet_two_tailed_c_replica(*f))
        s = np.sort(logs)
        score = percentile_interp(s, perc)
        reps = np.empty(nsamples, dtype=np.float64)
        sample = np.empty(npos, dtype=np.float64)
        for i in range(nsamples):
            # bootstrap_sample's `for (i = n; i--; )` draw order
            for j in range(npos - 1, -1, -1):
                sample[j] = s[st.random_int(npos)]
            reps[i] = percentile_interp(sample, perc)
        # std() and mean() accumulate DESCENDING (reference
        # statistics/fisher/cFisher.c:492-518)
        mu = 0.0
        for i in range(nsamples - 1, -1, -1):
            mu += reps[i]
        mu /= nsamples
        acc = 0.0
        for i in range(nsamples - 1, -1, -1):
            acc += (reps[i] - mu) * (reps[i] - mu)
        slot = int(start) // wstep
        if slot < nslots:
            scores[slot] = score
            stddev[slot] = math.sqrt(acc / nsamples)
    return scores, stddev


def compute_css_p_c_replica(
    avals: np.ndarray,
    bvals: np.ndarray,
    apos: np.ndarray,
    bpos: np.ndarray,
    regend: int,
    wsize: int,
    wstep: int,
    threshold: int,
    runs: int,
    time_seed: int = 42,
) -> tuple[np.ndarray, np.ndarray]:
    """Replica of the serial C `compute` (CMDS mode) INCLUDING the
    Monte-Carlo p column (reference statistics/css/css.c:49-156,
    727-752) under a pinned clock: exact nrand48 stream, the C's
    cumulative Fisher-Yates on the ONE `signtracks` array that persists
    across all windows of the chromosome (reference
    statistics/css/css.c:94-98 — never reset), and the estimator
    p = (hits+1)/(nscores+1).

    Not bitwise in the way the FET replica is: the permuted-score
    comparison `newscore >= score` runs on OUR distance matrix (numpy
    eigh CMDS), which differs from the C's (Jacobi) at ~1e-15 — a
    comparison landing inside that margin can flip one hit.  Use a
    fixed-n protocol (threshold > runs) so a flip costs 1/(runs+1) on
    that window only and cannot desynchronize the shared RNG stream
    (the draw count per window is then comparison-independent)."""
    asize = population_size(apos)
    bsize = population_size(bpos)
    m = asize + bsize
    nslots = regend // wstep
    scores = np.zeros(nslots, dtype=np.float64)
    pvals = np.zeros(nslots, dtype=np.float64)
    st = CRand48.from_nrand_state(time_seed & 0xFFFF)
    signtracks = list(range(m))
    for start in window_starts(regend, wsize, wstep):
        lo, hi = window_bounds(apos, int(start), int(start) + wsize)
        blo, bhi = window_bounds(bpos, int(start), int(start) + wsize)
        npos = (hi - lo) // asize
        if npos <= 0:
            continue
        aw = avals[lo : lo + npos * asize].reshape(npos, asize)
        bw = bvals[blo : blo + npos * bsize].reshape(npos, bsize)
        score, dist = window_css(aw, bw, False, 0)
        if dist is None:
            continue
        hits = 0
        nscores = 0
        while hits < threshold and nscores < runs:
            for i in range(m - 1, 0, -1):
                r = st.random_int(i + 1)
                signtracks[i], signtracks[r] = signtracks[r], signtracks[i]
            at = np.asarray(signtracks[:asize])
            bt = np.asarray(signtracks[asize:])
            if css_score(dist, at, bt) >= score:
                hits += 1
            nscores += 1
        slot = int(start) // wstep
        if slot < nslots:
            scores[slot] = score
            pvals[slot] = (hits + 1) * 1.0 / (nscores + 1)
    return scores, pvals


def _css_c_exact(distance: np.ndarray, atracks, btracks) -> float:
    """css() with the C's exact accumulation order — all three sums run
    index-DESCENDING (reference statistics/css/css.c:608-647) — for
    bitwise comparisons against the strict-fp reference build."""
    asize, bsize = len(atracks), len(btracks)
    bet = 0.0
    for i in range(asize - 1, -1, -1):
        for j in range(bsize - 1, -1, -1):
            bet += distance[atracks[i]][btracks[j]]
    bet = bet / (asize * bsize)
    a_dist = 0.0
    if asize > 1:
        for i in range(asize - 2, -1, -1):
            a_dist += distance[atracks[i]][atracks[i + 1]]
        a_dist = a_dist / (asize * asize * (asize - 1))
    b_dist = 0.0
    if bsize > 1:
        for i in range(bsize - 2, -1, -1):
            b_dist += distance[btracks[i]][btracks[i + 1]]
        b_dist = b_dist / (bsize * bsize * (bsize - 1))
    return bet - (asize + bsize) * (a_dist + b_dist)


def _stress_c(dis: np.ndarray, d: np.ndarray) -> float:
    """stress() with the C's exact global accumulation order: i
    descending, j < i descending, one running sum (reference
    statistics/css/css.c:767-777)."""
    m = dis.shape[0]
    sigma = 0.0
    for i in range(m - 1, -1, -1):
        for j in range(i - 1, -1, -1):
            t = d[i][j] - dis[i][j]
            sigma += t * t
    return sigma


def _guttman_c(x: np.ndarray, d: np.ndarray, dis: np.ndarray) -> np.ndarray:
    """guttman_transform() with the C's exact op orders (reference
    statistics/css/css.c:811-836): per-row diagonal accumulated
    j-DESCENDING, then the shim dgemm's k-ASCENDING matmul.  Vectorized
    over rows/columns — each element's accumulation sequence is
    identical to the scalar C loop, so the result is bit-equal under a
    strict-fp (-ffp-contract=off) reference build."""
    m = dis.shape[0]
    with np.errstate(divide="ignore", invalid="ignore"):
        b = np.where(d < 0.00001, 0.0, -1.0 * dis / d)
    np.fill_diagonal(b, 0.0)
    dsum = np.zeros(m, dtype=np.float64)
    for j in range(m - 1, -1, -1):
        dsum += b[:, j]
    np.fill_diagonal(b, -1.0 * dsum)
    out = np.zeros((m, x.shape[1]), dtype=np.float64)
    for k in range(m):
        out += b[:, k : k + 1] * x[k : k + 1, :]
    return out / m


def _calc_dist_c(x: np.ndarray) -> np.ndarray:
    """calc_dist()'s exact expression (reference
    statistics/css/css.c:573-587): sqrt(dx*dx + dy*dy), one rounding per
    op — elementwise-identical to the strict-fp C."""
    dx = x[:, None, 0] - x[None, :, 0]
    dy = x[:, None, 1] - x[None, :, 1]
    out = np.sqrt(dx * dx + dy * dy)
    np.fill_diagonal(out, 0.0)
    return out


def _smacof_c(dis: np.ndarray, x0: np.ndarray, max_iters: int,
              epsilon: float) -> tuple[np.ndarray, float]:
    """smacof() with the C's exact loop protocol and op orders
    (reference statistics/css/css.c:907-938)."""
    x = x0.copy()
    d = _calc_dist_c(x)
    sigma = _stress_c(dis, d)
    sigma_prev = 0.0
    k = 0
    while k == 0 or (sigma_prev - sigma > epsilon and k <= max_iters):
        sigma_prev = sigma
        k += 1
        x = _guttman_c(x, d, dis)
        d = _calc_dist_c(x)
        sigma = _stress_c(dis, d)
    return x, sigma


def compute_css_mds1_c_replica(
    avals: np.ndarray,
    bvals: np.ndarray,
    apos: np.ndarray,
    bpos: np.ndarray,
    regend: int,
    wsize: int,
    wstep: int,
    threshold: int,
    runs: int,
    time_seed: int = 42,
) -> tuple[np.ndarray, np.ndarray]:
    """Replica of the serial C `compute` in SMACOF mode (mds=1) —
    scores AND MC p — against the strict-fp reference build under a
    pinned clock.  The mds=1 chain involves NO eigensolver: the inits
    come from the exact drand48 replica (srand48(time), reference
    statistics/css/css.c:115, consumed in smacof_runs' restart loop,
    :852-884), every float op is order-replicated, so the embedding,
    the best-of-4 stress selection, the score, and the cumulative
    nrand48 shuffle stream are all exact."""
    asize = population_size(apos)
    bsize = population_size(bpos)
    m = asize + bsize
    nslots = regend // wstep
    scores = np.zeros(nslots, dtype=np.float64)
    pvals = np.zeros(nslots, dtype=np.float64)
    st = CRand48.from_nrand_state(time_seed & 0xFFFF)
    dr = CRand48.from_srand48(time_seed)
    signtracks = list(range(m))
    at0 = np.arange(asize)
    bt0 = np.arange(asize, m)
    for start in window_starts(regend, wsize, wstep):
        lo, hi = window_bounds(apos, int(start), int(start) + wsize)
        blo, bhi = window_bounds(bpos, int(start), int(start) + wsize)
        npos = (hi - lo) // asize
        if npos <= 0:
            continue
        aw = avals[lo : lo + npos * asize].reshape(npos, asize)
        bw = bvals[blo : blo + npos * bsize].reshape(npos, bsize)
        dis = compare_all(aw, bw)
        filled = fill_averages(dis)
        if filled is None:
            continue
        # smacof_runs: 4 restarts, drand48 inits in row order, best by
        # exact stress comparison (reference statistics/css/css.c:852-884)
        best_x = None
        best_sigma = 99999.0
        for _ in range(4):
            x0 = np.empty((m, 2), dtype=np.float64)
            for i in range(m):
                x0[i, 0] = dr.drand48()
                x0[i, 1] = dr.drand48()
            x, sigma = _smacof_c(filled, x0, 300, 0.000001)
            if sigma < best_sigma:
                best_x = x
                best_sigma = sigma
        dist = _calc_dist_c(best_x)
        score = _css_c_exact(dist, at0, bt0)
        hits = 0
        nscores = 0
        while hits < threshold and nscores < runs:
            for i in range(m - 1, 0, -1):
                r = st.random_int(i + 1)
                signtracks[i], signtracks[r] = signtracks[r], signtracks[i]
            if _css_c_exact(
                dist, signtracks[:asize], signtracks[asize:]
            ) >= score:
                hits += 1
            nscores += 1
        slot = int(start) // wstep
        if slot < nslots:
            scores[slot] = score
            pvals[slot] = (hits + 1) * 1.0 / (nscores + 1)
    return scores, pvals


def _create_opposite_extreme(f: list[int]) -> list[int]:
    """Most extreme table of the second tail (reference statistics/fisher/cFisher.c:357-390)."""
    R1, R2 = f[0] + f[1], f[2] + f[3]
    C1, C2 = f[0] + f[2], f[1] + f[3]
    margins = [R1, R2, C1, C2]
    m1 = min(margins)
    g = list(f)
    if R1 <= R2 and C1 <= C2:
        g[0] = m1 - f[0]
        g[1] = R1 - g[0]
        g[2] = C1 - g[0]
        g[3] = C2 - g[1]
    elif R1 <= R2 and C2 <= C1:
        g[1] = m1 - f[1]
        g[0] = R1 - g[1]
        g[3] = C2 - g[1]
        g[2] = C1 - g[0]
    elif R1 >= R2 and C1 <= C2:
        g[2] = m1 - f[2]
        g[0] = C1 - g[2]
        g[3] = R2 - g[2]
        g[1] = R1 - g[0]
    else:
        g[3] = m1 - f[3]
        g[1] = C2 - g[3]
        g[2] = R2 - g[3]
        g[0] = R1 - g[1]
    return g


def percentile_interp(values: np.ndarray, perc: float) -> float:
    """Linear-interpolated percentile over a sorted copy (reference statistics/fisher/cFisher.c:136-144).

    ``idx`` truncates like the C int cast; the out-of-range ``idx+1`` read
    the C code performs when ``idx == n-1`` is multiplied by ``delta == 0``,
    so clamping is value-identical."""
    s = np.sort(np.asarray(values, dtype=np.float64))
    n = len(s)
    x = (n - 1) * perc
    idx = int(x)
    delta = x - idx
    hi = min(idx + 1, n - 1)
    return float((1.0 - delta) * s[idx] + delta * s[hi])


def window_fet(
    avals: np.ndarray,
    bvals: np.ndarray,
    perc: float,
    nsamples: int,
    rng: np.random.Generator | None = None,
    two_tailed=None,
) -> tuple[float, float, np.ndarray]:
    """FET score + bootstrap stddev for one window (reference statistics/fisher/cFisher.c:170-195).

    ``avals``: [npos, asize], ``bvals``: [npos, bsize] genotype codes.
    Returns (percentile score, bootstrap stddev, per-SNP -log10(p)).
    ``two_tailed`` selects the per-table p (default the framework rule
    :func:`fet_two_tailed`; pass :func:`fet_two_tailed_c_replica` to
    reproduce the compiled C bit-for-bit, ties included)."""
    if two_tailed is None:
        two_tailed = fet_two_tailed
    npos = avals.shape[0]
    logs = np.empty(npos, dtype=np.float64)
    for k in range(npos):
        f = fet_count(avals[k], bvals[k])
        logs[k] = -math.log10(two_tailed(*f))
    score = percentile_interp(logs, perc)
    if rng is None:
        rng = np.random.default_rng(0)
    reps = np.empty(nsamples, dtype=np.float64)
    for i in range(nsamples):
        sample = logs[rng.integers(0, npos, size=npos)]
        reps[i] = percentile_interp(sample, perc)
    # population stddev (divides by n), like reference statistics/fisher/cFisher.c:492-503
    stddev = float(np.sqrt(np.mean((reps - reps.mean()) ** 2)))
    return score, stddev, logs


def compute_fet(
    avals: np.ndarray,
    bvals: np.ndarray,
    apos: np.ndarray,
    bpos: np.ndarray,
    regend: int,
    wsize: int,
    wstep: int,
    perc: float = 0.95,
    nsamples: int = 100,
    seed: int = 0,
    two_tailed=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Whole-chromosome serial FET scan (reference statistics/fisher/cFisher.c:38-115).

    Inputs are the flattened position-major arrays of the reference data
    model; outputs are dense score/stddev arrays of ``regend // wstep``
    slots, window w at slot ``w.start // wstep``."""
    asize = population_size(apos)
    bsize = population_size(bpos)
    nslots = regend // wstep
    scores = np.zeros(nslots, dtype=np.float64)
    stddev = np.zeros(nslots, dtype=np.float64)
    rng = np.random.default_rng(seed)
    for start in window_starts(regend, wsize, wstep):
        lo, hi = window_bounds(apos, int(start), int(start) + wsize)
        blo, bhi = window_bounds(bpos, int(start), int(start) + wsize)
        npos = (hi - lo) // asize
        if npos <= 0:
            continue
        aw = avals[lo : lo + npos * asize].reshape(npos, asize)
        bw = bvals[blo : blo + npos * bsize].reshape(npos, bsize)
        slot = int(start) // wstep
        if slot >= nslots:
            continue
        s, d, _ = window_fet(aw, bw, perc, nsamples, rng,
                             two_tailed=two_tailed)
        scores[slot] = s
        stddev[slot] = d
    return scores, stddev


# ---------------------------------------------------------------------------
# CSS
# ---------------------------------------------------------------------------


def compare_all(
    avals: np.ndarray, bvals: np.ndarray
) -> np.ndarray:
    """Pairwise genotype-mismatch counts for all individuals
    (reference statistics/css/css.c:277-327).

    A pair of individuals mismatches at a SNP iff one is homozygous major
    (3) and the other homozygous minor (-3) — i.e. the value product is -9.
    ``avals``: [npos, asize], ``bvals``: [npos, bsize].  Returns the
    [m, m] dissimilarity with a zero diagonal."""
    v = np.concatenate([avals, bvals], axis=1)  # [npos, m]
    maj = (v == 3).astype(np.float64)
    mnr = (v == -3).astype(np.float64)
    d = maj.T @ mnr
    return d + d.T


def compare_freq(avals: np.ndarray, bvals: np.ndarray) -> np.ndarray:
    """Drosophila frequency-track metric (reference statistics/css/css.c:245-264): mean absolute
    frequency difference, as a 2x2 dissimilarity."""
    avg = float(np.mean(np.abs(avals.ravel() - bvals.ravel())))
    return np.array([[0.0, avg], [avg, 0.0]])


def fill_averages(dis: np.ndarray) -> np.ndarray | None:
    """Replace near-zero cells by the global average (reference statistics/css/css.c:337-366).

    Quirks faithfully preserved: the average divides by all m^2 cells
    (including the zero diagonal), the diagonal itself gets overwritten with
    the average, and the window is discarded (None) when more than
    ``m*m // 2`` cells are near-zero."""
    m = dis.shape[0]
    unvalued = dis < 0.00001
    total = m * m
    avg = float(dis[~unvalued].sum()) / total
    if int(unvalued.sum()) > total // 2:
        return None
    out = dis.copy()
    out[unvalued] = avg
    return out


def cmds(dis: np.ndarray, dims: int = 2) -> np.ndarray:
    """Classical MDS / Torgerson scaling (reference statistics/css/css.c:505-560).

    Double-centers the squared dissimilarities and keeps the top ``dims``
    eigenpairs; X = Q sqrt(L).  A genuinely negative retained eigenvalue
    produces NaN coordinates exactly like the reference's ``sqrt``; a
    mathematically-ZERO eigenvalue's numerical dust is snapped to 0
    first (same rule as kernels/css.py cmds) — the reference NaNs or
    not there purely on its eigensolver's sign noise
    (docs/PARITY.md deviation 8(c))."""
    m = dis.shape[0]
    b = dis * dis
    z = np.eye(m) - np.ones((m, m)) / m
    b = -0.5 * (z @ b @ z)
    w, v = np.linalg.eigh(b)  # ascending
    top = w[::-1][:dims].copy()
    scale = max(abs(float(top[0])), 1.0)
    top[(top < 0) & (top > -1e-9 * scale)] = 0.0
    vecs = v[:, ::-1][:, :dims]
    with np.errstate(invalid="ignore"):
        return vecs * np.sqrt(top)[None, :]


def calc_dist(x: np.ndarray) -> np.ndarray:
    """Pairwise Euclidean distances of the embedded points
    (reference statistics/css/css.c:573-587)."""
    diff = x[:, None, :] - x[None, :, :]
    return np.sqrt((diff * diff).sum(-1))


def css_score(
    dist: np.ndarray, atracks: np.ndarray, btracks: np.ndarray
) -> float:
    """Cluster separation score (reference statistics/css/css.c:608-647).

    Between-group mean distance minus ``(a+b)`` times the two within-group
    adjacent-chain terms.  Note the within terms sum *consecutive pairs in
    track order* — under permutations this depends on the order, not just
    the partition."""
    a, b = len(atracks), len(btracks)
    bet = dist[np.ix_(atracks, btracks)].sum() / (a * b)
    a_dist = 0.0
    if a > 1:
        a_dist = dist[atracks[:-1], atracks[1:]].sum() / (a * a * (a - 1))
    b_dist = 0.0
    if b > 1:
        b_dist = dist[btracks[:-1], btracks[1:]].sum() / (b * b * (b - 1))
    return float(bet - (a + b) * (a_dist + b_dist))


def significance(
    dist: np.ndarray,
    asize: int,
    bsize: int,
    score: float,
    threshold: int,
    runs: int,
    rng: np.random.Generator,
) -> float:
    """Monte-Carlo permutation p-value (reference statistics/css/css.c:727-752).

    Stops at ``threshold`` hits or ``runs`` permutations; the estimator is
    ``(hits+1)/(n+1)``.  RNG stream differs from the (wall-clock-seeded)
    reference by design."""
    m = asize + bsize
    tracks = np.arange(m)
    hits = 0
    n = 0
    while hits < threshold and n < runs:
        rng.shuffle(tracks)
        new = css_score(dist, tracks[:asize], tracks[asize:])
        if new >= score:
            hits += 1
        n += 1
    return (hits + 1) / (n + 1)


def _stress(dis: np.ndarray, d: np.ndarray) -> float:
    """Raw stress over i<j pairs (reference statistics/css/css.c:767-777)."""
    iu = np.tril_indices(dis.shape[0], k=-1)
    diff = d[iu] - dis[iu]
    return float((diff * diff).sum())


def _guttman(x_prev: np.ndarray, d: np.ndarray, dis: np.ndarray) -> np.ndarray:
    """One Guttman transform step (reference statistics/css/css.c:811-836)."""
    m = dis.shape[0]
    with np.errstate(divide="ignore", invalid="ignore"):
        b = np.where(d < 0.00001, 0.0, -dis / d)
    np.fill_diagonal(b, 0.0)
    np.fill_diagonal(b, -b.sum(axis=1))
    return (b @ x_prev) / m


def smacof(
    dis: np.ndarray,
    x0: np.ndarray,
    max_iters: int = 300,
    epsilon: float = 1e-6,
) -> tuple[np.ndarray, float]:
    """SMACOF majorization loop (reference statistics/css/css.c:907-938).

    Returns the final configuration and its stress.  Loop protocol matches
    the reference: the first iteration is unconditional, afterwards iterate
    while the stress improvement exceeds ``epsilon`` and ``k <= max_iters``
    (so up to ``max_iters + 1`` transforms)."""
    x = x0.copy()
    d = calc_dist(x)
    sigma = _stress(dis, d)
    sigma_prev = 0.0
    k = 0
    while k == 0 or (sigma_prev - sigma > epsilon and k <= max_iters):
        sigma_prev = sigma
        k += 1
        x = _guttman(x, d, dis)
        d = calc_dist(x)
        sigma = _stress(dis, d)
    return x, sigma


def smacof_runs(
    dis: np.ndarray,
    rng: np.random.Generator,
    max_iters: int = 300,
    n_init: int = 4,
    epsilon: float = 1e-6,
) -> np.ndarray:
    """SMACOF with random restarts, best-of-N by stress (reference statistics/css/css.c:852-884)."""
    m = dis.shape[0]
    best_x = None
    best_sigma = math.inf
    for _ in range(n_init):
        x0 = rng.random((m, 2))
        x, sigma = smacof(dis, x0, max_iters, epsilon)
        if sigma < best_sigma:
            best_sigma = sigma
            best_x = x
    return best_x


def window_css(
    avals: np.ndarray,
    bvals: np.ndarray,
    drosophila: bool = False,
    mds: int = 0,
    rng: np.random.Generator | None = None,
    smacof_max_iters: int = 300,
    smacof_n_init: int = 4,
    smacof_eps: float = 1e-6,
) -> tuple[float, np.ndarray | None]:
    """CSS for one window: dissimilarity -> fill averages -> MDS -> score
    (reference statistics/css/css.c:181-223).  Returns (score, distance matrix) or (-1, None) when
    the window is discarded."""
    if drosophila:
        dis = compare_freq(avals, bvals)
        asize = bsize = 1
    else:
        dis = compare_all(avals, bvals)
        asize, bsize = avals.shape[1], bvals.shape[1]
    filled = fill_averages(dis)
    if filled is None:
        return -1.0, None
    if rng is None:
        rng = np.random.default_rng(0)
    if mds == 0:
        x = cmds(filled)
    elif mds == 1:
        x = smacof_runs(filled, rng, smacof_max_iters, smacof_n_init, smacof_eps)
    else:
        x = cmds(filled)
        x, _ = smacof(filled, x, smacof_max_iters, smacof_eps)
    dist = calc_dist(x)
    m = asize + bsize
    score = css_score(dist, np.arange(asize), np.arange(asize, m))
    return score, dist


def compute_css(
    avals: np.ndarray,
    bvals: np.ndarray,
    apos: np.ndarray,
    bpos: np.ndarray,
    regend: int,
    wsize: int,
    wstep: int,
    threshold: int = 10,
    runs: int = 200_000,
    drosophila: bool = False,
    mds: int = 0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Whole-chromosome serial CSS scan (reference statistics/css/css.c:49-156)."""
    asize = population_size(apos)
    bsize = population_size(bpos)
    nslots = regend // wstep
    scores = np.zeros(nslots, dtype=np.float64)
    pvals = np.zeros(nslots, dtype=np.float64)
    rng = np.random.default_rng(seed)
    for start in window_starts(regend, wsize, wstep):
        lo, hi = window_bounds(apos, int(start), int(start) + wsize)
        blo, bhi = window_bounds(bpos, int(start), int(start) + wsize)
        npos = (hi - lo) // asize
        if npos <= 0:
            continue
        slot = int(start) // wstep
        if slot >= nslots:
            continue
        aw = avals[lo : lo + npos * asize].reshape(npos, asize)
        bw = bvals[blo : blo + npos * bsize].reshape(npos, bsize)
        score, dist = window_css(aw, bw, drosophila, mds, rng)
        if dist is None:
            continue
        scores[slot] = score
        pvals[slot] = significance(
            dist, asize, bsize, score, threshold, runs, rng
        )
    return scores, pvals
