"""Batched Fisher's Exact Test kernel.

Replaces the reference's per-SNP scalar recurrences
(reference statistics/fisher/cFisher.c: fetcount :208-238, fet :405-455, fet_p :473-483,
percentile :136-144, calc_std :590-597) with fixed-shape vector math:

* the 2x2 tables of *every* SNP of *every* window in a bucket are counted
  with one masked reduction;
* the two-tailed p is evaluated over the whole hypergeometric support at
  once (support size <= (asize+bsize)//2 + 1) using a precomputed
  log-factorial table — no data-dependent loops, so everything vmaps and
  jits;
* the Feldman-Klinger/Zar tail semantics are reproduced exactly:
  first tail = all tables from the observed one (minimum cell) down to
  zero; second tail = tables scanned from the opposite extreme inward
  while *strictly* less probable than the observed table (a suffix-AND
  instead of a sequential scan); equal row/column margins double the
  first tail; the total clamps at 1 (reference statistics/fisher/cFisher.c:433-452);
* the window percentile comes from one ascending sort per window;
* the 100 bootstrap-replicate percentiles use the *order-statistic*
  identity instead of materializing resamples: the k-th order statistic
  of n draws-with-replacement from the empirical distribution equals the
  empirical quantile function evaluated at U_(k), the k-th order
  statistic of n iid uniforms.  (U_(k1), U_(k2)) are sampled jointly
  and exactly by the Renyi top-down recursion
  (U_(n) = V^(1/n), U_(k) = U_(k+1)·V^(1/k) — ~(1-perc)·n pow ops),
  avoiding both the reference's O(S·n log n) resample-and-sort
  (reference statistics/fisher/cFisher.c:562-571, 590-597) and rejection-sampled Beta/Gamma draws
  (~150x a uniform, in data-dependent while_loops) — identical in
  distribution, far lighter on device memory.

Shapes: a bucket is [B, P, size] — B windows, P padded SNPs.
Probability math runs in float64 by default (the reference is all C
doubles); ``fast=True`` switches the whole pipeline to float32 — ~1e-5
relative score accuracy.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from divergence_tpu.kernels.perm import slot_keys


_LUT_MAX_BUILD_OPS = 100_000_000


def support_size(asize: int, bsize: int) -> int:
    """Static bound on the hypergeometric support after table shifting.

    With the minimum cell leading, hi = min(R1', C1') <= N/2 where
    N <= asize + bsize individuals enter the table."""
    return (asize + bsize) // 2 + 2


def _log_factorials(nmax: int) -> np.ndarray:
    """lgamma(i+1) for i in 0..nmax, computed host-side once."""
    from scipy.special import gammaln

    return gammaln(np.arange(nmax + 1, dtype=np.float64) + 1.0)


def count_tables(avals: jnp.ndarray, bvals: jnp.ndarray) -> jnp.ndarray:
    """2x2 allele-count tables for every (window, SNP).

    ``avals``: [..., asize], ``bvals``: [..., bsize] genotype codes.
    Only homozygous calls are counted (reference statistics/fisher/cFisher.c:208-238).
    Returns [..., 4] int32 (f0..f3)."""
    f0 = jnp.sum(avals == 3, axis=-1, dtype=jnp.int32)
    f1 = jnp.sum(avals == -3, axis=-1, dtype=jnp.int32)
    f2 = jnp.sum(bvals == 3, axis=-1, dtype=jnp.int32)
    f3 = jnp.sum(bvals == -3, axis=-1, dtype=jnp.int32)
    return jnp.stack([f0, f1, f2, f3], axis=-1)


def _shift_min_first(f: jnp.ndarray) -> jnp.ndarray:
    """Rotate each table in clockwise order so the minimum cell leads
    (reference statistics/fisher/cFisher.c:327-346).  argmin == first minimum, like min_idx."""
    cw = jnp.stack([f[..., 0], f[..., 1], f[..., 3], f[..., 2]], axis=-1)
    idx = jnp.argmin(cw, axis=-1)
    offs = (idx[..., None] + jnp.arange(4, dtype=idx.dtype)) % 4
    rot = jnp.take_along_axis(cw, offs, axis=-1)
    return jnp.stack(
        [rot[..., 0], rot[..., 1], rot[..., 3], rot[..., 2]], axis=-1
    )


def _support_logp(tables, maxs, nmax, dtype):
    """Shared support-scan prelude of :func:`fet_two_tailed` and
    :func:`fet_two_tailed_neglog10` — the table normalization, margin
    test, and per-support-point log point probabilities (single source
    of truth; the round-2 tie-rule fix showed how costly a silent
    desynchronization of duplicated scan logic would be).  Returns
    ``(x, logp, valid, a0, equal_margins)`` with ``logp`` unmasked
    (``-inf`` only at impossible cell combinations); the two reducers
    keep their own tie rules — the linear path compares p in the C's
    own domain, the log-space path compares logp."""
    lf = jnp.asarray(_log_factorials(nmax), dtype=dtype)

    def lchoose(n, k):
        ok = (k >= 0) & (k <= n) & (n >= 0)
        kc = jnp.clip(k, 0, nmax)
        nc = jnp.clip(n, 0, nmax)
        val = lf[nc] - lf[kc] - lf[jnp.clip(nc - kc, 0, nmax)]
        return jnp.where(ok, val, -jnp.inf)

    f = tables
    R1 = f[..., 0] + f[..., 1]
    R2 = f[..., 2] + f[..., 3]
    C1 = f[..., 0] + f[..., 2]
    C2 = f[..., 1] + f[..., 3]
    equal_margins = (R1 == R2) | (C1 == C2)

    s = _shift_min_first(f)
    a0 = s[..., 0]
    r1 = s[..., 0] + s[..., 1]
    r2 = s[..., 2] + s[..., 3]
    c1 = s[..., 0] + s[..., 2]
    n = r1 + r2
    hi = jnp.minimum(r1, c1)

    x = jnp.arange(maxs, dtype=jnp.int32)
    shape = (1,) * f[..., 0].ndim + (maxs,)
    x = x.reshape(shape)
    r1e, r2e, c1e, ne = (t[..., None] for t in (r1, r2, c1, n))
    logp = lchoose(r1e, x) + lchoose(r2e, c1e - x) - lchoose(ne, c1e)
    valid = x <= hi[..., None]
    return x, logp, valid, a0, equal_margins


def fet_two_tailed(
    tables: jnp.ndarray, maxs: int, nmax: int, dtype=jnp.float64
) -> jnp.ndarray:
    """Two-tailed FET p for a batch of 2x2 tables.

    ``tables``: [..., 4] int32; ``maxs``: static support bound;
    ``nmax``: static max total count (for the log-factorial table).
    Returns [...] p-values in ``dtype``, Zar-shortcut semantics."""
    x, logp, valid, a0, equal_margins = _support_logp(
        tables, maxs, nmax, dtype
    )
    p = jnp.where(valid, jnp.exp(logp), 0.0)

    p0 = jnp.take_along_axis(p, a0[..., None].astype(jnp.int32), axis=-1)
    # first tail: every table from the observed minimum cell down to zero
    # (reference statistics/fisher/cFisher.c:422-427) — unconditional, even across the mode (the
    # shortcut is conservative for near-mode tables; oracle-verified).
    t1 = jnp.sum(jnp.where(x <= a0[..., None], p, 0.0), axis=-1)

    # second tail: scanned from the opposite extreme (x = hi) inward while
    # STRICTLY less probable than the observed table (the reference's
    # `P2 < P0`, reference statistics/fisher/cFisher.c:440 — exact ties
    # excluded; the C's integer binomials make a rational tie bit-equal,
    # so exclusion is deterministic there, and randomized differential
    # runs against the compiled C pinned it.  See
    # oracle.reference.FET_TIE_RTOL).  valid-suffix AND: a position
    # contributes iff no table at >= x fails the strict comparison.
    tie_rtol = 1e-12 if dtype == jnp.float64 else 1e-5
    bad = (p >= p0 * (1.0 - tie_rtol)) & valid
    blocked = jnp.flip(
        jnp.cumsum(jnp.flip(bad, axis=-1).astype(jnp.int32), axis=-1), axis=-1
    )
    ok = (blocked == 0) & valid & (x > a0[..., None])
    t2 = jnp.sum(jnp.where(ok, p, 0.0), axis=-1)

    total = jnp.where(equal_margins, 2.0 * t1, t1 + t2)
    # snap round-off-shy-of-1 totals to exactly 1 (complete-support sums;
    # see oracle.reference.fet_two_tailed) and clamp the >1 overshoots
    # (reference statistics/fisher/cFisher.c:451-452)
    snap = 1e-12 if dtype == jnp.float64 else 1e-5
    return jnp.where(total > 1.0 - snap, 1.0, total)


def fet_two_tailed_neglog10(
    tables: jnp.ndarray, maxs: int, nmax: int, dtype=jnp.float32
) -> jnp.ndarray:
    """``-log10`` of :func:`fet_two_tailed` computed WITHOUT ever
    materializing ``p`` — the fast (f32) path's score function.

    float32 ``p`` underflows at ~1e-38, which a large-panel divergent
    table reaches (a 100v100 fully-divergent table has p ~ 1e-60), so
    the exp-then-log round trip returned a +inf score whose bootstrap
    handling then fabricated a finite stddev via the one-hot pick
    sanitizer (round-5 review finding 2).  The score itself (~60) is
    perfectly representable: a max-shifted log-sum-exp over the same
    selected support keeps every per-SNP value finite and exact to f32
    rounding.  Tie/snap semantics mirror :func:`fet_two_tailed`'s f32
    band in log space (``log1p`` of the same tolerances); exact mode
    keeps the linear-space function — its doubles match the reference
    C's arithmetic, which computes p linearly
    (reference statistics/fisher/cFisher.c:417-447)."""
    x, logp, valid, a0, equal_margins = _support_logp(
        tables, maxs, nmax, dtype
    )
    logp = jnp.where(valid, logp, -jnp.inf)

    logp0 = jnp.take_along_axis(logp, a0[..., None].astype(jnp.int32), axis=-1)
    tie_rtol = 1e-12 if dtype == jnp.float64 else 1e-5
    bad = (logp >= logp0 + dtype(np.log1p(-tie_rtol))) & valid
    blocked = jnp.flip(
        jnp.cumsum(jnp.flip(bad, axis=-1).astype(jnp.int32), axis=-1), axis=-1
    )
    sel1 = (x <= a0[..., None]) & valid
    sel2 = (blocked == 0) & valid & (x > a0[..., None])
    sel = jnp.where(equal_margins[..., None], sel1, sel1 | sel2)

    # max-shifted log-sum-exp over the selected support (the observed
    # table is always selected, so the max is finite)
    lm = jnp.where(sel, logp, -jnp.inf)
    M = jnp.max(lm, axis=-1, keepdims=True)
    ssum = jnp.sum(jnp.where(sel, jnp.exp(lm - M), 0.0), axis=-1)
    log_total = M[..., 0] + jnp.log(ssum)
    log_total = log_total + jnp.where(
        equal_margins, dtype(np.log(2.0)), dtype(0.0)
    )

    snap = 1e-12 if dtype == jnp.float64 else 1e-5
    neglog10 = -log_total / dtype(np.log(10.0))
    return jnp.where(
        log_total > dtype(np.log1p(-snap)), dtype(0.0), neglog10
    )


def _interp_ranks(npos: jnp.ndarray, perc: float, dtype=jnp.float64):
    """(idx, hi_idx, delta) of the reference's interpolated percentile
    (reference statistics/fisher/cFisher.c:136-144): with ascending order statistics s[.],
    result = (1-d)*s[idx] + d*s[hi_idx], idx = int((n-1)*perc),
    hi_idx = min(idx+1, n-1)."""
    nf = npos.astype(dtype)
    xpos = (nf - 1.0) * dtype(perc)
    idx = jnp.floor(xpos).astype(jnp.int32)
    delta = xpos - idx.astype(dtype)
    hi_idx = jnp.minimum(idx + 1, jnp.maximum(npos - 1, 0)).astype(jnp.int32)
    return idx, hi_idx, delta


def _pick_onehot(
    sorted_asc: jnp.ndarray,  # [B, P] ascending (pads FIRST), finite
    npos: jnp.ndarray,        # [B]
    rank: jnp.ndarray,        # [B, S] 0-based order-statistic ranks
) -> jnp.ndarray:
    """:func:`_sorted_pick` as a one-hot matmul contraction — for the
    [B, S] bootstrap picks, replacing a take_along_axis gather (whether
    the contraction beats the gather on a given device is ROADMAP item
    1.4's A/B).  The contraction is EXACT:
    exactly one product is 1*v, the rest are 0*v = 0 for finite v — so
    results are bit-identical to the gather as long as the operand holds
    no infinities (callers sanitize pads; 0 * inf would be NaN).
    Returns float32 picks (exact for f32 values and for int ranks below
    2^24)."""
    P = sorted_asc.shape[-1]
    pos = (P - npos[..., None] + rank).astype(jnp.int32)
    pos = jnp.clip(pos, 0, P - 1)
    oh = jax.nn.one_hot(pos, P, dtype=jnp.float32)        # [B, S, P]
    # Precision.HIGHEST pins the contraction to full f32 products: the
    # exactness argument (1*v + 0*...) assumes the value operand is not
    # rounded by a lower-precision pass (TF32 on the GPU).
    return jnp.einsum(
        "bsp,bp->bs", oh, sorted_asc.astype(jnp.float32),
        precision=jax.lax.Precision.HIGHEST,
    )


def _onehot_pick_fits(B: int, S: int, P: int) -> bool:
    """Static memory gate for :func:`_pick_onehot`: the one-hot
    materializes a [B, S, P] f32 tensor (~537 MB at the 1<<27 bound) —
    a large-padded-P geometry (sparse sampling, dense chromosomes) with
    the 4096-window slices would OOM where the element-at-a-time gather
    runs fine (round-5 review finding 3).  Production shapes (P=64-128,
    S=100, B<=4096) sit 2.6-5x below the bound — a dense chromosome
    padding P to 512 legitimately crosses it and takes the gather."""
    return B * S * P <= (1 << 27)


def _sorted_pick(sorted_asc: jnp.ndarray, npos: jnp.ndarray, rank: jnp.ndarray):
    """Value of ascending order statistic ``rank`` (0-based, per window)
    from a padded ascending sort where the n valid values occupy the LAST
    n positions (padding = -inf sorts first).  ``rank`` broadcasts over a
    trailing sample axis."""
    P = sorted_asc.shape[-1]
    pos = (P - npos[..., None] + rank).astype(jnp.int32)
    pos = jnp.clip(pos, 0, P - 1)
    return jnp.take_along_axis(sorted_asc, pos, axis=-1)


def _table_grid(asize: int, bsize: int) -> np.ndarray:
    """Every rectangular (f0, f1, f2, f3) combination with f0, f1 in
    [0, asize] and f2, f3 in [0, bsize], flattened row-major.  Includes
    unreachable combos (f0 + f1 > asize) — they cost a few wasted
    support scans in the one-off LUT build and are never gathered."""
    A1, B1 = asize + 1, bsize + 1
    g = np.indices((A1, A1, B1, B1), dtype=np.int32)
    return g.reshape(4, -1).T


def _neglog10_p(tables, maxs, nmax, dtype):
    """Per-table score ``-log10 p`` in the requested precision: linear
    f64 for exact mode (bit-parity with the C's doubles), log-space for
    f32 (p underflows float32 at large panels; the score does not —
    :func:`fet_two_tailed_neglog10`)."""
    if dtype == jnp.float64:
        return -jnp.log10(fet_two_tailed(tables, maxs, nmax, dtype=dtype))
    return fet_two_tailed_neglog10(tables, maxs, nmax, dtype=dtype)


@functools.partial(
    jax.jit, static_argnames=("asize", "maxs", "nmax", "fast")
)
def fet_snp_logs_joint(
    vals: jnp.ndarray,        # [N, asize+bsize] joint genotype upload
    asize: int,
    maxs: int,
    nmax: int,
    fast: bool = False,
) -> jnp.ndarray:
    """:func:`fet_snp_logs` over the single joint genotype array
    (SnpPair.device_values_joint) — the population split happens inside
    the program instead of as eager device slices (each eager op is one
    more dispatch)."""
    return fet_snp_logs(
        vals[:, :asize], vals[:, asize:], maxs, nmax, fast=fast
    )


@functools.partial(jax.jit, static_argnames=("maxs", "nmax", "fast"))
def fet_snp_logs(
    avals: jnp.ndarray,       # [N, asize] genotype codes, whole chromosome
    bvals: jnp.ndarray,       # [N, bsize]
    maxs: int,
    nmax: int,
    fast: bool = False,
) -> jnp.ndarray:
    """-log10 two-tailed FET p for EVERY SNP of a chromosome, once.

    Windows overlap wsize/wstep-fold (5x at reference defaults,
    reference statistics/css/css.c:117-135), so evaluating the exact test per (window, SNP) — as
    both the reference (reference statistics/fisher/cFisher.c:181) and the former bucket kernel do —
    recomputes each SNP's p up to 5x.  The engine computes this [N]
    array once per chromosome and windows gather from it
    (:func:`fet_aggregate_windows`): ~5x less support-scan compute and a
    [B, P] gather instead of [B, P, asize+bsize] genotype gathers.

    When the panel is small enough that the possible-table LUT is cheap
    to build ((asize+1)^2(bsize+1)^2 grid entries x the support scan;
    17,424 x ~132 for the 11+10 stickleback panel), the exact test is
    evaluated once per possible table and the per-SNP work collapses to
    count + one gather (~N/G fewer transcendentals).

    The switch is STATIC IN THE PANEL ONLY (round 5): it must not
    depend on the chromosome length, because slot-range host
    partitioning slices the SNP axis — an N-dependent switch could
    evaluate the same table through differently-SHAPED programs on
    different hosts, and XLA's shape-dependent vectorization makes the
    f32 log-space score differ in the last ulp across shapes, breaking
    the bit-identical-merge guarantee.  With a panel-only switch every
    host of a run takes the same branch by construction."""
    dtype = jnp.float32 if fast else jnp.float64
    asize, bsize = avals.shape[-1], bvals.shape[-1]
    A1, B1 = asize + 1, bsize + 1
    tables = count_tables(avals, bvals)
    if not lut_active(asize, bsize):
        return _neglog10_p(tables, maxs, nmax, dtype)
    grid = jnp.asarray(_table_grid(asize, bsize))
    lut = _neglog10_p(grid, maxs, nmax, dtype)
    t = tables
    idx = ((t[..., 0] * A1 + t[..., 1]) * B1 + t[..., 2]) * B1 + t[..., 3]
    return jnp.take(lut, idx, axis=0)


def _gather_windows_1d(values, lo, npos, P: int, L: int | None):
    """[Bp, P] windowed gather from a per-SNP [N] array.

    ``L = None``: direct ``jnp.take`` with [Bp, P] random-access
    indices into the whole chromosome.

    ``L`` static: TWO-STAGE gather — window descriptors arrive in plan
    order, so one map-slice's windows span a CONTIGUOUS range of the SNP
    axis (~Bp * density * wstep + P elements).  One dynamic_slice copies
    that span into a small local buffer (contiguous HBM read; the buffer
    fits VMEM), and the per-window gather indexes the buffer instead of
    the chromosome — measured 4.2x faster end-to-end
    (baseline/exp_fet_agg.py two-stage A/B: 1.68s -> 0.40s).  ``base``
    is clamped so the slice never runs off the array; pad rows
    (npos == 0) clip to index 0 and are masked downstream.  Gathered
    values are IDENTICAL, so results stay bit-identical."""
    offs = jnp.arange(P, dtype=lo.dtype)[None, :]
    if L is None:
        idx = jnp.where(offs < npos[:, None], lo[:, None] + offs, 0)
        return jnp.take(values, idx, axis=0)
    N = values.shape[0]
    base = jnp.minimum(lo[0], N - L)
    local = jax.lax.dynamic_slice_in_dim(values, base, L)
    idx = jnp.where(offs < npos[:, None], lo[:, None] - base + offs, 0)
    idx = jnp.clip(idx, 0, L - 1)
    return jnp.take(local, idx, axis=0)


def slice_span_bound(
    lo_valid: np.ndarray, n_valid: int, Bp: int, P: int, npadded: int
) -> int | None:
    """Static bound L for the two-stage gather: the max, over map
    slices of ``Bp`` plan-ordered windows, of the SNP-index span the
    slice touches (``lo[last] + P - lo[first]``), rounded to a power of
    two.  None when the bound reaches the array itself (degenerate
    plans — direct gather is then no worse)."""
    if n_valid == 0:
        return None
    n_slices = -(-n_valid // Bp)
    starts = np.arange(n_slices) * Bp
    ends = np.minimum(starts + Bp, n_valid) - 1
    spans = lo_valid[ends] + P - lo_valid[starts]
    L = 32
    while L < int(spans.max()):
        L *= 2
    return None if L >= npadded else L


def lut_active(asize: int, bsize: int, npadded: int = 0) -> bool:
    """Host-side mirror of :func:`fet_snp_logs`' static LUT switch.

    Panel-only since round 5 (``npadded`` is accepted for API
    compatibility and ignored): the switch must not depend on the
    chromosome length or slot-range host partitioning could route the
    same table through differently-shaped programs (see
    :func:`fet_snp_logs`).  The bound caps the one-off LUT build at
    ~1e8 support-scan ops — trivial against the per-SNP work it
    replaces at any chromosome size."""
    grid = (asize + 1) ** 2 * (bsize + 1) ** 2
    # the G < 2^24 term guards the rank path's exactness: int32 LUT
    # ranks round-trip through float32 in the one-hot pick contraction
    # (:func:`_pick_onehot`), which is exact only below 2^24 (round-5
    # review finding 3) — beyond it both the rank and float LUT paths
    # fall back to the direct per-SNP scan
    return (
        grid * support_size(asize, bsize) <= _LUT_MAX_BUILD_OPS
        and grid < (1 << 24)
    )


@functools.partial(
    jax.jit, static_argnames=("asize", "maxs", "nmax", "fast")
)
def fet_snp_ranks_joint(
    vals: jnp.ndarray,        # [N, asize+bsize] joint genotype upload
    asize: int,
    maxs: int,
    nmax: int,
    fast: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """LUT-compressed per-SNP representation: ``(lut_sorted, ranks)``.

    ``lut_sorted`` is the ascending sort of the per-table -log10 p LUT
    (G = (asize+1)^2(bsize+1)^2 entries); ``ranks[i]`` is SNP i's index
    into it.  Downstream aggregation (:func:`fet_aggregate_all_ranks`)
    then sorts / rank-selects int32 ranks instead of floats and maps
    back through one tiny gather at the very end — the window multiset
    of ``lut_sorted[ranks]`` is exactly the multiset of per-SNP logs, a
    non-decreasing map preserves order statistics, and ties gather equal
    values, so scores are BIT-IDENTICAL to the float path
    (tests/test_fet_kernel.py::test_rank_path_bit_identical).  The win:
    in exact mode (f64) the per-window sort —
    the largest aggregate-stage term — runs in native int32; only the
    G-entry LUT build touches f64.  Valid only when
    :func:`lut_active`; callers fall back to :func:`fet_snp_logs`."""
    dtype = jnp.float32 if fast else jnp.float64
    bsize = vals.shape[1] - asize
    A1, B1 = asize + 1, bsize + 1
    G = A1 * A1 * B1 * B1
    grid = jnp.asarray(_table_grid(asize, bsize))
    lut = _neglog10_p(grid, maxs, nmax, dtype)
    order = jnp.argsort(lut)
    lut_sorted = jnp.take(lut, order, axis=0)
    rank_of_entry = jnp.zeros((G,), jnp.int32).at[order].set(
        jnp.arange(G, dtype=jnp.int32)
    )
    t = count_tables(vals[:, :asize], vals[:, asize:])
    idx = ((t[..., 0] * A1 + t[..., 1]) * B1 + t[..., 2]) * B1 + t[..., 3]
    return lut_sorted, jnp.take(rank_of_entry, idx, axis=0)


@functools.partial(
    jax.jit, static_argnames=("Bp", "P", "perc", "nsamples", "fast", "L")
)
def fet_aggregate_all_ranks(
    lut_sorted: jnp.ndarray,  # [G] ascending LUT values
    ranks: jnp.ndarray,       # [N] per-SNP LUT ranks (fet_snp_ranks_joint)
    rows: jnp.ndarray,        # [3, Bt] packed lo/npos/slot, Bt % Bp == 0
    key: jax.Array,           # CHROMOSOME key
    Bp: int,
    P: int,
    perc: float,
    nsamples: int,
    fast: bool = False,
    L: int | None = None,     # static span bound for the two-stage gather
) -> jnp.ndarray:
    """Rank-space counterpart of :func:`fet_aggregate_all` (one device
    program per chromosome; same map-over-uniform-slices shape).
    Returns [2, Bt] (scores, stddev), bit-identical to the float path.
    ``L`` (slice_span_bound) switches the window gather to the two-stage
    contiguous-slice form, values identical."""
    dtype = jnp.float32 if fast else jnp.float64
    nb = rows.shape[1] // Bp

    def one(start):
        r = jax.lax.dynamic_slice_in_dim(rows, start, Bp, axis=1)
        lo, npos, slot = r[0], r[1], r[2]
        wranks = _gather_windows_1d(ranks, lo, npos, P, L)  # [Bp, P] i32
        wkeys = slot_keys(key, slot)
        s, d = _aggregate_ranks(
            wranks, npos, float(perc), wkeys, nsamples, lut_sorted, dtype
        )
        return jnp.stack([s, d])

    starts = jnp.arange(nb, dtype=jnp.int32) * Bp
    out = jax.lax.map(one, starts)                 # [nb, 2, Bp]
    return jnp.moveaxis(out, 0, 1).reshape(2, nb * Bp)


def _aggregate_ranks(
    ranks: jnp.ndarray,       # [B, P] per-(window, SNP) LUT ranks
    npos: jnp.ndarray,        # [B]
    perc: float,
    wkeys: jax.Array,         # [B] per-window keys (perm.slot_keys)
    nsamples: int,
    lut_sorted: jnp.ndarray,  # [G] ascending LUT values
    dtype,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """:func:`_aggregate` in LUT-rank space: identical rank arithmetic
    and bootstrap stream (same keys, same dtype uniforms), with the sort
    and every order-statistic selection over int32; the two percentile
    picks and the [B, S] bootstrap picks map through ``lut_sorted`` just
    before interpolation."""
    B, P = ranks.shape
    snp_mask = jnp.arange(P)[None, :] < npos[:, None]
    # pad = -1 sorts ahead of every valid rank (the -inf of int space);
    # _sorted_pick's end-anchored indexing never reads it for npos > 0
    r_sorted = jnp.sort(jnp.where(snp_mask, ranks, -1), axis=-1)

    def value_at(rank):
        picked = _sorted_pick(r_sorted, npos, rank)
        return jnp.take(
            lut_sorted, jnp.clip(picked, 0, lut_sorted.shape[0] - 1), axis=0
        )

    idx, hi_idx, delta = _interp_ranks(npos, perc, dtype=dtype)
    v_lo = value_at(idx[..., None])[..., 0]
    v_hi = value_at(hi_idx[..., None])[..., 0]
    scores = (1.0 - delta) * v_lo + delta * v_hi

    nf = npos.astype(dtype)[:, None]
    idx_f = idx.astype(dtype)[:, None]
    hi_f = hi_idx.astype(dtype)[:, None]
    t1 = jnp.maximum(nf - 1.0 - idx_f, 0.0)
    t2 = nf - 1.0 - hi_f
    steps_max = _steps_max(P, perc, dtype)
    u1, u2 = _order_stat_uniforms(
        wkeys, nf, t1, t2, nsamples, steps_max, dtype
    )

    def rank_of(u):
        r = jnp.ceil(nf * u) - 1.0
        return jnp.clip(r, 0.0, jnp.maximum(nf - 1.0, 0.0)).astype(jnp.int32)

    # bootstrap picks: one-hot contraction over the int32 ranks
    # (f32-exact below 2^24; the -1 pads are finite so no NaN hazard),
    # then one lut map per pick set
    def lutmap(r):
        return jnp.take(
            lut_sorted, jnp.clip(r, 0, lut_sorted.shape[0] - 1), axis=0
        )

    pick = (
        _pick_onehot
        if _onehot_pick_fits(r_sorted.shape[0], nsamples, r_sorted.shape[-1])
        else _sorted_pick
    )
    r1 = pick(r_sorted, npos, rank_of(u1)).astype(jnp.int32)
    x1 = lutmap(r1)                                         # [B, S]
    same = (hi_idx == idx)[:, None]
    r2 = pick(r_sorted, npos, rank_of(u2)).astype(jnp.int32)
    x2 = jnp.where(same, x1, lutmap(r2))
    reps = (1.0 - delta[:, None]) * x1 + delta[:, None] * x2
    mu = jnp.mean(reps, axis=-1, keepdims=True)
    stddev = jnp.sqrt(jnp.mean((reps - mu) ** 2, axis=-1))

    valid_w = npos > 0
    return (
        jnp.where(valid_w, scores, 0.0),
        jnp.where(valid_w, stddev, 0.0),
    )


@functools.partial(
    jax.jit, static_argnames=("perc", "nsamples", "P", "fast", "L")
)
def fet_aggregate_windows(
    snp_logs: jnp.ndarray,    # [N] per-SNP -log10 p (fet_snp_logs)
    lo: jnp.ndarray,          # [B] first SNP index per window
    npos: jnp.ndarray,        # [B] true SNP count per window
    slot: jnp.ndarray,        # [B] output slot (window genomic identity)
    perc: float,              # static percentile
    key: jax.Array,           # CHROMOSOME key; windows fold in their slot
    nsamples: int,
    P: int,                   # static padded SNP count
    fast: bool = False,
    L: int | None = None,     # static span bound for the two-stage gather
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Window percentile + bootstrap stddev over precomputed SNP logs."""
    dtype = jnp.float32 if fast else jnp.float64
    logs = _gather_windows_1d(snp_logs, lo, npos, P, L)   # [B, P]
    wkeys = slot_keys(key, slot)
    return _aggregate(logs, npos, float(perc), wkeys, nsamples, dtype)


@functools.partial(
    jax.jit, static_argnames=("Bp", "P", "perc", "nsamples", "fast", "L")
)
def fet_aggregate_all(
    snp_logs: jnp.ndarray,    # [N] per-SNP -log10 p (fet_snp_logs)
    rows: jnp.ndarray,        # [3, Bt] packed lo/npos/slot, Bt % Bp == 0
    key: jax.Array,           # CHROMOSOME key
    Bp: int,                  # static windows per map slice
    P: int,                   # static padded SNP count (uniform)
    perc: float,
    nsamples: int,
    fast: bool = False,
    L: int | None = None,     # static span bound for the two-stage gather
) -> jnp.ndarray:
    """Every window of a chromosome in ONE device program: ``lax.map``
    over uniform [Bp] slices of the packed window descriptors, each
    slice running :func:`fet_aggregate_windows` — one launch instead of
    a per-npos-bucket host loop (~7 launches + descriptor uploads per
    chromosome).  A uniform ``P`` is
    result-IDENTICAL: the sort pads with -inf below the valid ranks and
    the bootstrap's Renyi steps are drawn per ``fold_in(wkey, step)``
    and masked past each window's true step count
    (:func:`_order_stat_uniforms`).  Returns [2, Bt] (scores, stddev)."""
    nb = rows.shape[1] // Bp

    def one(start):
        r = jax.lax.dynamic_slice_in_dim(rows, start, Bp, axis=1)
        s, d = fet_aggregate_windows(
            snp_logs, r[0], r[1], r[2], perc, key, nsamples, P, fast, L
        )
        return jnp.stack([s, d])

    starts = jnp.arange(nb, dtype=jnp.int32) * Bp
    out = jax.lax.map(one, starts)                 # [nb, 2, Bp]
    return jnp.moveaxis(out, 0, 1).reshape(2, nb * Bp)


@functools.partial(
    jax.jit, static_argnames=("perc", "nsamples", "maxs", "nmax", "fast")
)
def fet_window_batch(
    avals: jnp.ndarray,       # [B, P, asize] genotype codes (any float/int)
    bvals: jnp.ndarray,       # [B, P, bsize]
    npos: jnp.ndarray,        # [B] true SNP count per window
    perc: float,              # static percentile
    key: jax.Array,           # PRNG key for the bootstrap
    nsamples: int,
    maxs: int,
    nmax: int,
    fast: bool = False,       # float32 compute (config precision="fast")
    slot: jnp.ndarray | None = None,  # [B] window slots; the arange
    # default is only stream-correct when the batch IS the complete,
    # ordered window set (self-contained/test use) — production callers
    # must pass genomic slots (start // wstep), never batch positions
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """FET scores + bootstrap stddev for one padded bucket of windows.

    Self-contained (genotypes in, scores out) — the form the sharded
    divergence step and the compile-check entry use.  The engine's
    production path splits this into :func:`fet_snp_logs` (per
    chromosome) + :func:`fet_aggregate_windows` (per bucket) to exploit
    window overlap; both paths share :func:`_aggregate` and produce
    bit-identical results for the same inputs, key, and slots.

    Padding rows (snp index >= npos) never influence the result: their
    scores are pinned to -inf, which sorts to the front of the ascending
    order, and all rank arithmetic offsets past them."""
    dtype = jnp.float32 if fast else jnp.float64
    tables = count_tables(avals, bvals)          # [B, P, 4]
    logs = _neglog10_p(tables, maxs, nmax, dtype)            # [B, P]
    if slot is None:
        slot = jnp.arange(npos.shape[0])
    wkeys = slot_keys(key, slot)
    return _aggregate(logs, npos, perc, wkeys, nsamples, dtype)


def _steps_max(P: int, perc: float, dtype) -> int:
    """Upper bound on the Renyi steps t1 = (n-1) - idx(n) over every
    window size n <= P, computed with the SAME dtype arithmetic as
    :func:`_interp_ranks`.  A float32-rounded (n-1)*perc can floor one
    BELOW the Python-float value (e.g. 75 * float32(0.84) -> 62.9999),
    and an undersized loop would silently leave U_(k1) at 1.0, pinning
    every bootstrap replicate's order statistic to the window maximum.
    numpy and XLA both round the single multiply per IEEE-754, so the
    host-side mirror is exact."""
    np_dtype = np.float32 if dtype == jnp.float32 else np.float64
    n1 = np.arange(P, dtype=np_dtype)              # n - 1 for n = 1..P
    idx = np.floor(n1 * np_dtype(perc))
    return int(np.max(n1 - idx))


def _order_stat_uniforms(
    wkeys: jax.Array,     # [B] per-window PRNG keys (slot-derived)
    nf: jnp.ndarray,      # [B, 1] true SNP counts as dtype
    t1: jnp.ndarray,      # [B, 1] steps to U_(k1): n - k1
    t2: jnp.ndarray,      # [B, 1] steps to U_(k2): n - k2 (<= t1)
    nsamples: int,
    steps_max: int,
    dtype,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(U_(k1), U_(k2)) joint order statistics of n iid uniforms, exact
    in law, via the Renyi top-down recursion
    U_(n) = V^(1/n), U_(k) = U_(k+1) * V^(1/k) — only (1-perc)*n pow
    ops per sample, versus ``jax.random.beta`` whose rejection-sampled
    gammas cost ~150x a uniform draw (data-dependent while_loops).

    Step j of the recursion produces U_(n-j); the per-window targets are
    captured with masks, so one fixed-length loop serves a whole bucket
    of varying n.  Each step draws its own [B, nsamples] uniform slice
    from ``fold_in(wkey_b, j)`` — live memory stays O(B * nsamples)
    regardless of ``steps_max`` (a low percentile makes steps_max scale
    as (1-perc)*P; one materialized [B, nsamples, steps_max+1] tensor
    was hundreds of MB at perc=0.25, P=4096).  Keys are PER WINDOW
    (slot-derived, see :func:`divergence_tpu.kernels.perm.slot_keys`), so every window's bootstrap
    stream is a pure function of its genomic identity — stddev is
    bit-identical under any batching/bucketing/sharding."""
    B = nf.shape[0]
    t1b = jnp.broadcast_to(t1, (B, nsamples))
    t2b = jnp.broadcast_to(t2, (B, nsamples))
    draw = jax.vmap(
        lambda k, j: jax.random.uniform(
            jax.random.fold_in(k, j), (nsamples,), dtype=dtype
        ),
        in_axes=(0, None),
    )

    def body(j, carry):
        u, u1, u2 = carry
        jf = jnp.asarray(j, dtype)
        v_j = draw(wkeys, j)                     # [B, nsamples]
        factor = v_j ** (1.0 / jnp.maximum(nf - jf, 1.0))
        u = jnp.where(jf <= t1b, u * factor, u)
        u2 = jnp.where(jf == t2b, u, u2)
        u1 = jnp.where(jf == t1b, u, u1)
        return u, u1, u2

    ones = jnp.ones((B, nsamples), dtype)
    _, u1, u2 = jax.lax.fori_loop(
        0, steps_max + 1, body, (ones, ones, ones)
    )
    return u1, u2


def _aggregate(
    logs: jnp.ndarray,        # [B, P] per-(window, SNP) -log10 p
    npos: jnp.ndarray,        # [B]
    perc: float,              # static
    wkeys: jax.Array,         # [B] per-window keys (perm.slot_keys)
    nsamples: int,
    dtype,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    B, P = logs.shape
    snp_mask = jnp.arange(P)[None, :] < npos[:, None]
    neg = dtype(-jnp.inf)
    logs_sorted = jnp.sort(jnp.where(snp_mask, logs, neg), axis=-1)

    idx, hi_idx, delta = _interp_ranks(npos, perc, dtype=dtype)
    v_lo = _sorted_pick(logs_sorted, npos, idx[..., None])[..., 0]
    v_hi = _sorted_pick(logs_sorted, npos, hi_idx[..., None])[..., 0]
    scores = (1.0 - delta) * v_lo + delta * v_hi

    # Bootstrap stddev via order statistics (reference statistics/fisher/cFisher.c:562-571, 590-597
    # semantics, identical in distribution): the percentile of a
    # resample of n draws interpolates its ascending order statistics at
    # ranks k1 = idx+1 and k2 = hi_idx+1 (1-based); the joint
    # (U_(k1), U_(k2)) comes from the Renyi recursion
    # (:func:`_order_stat_uniforms` — exact in law, no beta/gamma
    # rejection sampling).  The resample's order statistic
    # X_(k) = empirical quantile at U_(k) = sorted[ceil(n*U_(k)) - 1].
    nf = npos.astype(dtype)[:, None]                        # [B, 1]
    idx_f = idx.astype(dtype)[:, None]
    hi_f = hi_idx.astype(dtype)[:, None]
    # steps down from U_(n): t1 = n - k1 = n - 1 - idx;
    # t2 = n - k2 = n - 1 - hi_idx (t2 < 0 for empty windows: the
    # capture mask never fires and valid_w zeroes the result)
    t1 = jnp.maximum(nf - 1.0 - idx_f, 0.0)
    t2 = nf - 1.0 - hi_f
    steps_max = _steps_max(P, perc, dtype)
    u1, u2 = _order_stat_uniforms(
        wkeys, nf, t1, t2, nsamples, steps_max, dtype
    )

    def rank_of(u):
        r = jnp.ceil(nf * u) - 1.0
        return jnp.clip(r, 0.0, jnp.maximum(nf - 1.0, 0.0)).astype(jnp.int32)

    if dtype == jnp.float32 and _onehot_pick_fits(
        logs_sorted.shape[0], nsamples, logs_sorted.shape[-1]
    ):
        # [B, S] picks as one-hot contractions (bit-identical to the
        # take_along_axis gather).
        # Sanitize the -inf pads first: 0 * inf = NaN in the contraction
        # (valid windows never pick a pad position — end-anchored ranks).
        # The only non-finite entries ARE pads: f32 per-SNP scores come
        # from the log-space path (fet_two_tailed_neglog10), which is
        # finite for every table — the exp-then-log form could underflow
        # p to 0 at large panels and emit a legit +inf here, which this
        # where() would have silently rewritten to 0 in the bootstrap
        # (round-5 review finding 2)
        safe = jnp.where(jnp.isfinite(logs_sorted), logs_sorted, dtype(0.0))
        x1 = _pick_onehot(safe, npos, rank_of(u1))          # [B, S]
        same = (hi_idx == idx)[:, None]
        x2 = jnp.where(same, x1, _pick_onehot(safe, npos, rank_of(u2)))
    else:
        x1 = _sorted_pick(logs_sorted, npos, rank_of(u1))   # [B, S]
        same = (hi_idx == idx)[:, None]
        x2 = jnp.where(
            same, x1, _sorted_pick(logs_sorted, npos, rank_of(u2))
        )
    reps = (1.0 - delta[:, None]) * x1 + delta[:, None] * x2
    mu = jnp.mean(reps, axis=-1, keepdims=True)
    stddev = jnp.sqrt(jnp.mean((reps - mu) ** 2, axis=-1))

    valid_w = npos > 0
    return (
        jnp.where(valid_w, scores, 0.0),
        jnp.where(valid_w, stddev, 0.0),
    )
