"""Batched Cluster-Separation-Score kernel.

Replaces the reference's per-window serial pipeline (reference statistics/css/css.c:181-223) with
batched tensor math over all windows of a bucket at once:

* dissimilarity counting (reference statistics/css/css.c:277-327) — the mismatch predicate
  ``value product == -9`` factorizes as (v==3) x (v==-3), so the whole
  m x m pair-count matrix is two one-hot bf16 matmuls:
  ``D = Maj^T Mnr + Mnr^T Maj`` (exact integer counts accumulated in f32);
* fill-averages + discard rule (reference statistics/css/css.c:337-366), quirks preserved: the
  average divides by all m^2 cells, the zero diagonal gets filled with the
  average too, and windows with more than m*m//2 near-zero cells are
  discarded;
* classical MDS (reference statistics/css/css.c:505-560) — double centering plus a *batched*
  top-2 eigensolve (kernels.linalg) instead of one GSL solve per window;
* SMACOF (reference statistics/css/css.c:852-938) — fixed-trip-count ``lax.scan`` with per-window
  convergence freezing, replicating the reference's
  ``while (k==0 || (sigma_prev - sigma > eps && k <= max_iters))`` loop;
* CSS score (reference statistics/css/css.c:608-647) — between-group block mean minus the
  adjacent-chain within terms.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from divergence_tpu.kernels.linalg import top2_eig
from divergence_tpu.kernels.perm import slot_keys


def dissimilarity_counts(
    vals: jnp.ndarray, snp_mask: jnp.ndarray
) -> jnp.ndarray:
    """Pairwise genotype-mismatch counts.

    ``vals``: [B, P, m] genotype codes of all m individuals (groups
    concatenated), ``snp_mask``: [B, P] validity.  Returns [B, m, m] f64
    counts with zero diagonal (an individual is never both hom-major and
    hom-minor)."""
    maj = ((vals == 3) & snp_mask[..., None]).astype(jnp.bfloat16)
    mnr = ((vals == -3) & snp_mask[..., None]).astype(jnp.bfloat16)
    d = jax.lax.dot_general(
        maj,
        mnr,
        dimension_numbers=(((1,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )  # [B, m, m]
    d = d + jnp.swapaxes(d, -1, -2)
    return d.astype(jnp.float64)


def dissimilarity_prefix(vals: jnp.ndarray) -> jnp.ndarray:
    """Chromosome-wide prefix sums of the per-SNP mismatch contributions.

    ``vals``: [N, m] genotype codes.  Returns [N+1, m, m] with
    ``prefix[n] = sum_{k<n} M_k`` where ``M_k[i,j] = 1`` iff individuals
    i and j are opposite homozygotes at SNP k (the reference statistics/css/css.c:277-327
    predicate).  A window's dissimilarity is then ONE difference
    ``prefix[lo+npos] - prefix[lo]`` — windows overlap wsize/wstep-fold,
    so this replaces the per-window [P, m] matmul contraction with
    O(N m^2) total work and removes the [B, P, m] genotype gathers
    entirely.

    Exactness: the entries are integer counts <= N; the prefix is f32
    (exact to 2^24) below that and f64 above, so window differences are
    bit-exact counts either way."""
    N, m = vals.shape
    maj = vals == 3
    mnr = vals == -3
    mk = (maj[:, :, None] & mnr[:, None, :]) | (
        mnr[:, :, None] & maj[:, None, :]
    )
    acc = jnp.float32 if N < (1 << 24) else jnp.float64
    pref = jnp.cumsum(mk.astype(acc), axis=0)
    return jnp.concatenate([jnp.zeros((1, m, m), dtype=acc), pref])


def dissimilarity_from_prefix(
    prefix: jnp.ndarray,    # [N+1, m, m]
    lo: jnp.ndarray,        # [B]
    npos: jnp.ndarray,      # [B]
) -> jnp.ndarray:
    """Per-window dissimilarity counts from the chromosome prefix."""
    hi = jnp.take(prefix, lo + npos, axis=0)
    lo_v = jnp.take(prefix, lo, axis=0)
    return (hi - lo_v).astype(jnp.float64)


def dissimilarity_freq(
    avals: jnp.ndarray,
    bvals: jnp.ndarray,
    npos: jnp.ndarray,
    snp_mask: jnp.ndarray,
) -> jnp.ndarray:
    """Drosophila frequency metric (reference statistics/css/css.c:245-264): 2x2 matrix with the
    mean absolute frequency difference off-diagonal.

    ``avals``/``bvals``: [B, P, 1]."""
    diff = jnp.abs(avals[..., 0] - bvals[..., 0])
    avg = jnp.sum(jnp.where(snp_mask, diff, 0.0), axis=-1) / jnp.maximum(
        npos.astype(jnp.float64), 1
    )
    zero = jnp.zeros_like(avg)
    return jnp.stack(
        [
            jnp.stack([zero, avg], axis=-1),
            jnp.stack([avg, zero], axis=-1),
        ],
        axis=-2,
    )


def fill_averages(dis: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Average-fill + discard rule (reference statistics/css/css.c:337-366).

    Returns (filled [B, m, m], keep [B] bool).  Quirks preserved: the
    average divides by m^2 (all cells, including the always-zero diagonal)
    and the diagonal is overwritten with the average; discard when the
    near-zero count exceeds m*m//2 (C integer division)."""
    m = dis.shape[-1]
    unval = dis < 0.00001
    total = m * m
    avg = jnp.sum(jnp.where(unval, 0.0, dis), axis=(-1, -2)) / total
    n_unval = jnp.sum(unval, axis=(-1, -2))
    keep = n_unval <= total // 2
    filled = jnp.where(unval, avg[..., None, None], dis)
    return filled, keep


def cmds(dis: jnp.ndarray) -> jnp.ndarray:
    """Classical MDS to 2 dimensions (reference statistics/css/css.c:505-560).

    Double-centers the squared dissimilarities (B = -1/2 J D2 J, expressed
    as row/col/grand mean subtraction) and keeps the top-2 eigenpairs;
    X = Q sqrt(L).  A negative retained eigenvalue yields NaN coordinates
    exactly like the reference's sqrt."""
    d2 = dis * dis
    row = jnp.mean(d2, axis=-1, keepdims=True)
    col = jnp.mean(d2, axis=-2, keepdims=True)
    grand = jnp.mean(d2, axis=(-1, -2), keepdims=True)
    b = -0.5 * (d2 - row - col + grand)
    vals, vecs = top2_eig(b)                     # [B, 2], [B, m, 2]
    # zero out numerical dust so a true-zero second eigenvalue doesn't
    # turn into sqrt(-eps) = NaN; the dust bound is DTYPE-dependent —
    # float32 rounding leaves ~1e-7-relative residues, far past the
    # f64-calibrated 1e-9 (found round 3 as NaN-scored fast-mode
    # drosophila windows: the 2x2 case has an exactly-zero second
    # eigenvalue).  Genuinely negative eigenvalues still produce NaN
    # exactly like the reference's sqrt (reference statistics/css/css.c:557-559);
    # in fast mode the distinction is only resolvable down to f32
    # precision, consistent with its documented ~1e-5 score tolerance.
    dust = 1e-5 if vals.dtype == jnp.float32 else 1e-9
    scale = jnp.maximum(jnp.abs(vals[..., :1]), 1.0)
    vals = jnp.where(
        (vals < 0) & (vals > -dust * scale), 0.0, vals
    )
    return vecs * jnp.sqrt(vals)[..., None, :]


def calc_dist(x: jnp.ndarray) -> jnp.ndarray:
    """Pairwise Euclidean distances of the embedding (reference statistics/css/css.c:573-587).
    ``x``: [B, m, 2] -> [B, m, m]."""
    diff = x[..., :, None, :] - x[..., None, :, :]
    return jnp.sqrt(jnp.sum(diff * diff, axis=-1))


def chain_weights_host(asize: int, bsize: int):
    """Static [m-1] weights of the within-group adjacent-chain terms in
    track order (reference statistics/css/css.c:627-642): 1/(a^2(a-1)) for the a-chain,
    1/(b^2(b-1)) for the b-chain, 0 at the group boundary and for
    singleton groups.  Host-side numpy — the single source of truth
    for every evaluator (XLA and native)."""
    import numpy as np

    m = asize + bsize
    w = np.zeros(m - 1)
    if asize > 1:
        w[: asize - 1] = 1.0 / (asize * asize * (asize - 1))
    if bsize > 1:
        w[asize:] = 1.0 / (bsize * bsize * (bsize - 1))
    return w


def chain_weights(asize: int, bsize: int) -> jnp.ndarray:
    """Device form of :func:`chain_weights_host`."""
    return jnp.asarray(chain_weights_host(asize, bsize))


def css_from_dist(
    dist: jnp.ndarray, asize: int, bsize: int
) -> jnp.ndarray:
    """CSS with identity track order (reference statistics/css/css.c:608-647).

    score = mean(between-block) - (a+b) * (a-chain + b-chain)."""
    m = asize + bsize
    bet = jnp.mean(dist[..., :asize, asize:], axis=(-1, -2))
    diag1 = jnp.diagonal(dist, offset=1, axis1=-2, axis2=-1)  # [B, m-1]
    chain = jnp.sum(diag1 * chain_weights(asize, bsize), axis=-1)
    return bet - m * chain


def _stress(dis: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Raw stress over unordered pairs (reference statistics/css/css.c:767-777): the full matrix
    double-counts every pair, so halve it; the diagonal is zero in both."""
    diff = d - dis
    return 0.5 * jnp.sum(diff * diff, axis=(-1, -2))


def _guttman(
    x: jnp.ndarray, d: jnp.ndarray, dis: jnp.ndarray
) -> jnp.ndarray:
    """One Guttman transform (reference statistics/css/css.c:811-836): X' = B(Z) Z / m."""
    m = dis.shape[-1]
    off = ~jnp.eye(m, dtype=bool)
    b = jnp.where(off & (d >= 0.00001), -dis / jnp.where(d == 0, 1.0, d), 0.0)
    rowsum = jnp.sum(b, axis=-1)
    b = b - rowsum[..., None] * jnp.eye(m, dtype=b.dtype)
    # HIGHEST: a float32 matmul may otherwise run in TF32 on the GPU
    return jnp.matmul(b, x, precision=jax.lax.Precision.HIGHEST) / m


@functools.partial(jax.jit, static_argnames=("max_iters",))
def smacof(
    dis: jnp.ndarray,
    x0: jnp.ndarray,
    max_iters: int = 300,
    epsilon: float = 1e-6,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Batched SMACOF (reference statistics/css/css.c:907-938).

    ``dis``: [..., m, m], ``x0``: [..., m, 2].  Runs the reference's loop
    protocol — first transform unconditional, then continue while the
    stress improvement exceeds epsilon and k <= max_iters (so up to
    max_iters + 1 transforms) — as a fixed-length scan with per-element
    freezing.  Returns (x, sigma)."""
    d0 = calc_dist(x0)
    sig0 = _stress(dis, d0)
    # derived from sig0 (not jnp.ones) so the carry keeps sig0's varying
    # manual axes under shard_map
    active0 = sig0 == sig0

    def body(carry, _):
        x, d, sig, active = carry
        xn = _guttman(x, d, dis)
        dn = calc_dist(xn)
        sign = _stress(dis, dn)
        improved = (sig - sign) > epsilon
        x = jnp.where(active[..., None, None], xn, x)
        d = jnp.where(active[..., None, None], dn, d)
        sig_out = jnp.where(active, sign, sig)
        return (x, d, sig_out, active & improved), None

    (x, _, sig, _), _ = jax.lax.scan(
        body, (x0, d0, sig0, active0), None, length=max_iters + 1
    )
    return x, sig


def smacof_runs(
    dis: jnp.ndarray,
    wkeys: jax.Array,     # [B] per-window keys (perm.slot_keys)
    n_init: int = 4,
    max_iters: int = 300,
    epsilon: float = 1e-6,
) -> jnp.ndarray:
    """SMACOF with random restarts, best-of-N by stress (reference statistics/css/css.c:852-884).

    Inits are uniform [0,1) like the reference's drand48 (different,
    deterministic stream); each window draws its inits from its OWN
    slot-derived key, so the chosen embedding — hence the score — is
    invariant under batching/bucketing (docs/PARITY.md "Stream
    identity").  ``dis``: [B, m, m] -> [B, m, 2]."""
    B, m = dis.shape[0], dis.shape[-1]
    x0 = jax.vmap(
        lambda k: jax.random.uniform(k, (n_init, m, 2), dtype=dis.dtype)
    )(wkeys)                              # [B, I, m, 2]
    x0 = jnp.moveaxis(x0, 0, 1)           # [I, B, m, 2]
    x, sig = smacof(dis[None], x0, max_iters, epsilon)   # [I, B, ...]
    best = jnp.argmin(sig, axis=0)                       # [B]
    return jnp.take_along_axis(
        x, best[None, :, None, None], axis=0
    )[0]


@functools.partial(
    jax.jit, static_argnames=("asize", "bsize", "drosophila", "mds",
                              "smacof_iters", "smacof_inits", "fast")
)
def css_window_batch(
    avals: jnp.ndarray,    # [B, P, asize]
    bvals: jnp.ndarray,    # [B, P, bsize]
    npos: jnp.ndarray,     # [B]
    key: jax.Array,
    asize: int,
    bsize: int,
    drosophila: bool = False,
    mds: int = 0,
    smacof_iters: int = 300,
    smacof_inits: int = 4,
    smacof_eps: float = 1e-6,
    fast: bool = False,    # float32 compute (config precision="fast")
    slot: jnp.ndarray | None = None,  # [B] window slots; the arange
    # default is only stream-correct when the batch IS the complete,
    # ordered window set — production callers pass genomic slots
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """CSS scores for one padded bucket of windows.

    Returns (scores [B], dist [B, m, m], valid [B]).  ``valid`` is False
    for empty windows and fill-averages discards; their score reports 0
    and their distance matrix is meaningless (callers skip them).  The
    drosophila path scores 2 pseudo-individuals on frequency tracks
    (reference statistics/css/css.c:245-264, asize == bsize == 1)."""
    dtype = jnp.float32 if fast else jnp.float64
    P = avals.shape[1]
    snp_mask = jnp.arange(P)[None, :] < npos[:, None]

    if slot is None:
        slot = jnp.arange(npos.shape[0])
    if drosophila:
        dis = dissimilarity_freq(avals, bvals, npos, snp_mask)
        a_sz = b_sz = 1
    else:
        vals = jnp.concatenate([avals, bvals], axis=-1)
        dis = dissimilarity_counts(vals, snp_mask)
        a_sz, b_sz = asize, bsize
    return _score_pipeline(
        dis.astype(dtype), npos, slot_keys(key, slot), a_sz, b_sz, mds,
        smacof_iters, smacof_inits, smacof_eps,
    )


@functools.partial(
    jax.jit, static_argnames=("asize", "bsize", "mds", "smacof_iters",
                              "smacof_inits", "fast")
)
def css_window_batch_prefix(
    prefix: jnp.ndarray,   # [N+1, m, m] dissimilarity_prefix
    lo: jnp.ndarray,       # [B]
    npos: jnp.ndarray,     # [B]
    key: jax.Array,
    asize: int,
    bsize: int,
    mds: int = 0,
    smacof_iters: int = 300,
    smacof_inits: int = 4,
    smacof_eps: float = 1e-6,
    fast: bool = False,
    slot: jnp.ndarray | None = None,  # [B] window slots; arange default
    # only stream-correct for a complete ordered window set
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """CSS scores from chromosome prefix sums (the engine's production
    stickleback path — see :func:`dissimilarity_prefix`).  Bit-identical
    counts, hence bit-identical scores, to :func:`css_window_batch`."""
    dtype = jnp.float32 if fast else jnp.float64
    dis = dissimilarity_from_prefix(prefix, lo, npos).astype(dtype)
    if slot is None:
        slot = jnp.arange(npos.shape[0])
    return _score_pipeline(
        dis, npos, slot_keys(key, slot), asize, bsize, mds,
        smacof_iters, smacof_inits, smacof_eps,
    )


@functools.partial(
    jax.jit, static_argnames=("Bp", "asize", "bsize", "mds",
                              "smacof_iters", "smacof_inits", "fast")
)
def css_prefix_all(
    vals: jnp.ndarray,     # [N, m] joint genotype upload (A cols first)
    rows: jnp.ndarray,     # [3, Bt] packed lo/npos/slot, Bt % Bp == 0
    key: jax.Array,
    Bp: int,
    asize: int,
    bsize: int,
    mds: int = 0,
    smacof_iters: int = 300,
    smacof_inits: int = 4,
    smacof_eps: float = 1e-6,
    fast: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Every window of a chromosome in ONE device program: the
    chromosome-wide mismatch prefix (:func:`dissimilarity_prefix`,
    hoisted out of the loop by XLA) + ``lax.map`` over uniform [Bp]
    slices of the packed window descriptors, each slice running
    :func:`css_window_batch_prefix` (per-window results identical —
    dispatch rationale in the engine).  Returns
    (scores [Bt], dist [Bt, m, m], valid [Bt])."""
    prefix = dissimilarity_prefix(vals)
    nb = rows.shape[1] // Bp

    def one(start):
        r = jax.lax.dynamic_slice_in_dim(rows, start, Bp, axis=1)
        return css_window_batch_prefix(
            prefix, r[0], r[1], key, asize=asize, bsize=bsize, mds=mds,
            smacof_iters=smacof_iters, smacof_inits=smacof_inits,
            smacof_eps=smacof_eps, fast=fast, slot=r[2],
        )

    starts = jnp.arange(nb, dtype=jnp.int32) * Bp
    s, dist, valid = jax.lax.map(one, starts)    # [nb, Bp(, m, m)]
    m = dist.shape[-1]
    return (
        s.reshape(nb * Bp),
        dist.reshape(nb * Bp, m, m),
        valid.reshape(nb * Bp),
    )


@functools.partial(
    jax.jit, static_argnames=("Bp", "P", "asize", "bsize", "drosophila",
                              "mds", "smacof_iters", "smacof_inits", "fast")
)
def css_gather_all(
    avals: jnp.ndarray,    # [N, asize] chromosome genotype/frequency cols
    bvals: jnp.ndarray,    # [N, bsize]
    rows: jnp.ndarray,     # [3, Bt] packed lo/npos/slot, Bt % Bp == 0
    key: jax.Array,
    Bp: int,
    P: int,                # static padded SNP count (uniform)
    asize: int,
    bsize: int,
    drosophila: bool = False,
    mds: int = 0,
    smacof_iters: int = 300,
    smacof_inits: int = 4,
    smacof_eps: float = 1e-6,
    fast: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """The gather-path chromosome sweep (drosophila frequency tracks and
    chromosomes over the prefix memory budget) as ONE device program:
    ``lax.map`` over uniform [Bp] descriptor slices, window genotypes
    gathered in-program at a uniform padded P (rows past ``npos`` are
    masked in the kernels, so a uniform P is result-identical to the
    per-npos buckets it replaces).  Returns
    (scores [Bt], dist [Bt, m, m], valid [Bt])."""
    offs = jnp.arange(P, dtype=rows.dtype)[None, :]
    nb = rows.shape[1] // Bp

    def one(start):
        r = jax.lax.dynamic_slice_in_dim(rows, start, Bp, axis=1)
        lo, npos, slot = r[0], r[1], r[2]
        idx = jnp.where(offs < npos[:, None], lo[:, None] + offs, 0)
        av = jnp.take(avals, idx, axis=0)
        bv = jnp.take(bvals, idx, axis=0)
        return css_window_batch(
            av, bv, npos, key, asize=asize, bsize=bsize,
            drosophila=drosophila, mds=mds, smacof_iters=smacof_iters,
            smacof_inits=smacof_inits, smacof_eps=smacof_eps, fast=fast,
            slot=slot,
        )

    starts = jnp.arange(nb, dtype=jnp.int32) * Bp
    s, dist, valid = jax.lax.map(one, starts)
    m = dist.shape[-1]
    return (
        s.reshape(nb * Bp),
        dist.reshape(nb * Bp, m, m),
        valid.reshape(nb * Bp),
    )


def _score_pipeline(
    dis: jnp.ndarray,      # [B, m, m] window dissimilarities (dtype set)
    npos: jnp.ndarray,
    wkeys: jax.Array,      # [B] per-window keys (perm.slot_keys)
    a_sz: int,
    b_sz: int,
    mds: int,
    smacof_iters: int,
    smacof_inits: int,
    smacof_eps: float,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    filled, keep = fill_averages(dis)

    if mds == 0:
        x = cmds(filled)
    elif mds == 1:
        x = smacof_runs(filled, wkeys, smacof_inits, smacof_iters, smacof_eps)
    else:
        x0 = cmds(filled)
        x, _ = smacof(filled, x0, smacof_iters, smacof_eps)

    dist = calc_dist(x)
    scores = css_from_dist(dist, a_sz, b_sz)
    valid = keep & (npos > 0)
    return jnp.where(valid, scores, 0.0), dist, valid
