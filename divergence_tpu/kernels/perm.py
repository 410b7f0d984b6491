"""Chunked permutation Monte-Carlo for CSS significance.

The reference permutes labels one at a time per window until 10 hits or
200k permutations (reference statistics/css/css.c:727-752) — up to 200k serial CSS re-evaluations
per significant window, THE dominant cost (SURVEY.md §3.2).  Here the
whole adaptive loop runs ON DEVICE as a ``lax.while_loop`` over
fixed-shape chunks:

* one iteration evaluates ``chunk`` random permutations for every window
  of the batch at once;
* the permuted CSS decomposes into one batched matmul plus tiny gathers —
  no m x m matrix is ever materialized per permutation:
  between-sum = u^T D (1-u) with u the group-A indicator of the
  permutation, and the within-group *adjacent-chain* sums
  (order-dependent!  reference statistics/css/css.c:627-641) are m-2 gathers from the flattened
  distance matrix;
* the estimator is exactly the reference's p = (hits+1)/(n+1) with
  n = the permutation index of the threshold-th hit (located inside the
  chunk by cumulative sum), or n = runs at the cap;
* the loop exits as soon as every window of the batch has either reached
  the hit threshold or consumed ``runs`` permutations — one host
  dispatch and one device->host sync for the entire Monte-Carlo of a
  window batch (a host-driven round trip per chunk would serialize
  the loop on the host).

RNG design: every window owns an independent stream derived as
``fold_in(fold_in(fold_in(key, chrom_hash), slot), chunk_idx)`` — a pure
function of (seed, chromosome, window slot).  P-values are therefore
bit-identical under ANY batching, padding, device sharding, or
multi-host chromosome partitioning (the reference's per-thread
wall-clock seeding, reference statistics/css/threadcss.c:220-223, has no such property; SURVEY.md
§5 seed semantics).

Device placement: every entry point takes ``sharding=`` and places the
window-batch axis with it — the SAME window-axis data-parallel mechanism
the engines use for phase 1, making the MC (SURVEY §3.2 hot loop B)
scale over a mesh instead of serializing on the default device.
"""

from __future__ import annotations

import dataclasses
import functools
import zlib

import numpy as np

import jax
import jax.numpy as jnp

def chrom_hash(seqid: str) -> int:
    """Stable 31-bit chromosome identifier for RNG stream derivation
    (stable across python processes, hosts, and partitionings)."""
    return zlib.crc32(seqid.encode()) & 0x7FFFFFFF


@jax.jit
def window_keys(key: jax.Array, chroms: jnp.ndarray, slots: jnp.ndarray):
    """Per-window PRNG keys: fold (chromosome, slot) into the run key."""
    k1 = jax.vmap(lambda c: jax.random.fold_in(key, c))(chroms)
    return jax.vmap(jax.random.fold_in)(k1, slots)


def slot_keys(key: jax.Array, slots: jnp.ndarray) -> jax.Array:
    """Per-window PRNG keys from a CHROMOSOME-level key: fold_in(key,
    slot).  The slot (= window_start // wstep, the window's output
    index) is a pure function of the window's genomic position, so any
    stream derived this way is invariant under batching, bucket splits,
    sharding, ``--resume``, and host partitioning (docs/PARITY.md
    "Stream identity")."""
    return jax.vmap(jax.random.fold_in, in_axes=(None, 0))(key, slots)


def _mix32(x: jnp.ndarray) -> jnp.ndarray:
    """32-bit avalanche (murmur3-style finalizer, Prospector constants)."""
    x = (x ^ (x >> jnp.uint32(16))) * jnp.uint32(0x7FEB352D)
    x = (x ^ (x >> jnp.uint32(15))) * jnp.uint32(0x846CA68B)
    return x ^ (x >> jnp.uint32(16))


def _mix_bits(keys: jax.Array, chunk: int, m: int) -> jnp.ndarray:
    """[B, chunk, m] uint32 counter-expanded random bits.

    The per-(window, chunk) 64-bit stream state is the raw threefry key
    (already ``fold_in(seed, chrom, slot, chunk)``-derived — stream
    SEPARATION keeps threefry's guarantees); only the intra-block
    expansion of chunk*m words is the cheap counter mix
    ``mix32(mix32(a ^ c) + b)`` — a bijection of the counter keyed by
    the 64-bit state.  Pure elementwise jnp: output is a function of
    (state, counter) alone, so batching/sharding invariance holds by
    construction (XLA's RngBitGenerator has no such guarantee under
    GSPMD).  Threefry bit generation was 63% of the MC kernel's CPU
    wall time; this expansion is ~25x cheaper.
    """
    st = jax.random.key_data(keys)                    # [B, 2] uint32
    ctr = jnp.arange(chunk * m, dtype=jnp.uint32)[None, :]
    h = _mix32(_mix32(st[:, 0:1] ^ ctr) + st[:, 1:2])
    return h.reshape(len(keys), chunk, m)


def _ranks(keys: jax.Array, chunk: int, m: int, bitgen: str) -> jnp.ndarray:
    """Permutation ranks [B, m, K] i32: position of individual j in the
    stable ascending order of per-(window, perm) random draws, computed
    by pairwise compares with index tie-break (identical to a stable
    argsort, with no sort).  ``bitgen="mix"`` ranks raw uint32 counter
    bits; ``"threefry"`` ranks f32 uniforms drawn from the key stream
    (the round-1 stream, kept selectable for reproduction)."""
    if bitgen == "mix":
        xt = jnp.moveaxis(_mix_bits(keys, chunk, m), -1, -2)   # [B,m,K] u32
    else:
        x = jax.vmap(
            lambda k: jax.random.uniform(k, (chunk, m), dtype=jnp.float32)
        )(keys)
        xt = jnp.moveaxis(x, -1, -2)                           # [B, m, K]
    xj = xt[:, :, None, :]
    xl = xt[:, None, :, :]
    tie = (jnp.arange(m)[:, None] > jnp.arange(m)[None, :])[None, :, :, None]
    cmp = (xj > xl) | ((xj == xl) & tie)
    return jnp.sum(cmp.astype(jnp.int32), axis=2)              # [B, m, K]


def _chain_weights(asize: int, bsize: int):
    wa = 1.0 / (asize * asize * (asize - 1)) if asize > 1 else 0.0
    wb = 1.0 / (bsize * bsize * (bsize - 1)) if bsize > 1 else 0.0
    return wa, wb


def _scores_from_ranks(
    distf: jnp.ndarray,   # [B, m, m] f32
    r: jnp.ndarray,       # [B, m, K] i32 ranks
    asize: int,
    bsize: int,
    form: str = "broadcast",
) -> jnp.ndarray:
    """CSS of the rank-encoded permutations: [B, K] f32.

    ``form="broadcast"``: one fused [B, m, m, K] coefficient pass (the
    CPU winner — XLA fuses it into the reduction).  ``form="matmul"``:
    the between-group sum via the +-1 identity
    ``u^T D (1-u) = (S - v^T D v)/4`` (v = 2u-1; exact for the symmetric
    zero-irrelevant-diagonal CSS distance matrices) so the m^2 work
    rides a batched matmul and only the adjacent-chain
    term keeps a broadcast pass — kept for the hardware A/B
    (tools/bench_mc.py)."""
    m = distf.shape[-1]
    wa, wb = _chain_weights(asize, bsize)
    wj = wa * (r < asize - 1) + wb * ((r >= asize) & (r < m - 1))
    adj = (r[:, None, :, :] == r[:, :, None, :] + 1).astype(jnp.float32)
    if form == "matmul":
        v = jnp.where(r < asize, 1.0, -1.0)            # [B, m, K]
        vdv = jnp.sum(
            v * jnp.matmul(distf, v, precision=jax.lax.Precision.HIGHEST),
            axis=1,
        )
        s = jnp.sum(distf, axis=(1, 2))
        between = (s[:, None] - vdv) * 0.25
        chain = jnp.sum(
            distf[..., None] * wj[:, :, None, :] * adj, axis=(1, 2)
        )
        return between / (asize * bsize) - (asize + bsize) * chain
    u = (r < asize).astype(jnp.float32)
    coeff = (u[:, :, None, :] * (1.0 - u[:, None, :, :])) / (asize * bsize) \
        - (asize + bsize) * wj[:, :, None, :] * adj
    return jnp.sum(distf[..., None] * coeff, axis=(1, 2))   # [B, K]


def _perm_scores(
    distf: jnp.ndarray,   # [B, m, m] f32
    keys: jax.Array,      # [B] per-window typed PRNG keys
    asize: int,
    bsize: int,
    chunk: int,
    bitgen: str = "mix",
    form: str = "broadcast",
) -> jnp.ndarray:
    """CSS of ``chunk`` random label permutations per window: [B, K] f32.

    Rank-based, fusion-friendly formulation.  The permutation is encoded
    as RANKS r_j (position of individual j in the stable argsort of the
    per-permutation draws — computed by pairwise compares with
    index tie-break, NOT a sort), from which the reference CSS
    (reference statistics/css/css.c:608-647) collapses to ONE fused broadcast-multiply-reduce
    against D:

      score = sum_{j,l} D[j,l] * [ u_j (1-u_l)/(a b)
                                   - (a+b) w(r_j) 1[r_l = r_j + 1] ]

    with u_j = 1[r_j < a] (j lands in group A) and w(r) the per-rank
    adjacent-chain weight (reference statistics/css/css.c:627-641 order-dependent chains).  The
    earlier one-hot/matmul version materialized TWO [B, K, m, m] f32
    intermediates (Pi, Pi@D) in HBM per chunk — at m=21 that traffic,
    not FLOPs, bounded perms/s; here the broadcast terms are pure
    elementwise ops that XLA fuses into the reduction (4.5x on CPU; no
    materialized intermediate).

    ``bitgen`` selects the permutation draw stream: "mix" (default)
    ranks counter-expanded uint32 bits (:func:`_mix_bits` — another
    ~2x: threefry bit generation alone was 63% of the kernel), while
    "threefry" reproduces the round-1 f32-uniform stream.  Both are
    pure functions of (seed, chrom, slot, chunk), preserving every
    batching/sharding-invariance property; the ESTIMATOR is
    stream-independent (the reference's wall-clock-seeded rand_r,
    reference statistics/css/threadcss.c:220-223, promises nothing at all here).

    Layout: the chunk axis is kept LAST ([B, m, m, K]) so the large
    power-of-two axis is the contiguous one rather than m ~ 21
    (``_perm_scores_mlast`` is kept for the layout A/B in bench-mc).
    """
    m = distf.shape[-1]
    r = _ranks(keys, chunk, m, bitgen)
    return _scores_from_ranks(distf, r, asize, bsize, form)


def _perm_scores_mlast(
    distf: jnp.ndarray,
    keys: jax.Array,
    asize: int,
    bsize: int,
    chunk: int,
    bitgen: str = "mix",
) -> jnp.ndarray:
    """Chunk-axis-second layout variant ([B, K, m, m] broadcasts) —
    identical permutations and estimator; kept ONLY for the measured
    layout A/B on hardware (tools/bench_mc.py)."""
    m = distf.shape[-1]
    if bitgen == "mix":
        x = _mix_bits(keys, chunk, m)                  # [B, K, m] u32
    else:
        x = jax.vmap(
            lambda k: jax.random.uniform(k, (chunk, m), dtype=jnp.float32)
        )(keys)
    xi = x[..., :, None]
    xl = x[..., None, :]
    tie = jnp.arange(m)[:, None] > jnp.arange(m)[None, :]
    cmp = (xi > xl) | ((xi == xl) & tie)
    r = jnp.sum(cmp.astype(jnp.int32), axis=-1)
    u = (r < asize).astype(jnp.float32)
    wa, wb = _chain_weights(asize, bsize)
    wj = wa * (r < asize - 1) + wb * ((r >= asize) & (r < m - 1))
    adj = (r[..., None, :] == r[..., :, None] + 1).astype(jnp.float32)
    coeff = (u[..., :, None] * (1.0 - u[..., None, :])) / (asize * bsize) \
        - (asize + bsize) * wj[..., :, None] * adj
    return jnp.sum(distf[:, None] * coeff, axis=(-1, -2))


def _fold_chunk(keys: jax.Array, k) -> jax.Array:
    """Per-window keys for chunk ``k``."""
    return jax.vmap(jax.random.fold_in, in_axes=(0, None))(keys, k)


def _shared_coeff(
    key: jax.Array,
    k,
    m: int,
    asize: int,
    bsize: int,
    chunk: int,
    bitgen: str = "mix",
) -> jnp.ndarray:
    """Rank-coefficient matrix M [m*m, chunk] of one SHARED permutation
    chunk: column K holds vec(C_sigma) with
    C_sigma[j, l] = u_j (1-u_l)/(a b) - (a+b) w(r_j) 1[r_l = r_j + 1],
    the coefficients the reference CSS applies to D under permutation
    sigma (reference statistics/css/css.c:608-647).  The chunk's
    permutations are keyed by ``fold_in(key, k)`` ALONE — one genome-wide
    label permutation per draw (Westfall & Young's standard setup: the
    group labels being permuted are the same individuals genome-wide),
    shared by every window.  That collapses the whole chunk evaluation
    to ONE matmul ``D_flat [B, m^2] @ M`` (the per-window broadcast
    evaluator is the A/B in baseline/exp_mc_variants.py)."""
    kc = jax.random.fold_in(key, k)
    r = _ranks(kc[None], chunk, m, bitgen)[0]       # [m, K]
    wa, wb = _chain_weights(asize, bsize)
    wj = wa * (r < asize - 1) + wb * ((r >= asize) & (r < m - 1))
    adj = (r[None, :, :] == r[:, None, :] + 1).astype(jnp.float32)
    u = (r < asize).astype(jnp.float32)
    coeff = (u[:, None, :] * (1.0 - u[None, :, :])) / (asize * bsize) \
        - (asize + bsize) * wj[:, None, :] * adj    # [m, m, K]
    return coeff.reshape(m * m, chunk)


def _shared_perm_scores(
    distf: jnp.ndarray,   # [B, m, m] f32
    key: jax.Array,       # run-level typed key (NOT per-window)
    k,
    asize: int,
    bsize: int,
    chunk: int,
    bitgen: str = "mix",
) -> jnp.ndarray:
    """CSS of chunk ``k``'s shared permutations for every window:
    [B, K] f32 via one matmul (see :func:`_shared_coeff`).  HIGHEST
    keeps the products in full f32: a TF32 pass (the GPU default for
    f32 matmuls) carries ~1e-3 relative error, enough to flip hits whose
    permuted score lies near the observed one and bias the p-values."""
    B, m = distf.shape[0], distf.shape[-1]
    M = _shared_coeff(key, k, m, asize, bsize, chunk, bitgen)
    return jnp.matmul(
        distf.reshape(B, m * m), M, precision=jax.lax.Precision.HIGHEST
    )


@functools.partial(
    jax.jit,
    static_argnames=("asize", "bsize", "chunk", "runs", "threshold",
                     "max_chunks", "backend", "bitgen", "form", "stream"),
)
def mc_significance(
    dist: jnp.ndarray,      # [B, m, m]
    scores: jnp.ndarray,    # [B] observed CSS
    keys: jax.Array,        # [B] per-window PRNG keys (stream="window")
                            # or ONE run-level key (stream="shared")
    asize: int,
    bsize: int,
    chunk: int,
    runs: int,
    threshold: int,
    max_chunks: int | None = None,
    state: tuple | None = None,
    backend: str = "xla",
    bitgen: str = "mix",
    form: str = "broadcast",
    stream: str = "window",
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Adaptive permutation MC for one window batch, on device.

    Returns (pvals [B] f64, nscores [B] i32, hits [B] i32,
    finished [B] bool) with the reference estimator: stop a window at
    its ``threshold``-th hit (n = that permutation's 1-based index) or
    at ``runs``; p = (hits+1)/(n+1) (reference statistics/css/css.c:727-752).  ``finished`` is
    False only for windows cut off by ``max_chunks``.

    The permutation stream is chunk-indexed per window, so the loop is
    RESUMABLE: ``max_chunks`` caps this call's loop and ``state`` =
    (k0, hits0, nsc0, done0) continues a previous capped call with
    bit-identical results — the building block of the two-stage
    compaction in :func:`significance` that stops a batch's finished
    windows from riding along with its slowest one.

"""
    B = dist.shape[0]
    distf = dist.astype(jnp.float32)
    scoresf = scores.astype(jnp.float32)
    n_chunks = (runs + chunk - 1) // chunk
    stop = n_chunks if max_chunks is None else min(n_chunks, max_chunks)

    def cond(carry):
        k, hits, nsc, done = carry
        return (k < stop) & ~jnp.all(done)

    def body(carry):
        k, hits, nsc, done = carry
        if stream == "shared":
            new_scores = _shared_perm_scores(
                distf, keys, k, asize, bsize, chunk, bitgen=bitgen
            )
        else:
            new_scores = _perm_scores(
                distf, _fold_chunk(keys, k), asize, bsize, chunk,
                bitgen=bitgen, form=form,
            )
        offset = k * chunk
        counted = (offset + jnp.arange(chunk)) < runs       # [K]
        hit = (new_scores >= scoresf[:, None]) & counted[None, :]
        cum = jnp.cumsum(hit.astype(jnp.int32), axis=-1)    # [B, K]
        chunk_hits = cum[:, -1]
        n_counted = jnp.sum(counted.astype(jnp.int32))

        need = threshold - hits                              # [B]
        reached = (chunk_hits >= need) & ~done
        pos = jnp.argmax(cum >= need[:, None], axis=-1).astype(jnp.int32)

        hits = jnp.where(
            done, hits, jnp.where(reached, threshold, hits + chunk_hits)
        ).astype(jnp.int32)
        nsc = jnp.where(
            done,
            nsc,
            jnp.where(reached, offset + pos + 1, offset + n_counted),
        ).astype(jnp.int32)
        return k + jnp.int32(1), hits, nsc, done | reached

    if state is None:
        zero = jnp.zeros(B, dtype=jnp.int32)
        state = (jnp.int32(0), zero, zero, jnp.zeros(B, dtype=bool))
    _, hits, nsc, done = jax.lax.while_loop(cond, body, state)
    pvals = (hits + 1.0) / (nsc.astype(jnp.float64) + 1.0)
    # a window is finished when it reached the hit threshold or the cap;
    # under max_chunks the loop may stop earlier (resume via `state`)
    finished = done | (nsc >= runs)
    return pvals, nsc, hits, finished


@functools.partial(
    jax.jit, static_argnames=("asize", "bsize", "chunk", "bitgen")
)
def permutation_chunk(
    dist: jnp.ndarray,      # [B, m, m] distances of active windows
    scores: jnp.ndarray,    # [B] observed CSS per window
    need: jnp.ndarray,      # [B] hits still needed to reach the threshold
    limit: jnp.ndarray,     # scalar: #permutations of this chunk that count
    keys: jax.Array,        # [B] per-window PRNG keys
    asize: int,
    bsize: int,
    chunk: int,
    bitgen: str = "mix",
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One fixed-shape chunk of the null (building block of the sharded
    divergence step, parallel/sharded.py).

    Returns (chunk_hits [B], reached [B] bool, pos [B]) where ``pos`` is
    the 0-based in-chunk index of the permutation that delivered the
    ``need``-th hit (valid only where ``reached``)."""
    new_scores = _perm_scores(
        dist.astype(jnp.float32), keys, asize, bsize, chunk, bitgen=bitgen
    )
    counted = jnp.arange(chunk)[None, :] < limit
    hit = (new_scores >= scores[:, None].astype(jnp.float32)) & counted
    cum = jnp.cumsum(hit.astype(jnp.int32), axis=-1)
    reached = cum[:, -1] >= need
    pos = jnp.argmax(cum >= need[:, None], axis=-1)
    return cum[:, -1], reached, pos


@functools.partial(
    jax.jit,
    static_argnames=("Bp", "asize", "bsize", "chunk", "runs", "threshold",
                     "max_chunks", "bitgen", "form", "stream"),
)
def _mc_stage1_all(
    dist: jnp.ndarray,     # [Bt, m, m], Bt a multiple of Bp
    scores: jnp.ndarray,   # [Bt] observed CSS (-inf rows finish instantly)
    chroms: jnp.ndarray,   # [Bt]
    slots: jnp.ndarray,    # [Bt]
    key: jax.Array,
    Bp: int,
    asize: int,
    bsize: int,
    chunk: int,
    runs: int,
    threshold: int,
    max_chunks: int | None,
    bitgen: str,
    form: str,
    stream: str = "window",
) -> jnp.ndarray:
    """The ENTIRE stage-1 sweep as one device program: ``lax.map`` over
    uniform batch slices of the genome-wide arrays, per-window keys
    derived in-program, instead of a per-batch host loop (slice +
    key-derivation + launch per batch) that pays a dispatch per batch.
    Returns
    [4, Bt] rows (pvals, nscores, hits, finished) — ONE fetch."""
    nb = dist.shape[0] // Bp

    def one(start):
        d = jax.lax.dynamic_slice_in_dim(dist, start, Bp)
        s = jax.lax.dynamic_slice_in_dim(scores, start, Bp)
        c = jax.lax.dynamic_slice_in_dim(chroms, start, Bp)
        sl = jax.lax.dynamic_slice_in_dim(slots, start, Bp)
        ks = key if stream == "shared" else window_keys(key, c, sl)
        pv, n, h, fin = mc_significance(
            d, s, ks, asize, bsize, chunk, runs,
            threshold, max_chunks=max_chunks, bitgen=bitgen, form=form,
            stream=stream,
        )
        return jnp.stack(
            [
                pv,
                n.astype(jnp.float64),
                h.astype(jnp.float64),
                fin.astype(jnp.float64),
            ]
        )

    starts = jnp.arange(nb, dtype=jnp.int32) * Bp
    out = jax.lax.map(one, starts)                 # [nb, 4, Bp]
    return jnp.moveaxis(out, 1, 0).reshape(4, nb * Bp)


@functools.partial(
    jax.jit,
    static_argnames=("Bp", "asize", "bsize", "chunk", "runs", "threshold",
                     "k0", "bitgen", "form", "stream"),
)
def _mc_stage2_all(
    dist: jnp.ndarray,     # [Bt, m, m] the stage-1 device array
    scores: jnp.ndarray,   # [Bt]
    chroms: jnp.ndarray,   # [Bt]
    slots: jnp.ndarray,    # [Bt]
    idx: jnp.ndarray,      # [Bg] unfinished-window rows, padded, % Bp == 0
    state_hn: jnp.ndarray,  # [2, Bg] carried (hits, nscores) int32
    key: jax.Array,
    Bp: int,
    asize: int,
    bsize: int,
    chunk: int,
    runs: int,
    threshold: int,
    k0: int,
    bitgen: str,
    form: str,
    stream: str = "window",
) -> jnp.ndarray:
    """Stage 2 (the cap-bound windows' compacted resume) as one device
    program: gather the unfinished rows from the stage-1 arrays
    in-program and resume their chunk-indexed streams from ``k0`` —
    the host-side gathers + state uploads this replaces each cost a
    dispatch round trip.  Returns [4, Bg] like :func:`_mc_stage1_all`."""
    nb = idx.shape[0] // Bp

    def one(start):
        sl = jax.lax.dynamic_slice_in_dim(idx, start, Bp)
        d = jnp.take(dist, sl, axis=0)
        s = jnp.take(scores, sl)
        c = jnp.take(chroms, sl)
        so = jnp.take(slots, sl)
        hn = jax.lax.dynamic_slice_in_dim(state_hn, start, Bp, axis=1)
        state = (jnp.int32(k0), hn[0], hn[1], jnp.zeros(Bp, dtype=bool))
        ks = key if stream == "shared" else window_keys(key, c, so)
        pv, n, h, fin = mc_significance(
            d, s, ks, asize, bsize, chunk, runs,
            threshold, state=state, bitgen=bitgen, form=form,
            stream=stream,
        )
        return jnp.stack(
            [
                pv,
                n.astype(jnp.float64),
                h.astype(jnp.float64),
                fin.astype(jnp.float64),
            ]
        )

    starts = jnp.arange(nb, dtype=jnp.int32) * Bp
    out = jax.lax.map(one, starts)
    return jnp.moveaxis(out, 1, 0).reshape(4, nb * Bp)


@jax.jit
def _assemble_rows(ds, mask):
    return jnp.where(mask[:, None, None], jnp.concatenate(ds), 0.0)


def assemble_rows(dists: list, valid: np.ndarray) -> jnp.ndarray:
    """One-program assembly of the MC input: concatenate per-bucket
    distance arrays and zero the invalid/padding rows (their observed
    score is set to -inf by the caller so they finish at the first
    chunk; zeroing keeps NaN distance entries of discarded windows out
    of the hit comparisons).  Replaces per-bucket gathers + eager concat
    (one dispatch per op)."""
    return _assemble_rows(list(dists), jnp.asarray(valid))


@dataclasses.dataclass
class McResult:
    pvals: np.ndarray      # [B]
    nscores: np.ndarray    # [B] permutations consumed
    hits: np.ndarray       # [B]


def _batch_iter(B: int, window_batch: int, n_shards: int):
    """Yield (batch_index, sel, padded_sel) — padded to a power of two
    that also divides evenly over the mesh."""
    for bi, start in enumerate(range(0, B, window_batch)):
        sel = np.arange(start, min(start + window_batch, B))
        Bp = 8
        while Bp < len(sel):
            Bp *= 2
        while Bp % n_shards:
            Bp += n_shards - Bp % n_shards
        pad = Bp - len(sel)
        sel_p = np.concatenate([sel, np.full(pad, sel[0], dtype=np.int64)])
        yield bi, sel, sel_p


def _window_streams(key, B, chroms, slots, sharding):
    """[B] per-window typed keys on the requested placement."""
    if slots is None:
        slots = np.arange(B, dtype=np.int64)
    if chroms is None:
        chroms = np.zeros(B, dtype=np.int64)
    chroms_d = jnp.asarray(np.asarray(chroms, dtype=np.int64))
    slots_d = jnp.asarray(np.asarray(slots, dtype=np.int64))
    keys = window_keys(key, chroms_d, slots_d)
    if sharding is not None:
        keys = jax.device_put(keys, sharding)
    return keys


def _put(x, sharding):
    x = jnp.asarray(x)
    return jax.device_put(x, sharding) if sharding is not None else x


@functools.partial(
    jax.jit, static_argnames=("asize", "bsize", "chunk", "n_chunks",
                              "bitgen", "stream")
)
def _null_power_sums(
    dist: jnp.ndarray,     # [B, m, m]
    keys: jax.Array,       # [B] (stream="window") or one key ("shared")
    asize: int,
    bsize: int,
    chunk: int,
    n_chunks: int,
    k0: jnp.ndarray | int = 0,
    bitgen: str = "mix",
    stream: str = "window",
) -> jnp.ndarray:
    """Power sums of the permutation null, per chunk: [n_chunks, 3, B]
    with rows (sum s, sum s^2, sum s^3) in f64 — raw material for
    moment fits and for chunk-convergence diagnostics.

    ``k0`` offsets the chunk indices so successive calls EXTEND the
    per-window stream (chunks k0..k0+n_chunks-1) instead of replaying
    chunk 0 — the adaptive-doubling caller depends on this."""
    distf = dist.astype(jnp.float32)

    def one(k):
        if stream == "shared":
            s = _shared_perm_scores(
                distf, keys, k, asize, bsize, chunk, bitgen=bitgen
            )
        else:
            s = _perm_scores(
                distf, _fold_chunk(keys, k), asize, bsize, chunk,
                bitgen=bitgen,
            )
        s64 = s.astype(jnp.float64)
        return jnp.stack(
            [
                jnp.sum(s64, axis=-1),
                jnp.sum(s64 * s64, axis=-1),
                jnp.sum(s64 * s64 * s64, axis=-1),
            ]
        )

    return jax.lax.map(one, k0 + jnp.arange(n_chunks))


@functools.partial(
    jax.jit,
    static_argnames=("Bp", "asize", "bsize", "chunk", "n_chunks", "bitgen",
                     "stream"),
)
def _power_stage_all(
    dist: jnp.ndarray,     # [Bt, m, m], Bt a multiple of Bp
    chroms: jnp.ndarray,   # [Bt]
    slots: jnp.ndarray,    # [Bt]
    key: jax.Array,
    k0: jnp.ndarray,
    Bp: int,
    asize: int,
    bsize: int,
    chunk: int,
    n_chunks: int,
    bitgen: str,
    stream: str = "window",
) -> jnp.ndarray:
    """Every window's null power sums as ONE device program (``lax.map``
    over uniform batch slices, keys derived in-program — the dispatch
    rationale of :func:`_mc_stage1_all`).  Returns [n_chunks, 3, Bt]."""
    nb = dist.shape[0] // Bp

    def one(start):
        d = jax.lax.dynamic_slice_in_dim(dist, start, Bp)
        c = jax.lax.dynamic_slice_in_dim(chroms, start, Bp)
        sl = jax.lax.dynamic_slice_in_dim(slots, start, Bp)
        ks = key if stream == "shared" else window_keys(key, c, sl)
        return _null_power_sums(
            d, ks, asize, bsize, chunk, n_chunks,
            k0, bitgen=bitgen, stream=stream,
        )                                          # [K, 3, Bp]

    starts = jnp.arange(nb, dtype=jnp.int32) * Bp
    out = jax.lax.map(one, starts)                 # [nb, K, 3, Bp]
    return jnp.moveaxis(out, 0, 2).reshape(n_chunks, 3, nb * Bp)


def _pearson3_tail(scores, s1, s2, s3, n):
    """Upper-tail p under a Pearson-III fit to power sums (host, scipy)."""
    from scipy import stats as sstats

    mean = s1 / n
    var = np.maximum(s2 / n - mean**2, 1e-30)
    mu3 = s3 / n - 3 * mean * var - mean**3
    sd = np.sqrt(var)
    skew = mu3 / np.maximum(sd**3, 1e-30)
    z = (scores - mean) / sd

    small = np.abs(skew) < 1e-3
    p = np.empty(len(scores))
    p[small] = sstats.norm.sf(z[small])
    big = ~small
    if big.any():
        a = 4.0 / (skew[big] ** 2)
        pos = skew[big] > 0
        # X = (Z * sign) * sqrt(a) + a  ~ Gamma(a, 1) under Pearson III
        zz = np.where(pos, z[big], -z[big])
        x = zz * np.sqrt(a) + a
        tail_hi = sstats.gamma.sf(np.maximum(x, 0.0), a)
        tail_lo = sstats.gamma.cdf(np.maximum(x, 0.0), a)
        p[big] = np.where(pos, tail_hi, tail_lo)
        # beyond the distribution's support bound, the tail is 0/1
        p[big] = np.where(x <= 0.0, np.where(pos, 1.0, 0.0), p[big])
    return np.clip(p, 1e-300, 1.0)


def approx_significance(
    dist: np.ndarray,
    scores: np.ndarray,
    asize: int,
    bsize: int,
    key: jax.Array,
    chunk: int = 1024,
    window_batch: int = 8192,
    chroms: np.ndarray | None = None,
    slots: np.ndarray | None = None,
    sharding=None,
    n_chunks: int = 2,
    stable_log10: float = 0.5,
    max_rounds: int = 3,
    bitgen: str = "mix",
    stream: str = "window",
) -> McResult:
    """Pearson-III (moment-fitted) permutation p-values.

    The permuted CSS is a bilinear permutation statistic of the fixed
    distance matrix (between-block + adjacent-chain sums over sigma), the
    class of statistics the MRPP literature shows is well-approximated by
    a Pearson type III (shifted-gamma) null fitted to its first three
    moments (Mielke & Berry, Permutation Methods).  Chunks of
    permutations estimate the moments; the tail is evaluated
    analytically — ~200x less device work than the adaptive MC at 200k
    runs, at the cost of model error in the extreme tail.  Use the exact
    MC (``significance``) when reference-exact estimators are required.

    Moment-convergence control: the fit is
    computed from the first half of the sample and from the full sample;
    windows whose |log10 p| moved more than ``stable_log10`` get their
    sample doubled, up to ``max_rounds`` doublings.  The returned
    ``nscores`` records the permutations actually spent per window.
    """
    B = len(scores)
    if B == 0:
        z = np.zeros(0)
        return McResult(
            pvals=z, nscores=z.astype(np.int64), hits=z.astype(np.int64)
        )

    n_shards = 1
    if sharding is not None:
        n_shards = getattr(sharding, "num_devices", None) or len(
            sharding.device_set
        )
    if slots is None:
        slots = np.arange(B, dtype=np.int64)
    if chroms is None:
        chroms = np.zeros(B, dtype=np.int64)

    pvals = np.zeros(B)
    nsc = np.zeros(B, dtype=np.int64)

    def _power_dispatch(idx_p, n_new, k0):
        """Enqueue per-chunk power sums for padded global indices (no
        host sync — a genome-scale call has ~100 window batches and a
        sync per batch would serialize them)."""
        ks = key if stream == "shared" else _window_streams(
            key, len(idx_p), chroms[idx_p], slots[idx_p], sharding
        )
        return _null_power_sums(
            _put(dist[idx_p], sharding),
            ks,
            asize,
            bsize,
            chunk,
            n_new,
            jnp.int32(k0),
            bitgen=bitgen,
            stream=stream,
        )

    def _fetch_power(outs):
        """ONE host sync for a stage: [(sel, [K, 3, Bp])] -> [K, 3, sum]."""
        jax.block_until_ready([o for _, o in outs])
        return jax.device_get(jnp.concatenate([o for _, o in outs], axis=2))

    def _drift(sc, half, n_half, tot, n_tot):
        p_full = _pearson3_tail(sc, tot[0], tot[1], tot[2], n_tot)
        p_half = _pearson3_tail(sc, half[0], half[1], half[2], n_half)
        return p_full, np.abs(np.log10(p_full) - np.log10(p_half))

    # round 0: n_chunks chunks for every window — the whole sweep is ONE
    # device program over uniform batch slices (see _power_stage_all) and
    # one fetch; half-vs-full moment fits flag unstable windows
    Bp = 8
    while Bp < min(B, window_batch):
        Bp *= 2
    while Bp % n_shards:
        Bp += n_shards - Bp % n_shards
    Bt = -(-B // Bp) * Bp
    pad = Bt - B
    dist_j = dist if isinstance(dist, jax.Array) else jnp.asarray(dist)
    if pad:
        reps = -(-pad // B)
        pad_rows = jnp.tile(dist_j[:1], (pad, 1, 1)) if reps > 1 \
            else dist_j[:pad]
        dist_p = jnp.concatenate([dist_j, pad_rows])
        chroms_p = np.concatenate([chroms, np.zeros(pad, np.int64)])
        slots_p = np.concatenate([slots, np.zeros(pad, np.int64)])
    else:
        dist_p, chroms_p, slots_p = dist_j, chroms, slots
    out0 = _power_stage_all(
        _put(dist_p, sharding),
        _put(np.asarray(chroms_p, dtype=np.int64), sharding),
        _put(np.asarray(slots_p, dtype=np.int64), sharding),
        key,
        jnp.int32(0),
        Bp=Bp, asize=asize, bsize=bsize, chunk=chunk,
        n_chunks=n_chunks, bitgen=bitgen, stream=stream,
    )
    jax.block_until_ready(out0)
    per_chunk = jax.device_get(out0)[:, :, :B]            # [K0, 3, B]
    tot = per_chunk.sum(axis=0)
    half_k = max(n_chunks // 2, 1)
    half = per_chunk[:half_k].sum(axis=0)
    k_done = n_chunks
    p_full, drift = _drift(
        scores, half, half_k * chunk, tot, k_done * chunk
    )
    pvals[:] = p_full
    nsc[:] = k_done * chunk
    active = np.nonzero(drift > stable_log10)[0]          # global indices

    # escalation rounds: COMPACT to the unstable windows and EXTEND
    # their chunk-indexed streams (k0 = k_done), doubling the sample;
    # all active windows escalate in lockstep, so every window still
    # consumes the same chunk indices as the per-batch loop did
    # (p-values bit-identical under the dispatch restructure)
    for _round in range(max_rounds):
        if len(active) == 0:
            break
        outs = [
            (active[s2], _power_dispatch(active[s2_p], k_done, k_done))
            for _, s2, s2_p in _batch_iter(
                len(active), window_batch, n_shards
            )
        ]
        new = _fetch_power(outs)                          # [k_done, 3, .]
        off = 0
        for g2, o in outs:
            cols = slice(off, off + len(g2))
            half2 = tot[:, g2]                            # first half = old
            tot2 = half2 + new.sum(axis=0)[:, cols]
            p2, d2 = _drift(
                scores[g2], half2, k_done * chunk, tot2, 2 * k_done * chunk
            )
            pvals[g2] = p2
            nsc[g2] = 2 * k_done * chunk
            tot[:, g2] = tot2
            drift[g2] = d2
            off += o.shape[2]
        k_done *= 2
        active = active[drift[active] > stable_log10]

    return McResult(
        pvals=pvals, nscores=nsc, hits=np.zeros(B, dtype=np.int64)
    )


def significance(
    dist: np.ndarray,
    scores: np.ndarray,
    asize: int,
    bsize: int,
    threshold: int,
    runs: int,
    key: jax.Array,
    chunk: int = 256,
    window_batch: int = 8192,
    chroms: np.ndarray | None = None,
    slots: np.ndarray | None = None,
    sharding=None,
    backend: str = "xla",
    bitgen: str = "mix",
    form: str = "broadcast",
    stream: str = "window",
) -> McResult:
    """Adaptive permutation p-values for a set of windows.

    Drives :func:`mc_significance` over padded window batches — one
    device dispatch + one host sync per batch, with the adaptive
    chunk loop entirely on device.  ``sharding`` places the window axis
    over a mesh.

    ``stream`` selects the permutation-stream design:

    * ``"shared"`` — each chunk's permutations are keyed by
      ``fold_in(key, chunk)`` alone and SHARED by every window
      (Westfall-Young-style genome-wide label permutation); the chunk
      evaluation is one matmul (:func:`_shared_coeff`).  P-values
      are invariant under batching, sharding, ``--resume`` and host
      partitioning by construction (the stream does not reference the
      window at all), and common random numbers across windows reduce
      the variance of BETWEEN-window p comparisons.
    * ``"window"`` — per-window streams pinned to ``chroms``/``slots``
      (the round-3 design; required by ``backend="native"``).

    ``backend="native"`` routes to the threaded C++ host evaluator
    (below)."""
    B = len(scores)
    if stream == "shared" and backend == "native":
        raise ValueError(
            f"backend={backend!r} replays per-window streams; "
            "use stream='window'"
        )
    pvals = np.zeros(B, dtype=np.float64)
    nsc = np.zeros(B, dtype=np.int64)
    hits = np.zeros(B, dtype=np.int64)
    if B == 0:
        return McResult(pvals=pvals, nscores=nsc, hits=hits)

    n_shards = 1
    if sharding is not None:
        n_shards = getattr(sharding, "num_devices", None) or len(
            sharding.device_set
        )
    if slots is None:
        slots = np.arange(B, dtype=np.int64)
    if chroms is None:
        chroms = np.zeros(B, dtype=np.int64)

    if backend == "native":
        # Threaded C++ evaluator with per-window early exit
        # (native/mc_native.cpp): replays the same fold_in(seed, chrom,
        # slot, chunk) mix stream scalar-wise on the host — the CPU
        # counterpart of the reference's pthread pool
        # (reference statistics/css/threadcss.c:52-109).  Scores accumulate in f64 vs the XLA
        # backend's f32 reduction (docs/PARITY.md).
        if bitgen != "mix":
            raise ValueError(
                "perm_backend='native' replays the 'mix' stream only"
            )
        from divergence_tpu import native as _nat

        chroms_d = jnp.asarray(np.asarray(chroms, dtype=np.int64))
        slots_d = jnp.asarray(np.asarray(slots, dtype=np.int64))
        wk = jax.device_get(
            jax.random.key_data(window_keys(key, chroms_d, slots_d))
        )
        out = _nat.mc_native(
            np.asarray(dist), np.asarray(scores), np.asarray(wk),
            asize, chunk, runs, threshold,
        )
        if out is not None:
            pv, n, h = out
            return McResult(pvals=pv, nscores=n, hits=h)
        backend = "xla"  # toolchain unavailable: same stream, same result

    # Two-stage compaction: stage 1 gives every window ~stage1_perms
    # permutations (enough for any non-significant window to hit the
    # threshold); the surviving (significant) windows are compacted into
    # a small batch that resumes its chunk-indexed streams to the cap —
    # finished windows no longer ride along with their batch's slowest
    # (up to window_batch x redundant device work before).  Results are
    # bit-identical to the single-pass loop.
    #
    # Dispatch discipline: EVERY batch of a stage is enqueued before the
    # stage's single packed host sync — the per-window streams are
    # (chrom, slot)-keyed, so batches are independent.  A genome-scale
    # run has ~100 window batches; fetching each one individually costs
    # a full dispatch+sync round trip per batch.
    n_chunks_total = (runs + chunk - 1) // chunk
    stage1 = min(n_chunks_total, max(1, -(-4096 // chunk)))

    def _fetch_all(outs):
        """One host sync for a whole stage: [(sel, (pv,n,h,fin))] ->
        (pv, n, h, fin) numpy arrays concatenated over batches."""
        jax.block_until_ready([o[1][0] for o in outs])
        packed = jax.device_get(
            jnp.concatenate(
                [
                    jnp.stack(
                        [
                            pv,
                            n.astype(jnp.float64),
                            h.astype(jnp.float64),
                            fin.astype(jnp.float64),
                        ],
                        axis=1,
                    )
                    for _, (pv, n, h, fin) in outs
                ]
            )
        )
        return (
            packed[:, 0],
            packed[:, 1].astype(np.int64),
            packed[:, 2].astype(np.int64),
            packed[:, 3] != 0.0,
        )

    def _scatter(outs, fetched):
        off = 0
        for sel, (pv_d, *_rest) in outs:
            Bp = pv_d.shape[0]
            rows = slice(off, off + len(sel))
            pvals[sel] = fetched[0][rows]
            nsc[sel] = fetched[1][rows]
            hits[sel] = fetched[2][rows]
            off += Bp
        return fetched[3]

    compact = stage1 if stage1 < n_chunks_total else None
    # stage 1 = ONE device program over uniform batch slices
    # (_mc_stage1_all) and ONE fetch.  Pad rows carry score -inf
    # (every permutation hits, so they finish at the first chunk) and
    # repeat window 0's distances; their results are dropped.
    Bp = 8
    while Bp < min(B, window_batch):
        Bp *= 2
    while Bp % n_shards:
        Bp += n_shards - Bp % n_shards
    Bt = -(-B // Bp) * Bp
    pad = Bt - B
    dist_j = dist if isinstance(dist, jax.Array) else jnp.asarray(dist)
    if pad:
        reps = -(-pad // B)
        pad_rows = jnp.tile(dist_j[:1], (pad, 1, 1)) if reps > 1 \
            else dist_j[:pad]
        dist_p = jnp.concatenate([dist_j, pad_rows])
        scores_p = np.concatenate([scores, np.full(pad, -np.inf)])
        chroms_p = np.concatenate([chroms, np.zeros(pad, np.int64)])
        slots_p = np.concatenate([slots, np.zeros(pad, np.int64)])
    else:
        dist_p, scores_p, chroms_p, slots_p = dist_j, scores, chroms, slots
    dist_d = _put(dist_p, sharding)
    scores_d = _put(np.asarray(scores_p, dtype=np.float64), sharding)
    chroms_d = _put(np.asarray(chroms_p, dtype=np.int64), sharding)
    slots_d = _put(np.asarray(slots_p, dtype=np.int64), sharding)
    out = _mc_stage1_all(
        dist_d, scores_d, chroms_d, slots_d,
        key,
        Bp=Bp, asize=asize, bsize=bsize, chunk=chunk, runs=runs,
        threshold=threshold, max_chunks=compact, bitgen=bitgen,
        form=form, stream=stream,
    )
    jax.block_until_ready(out)
    fetched = jax.device_get(out)
    pvals[:] = fetched[0, :B]
    nsc[:] = fetched[1, :B].astype(np.int64)
    hits[:] = fetched[2, :B].astype(np.int64)
    g = np.nonzero(fetched[3, :B] == 0.0)[0]

    if len(g):
        # stage 2 as one program, gathering from the stage-1 arrays
        Bp2 = 8
        while Bp2 < min(len(g), window_batch):
            Bp2 *= 2
        while Bp2 % n_shards:
            Bp2 += n_shards - Bp2 % n_shards
        Bg = -(-len(g) // Bp2) * Bp2
        idx = np.full(Bg, g[0], dtype=np.int32)
        idx[: len(g)] = g
        hn = np.zeros((2, Bg), dtype=np.int32)
        hn[0, : len(g)] = hits[g]
        hn[1, : len(g)] = nsc[g]
        hn_sh = sharding
        if sharding is not None:
            from divergence_tpu.core.batching import _row_sharding

            hn_sh = _row_sharding(sharding)
        out2 = _mc_stage2_all(
            dist_d, scores_d, chroms_d, slots_d,
            _put(idx, sharding), _put(hn, hn_sh), key,
            Bp=Bp2, asize=asize, bsize=bsize, chunk=chunk,
            runs=runs, threshold=threshold, k0=stage1,
            bitgen=bitgen, form=form, stream=stream,
        )
        jax.block_until_ready(out2)
        f2 = jax.device_get(out2)
        pvals[g] = f2[0, : len(g)]
        nsc[g] = f2[1, : len(g)].astype(np.int64)
        hits[g] = f2[2, : len(g)].astype(np.int64)
    return McResult(pvals=pvals, nscores=nsc, hits=hits)
