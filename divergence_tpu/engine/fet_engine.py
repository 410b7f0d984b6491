"""Per-chromosome FET engine.

Orchestrates: window plan (host) -> npos buckets -> device-side window
gather -> batched FET kernel -> dense score/stddev tracks.  Replaces the
reference's pthread pool + mutex task counter (reference statistics/fisher/threadfisher.c:47-100) with
static even batches; with a device mesh the window axis shards over the
devices (see divergence_tpu.parallel).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from divergence_tpu.config import FetConfig
from divergence_tpu.core.batching import _row_sharding, pad_batch, replicate
from divergence_tpu.core.windows import plan_windows
from divergence_tpu.engine.snp import SnpPair
from divergence_tpu.kernels import fet as kfet
from divergence_tpu.kernels.perm import chrom_hash as _chrom_hash
from divergence_tpu.utils.summary import RunSummary


@functools.partial(jax.jit, static_argnames=("P",))
def _gather_windows(avals, bvals, lo, npos, P):
    """Device-side window materialization: [B] descriptors -> [B, P, size]
    padded batches.  Rows past ``npos`` point at SNP 0 and are masked in
    the kernels."""
    offs = jnp.arange(P, dtype=lo.dtype)[None, :]
    idx = lo[:, None] + offs
    idx = jnp.where(offs < npos[:, None], idx, 0)
    return jnp.take(avals, idx, axis=0), jnp.take(bvals, idx, axis=0)


def _fet_dispatch(
    pair: SnpPair,
    regend: int,
    cfg: FetConfig,
    sharding,
    summary: RunSummary | None,
    key: jax.Array,
    slot_range: tuple[int, int] | None = None,
):
    """Enqueue one chromosome's FET sweep as ONE device program (no host
    sync): per-SNP logs (kfet.fet_snp_logs) + a ``lax.map`` over uniform
    window slices (kfet.fet_aggregate_all) — the per-npos-bucket host
    loop paid a fixed dispatch cost per bucket launch and descriptor
    upload.

    Returns (nslots, pending) with pending = [(slot, Bw, out_2xBt)]."""
    w = cfg.window
    plan = plan_windows(pair.positions, regend, w.wsize, w.wstep)
    nslots = plan.nslots
    if plan.num_windows == 0 or pair.npos == 0:
        return nslots, []

    # compact=True: FET only ever == -compares the codes (count_tables),
    # so the int16 form is result-identical at 1/4 the transfer;
    # joint: one upload serves both populations (and the CSS engine)
    vals_d = replicate(pair.device_values_joint(compact=True), sharding)
    maxs = kfet.support_size(pair.asize, pair.bsize)
    nmax = pair.asize + pair.bsize + 2
    # per-SNP exact tests ONCE per chromosome; windows overlap
    # wsize/wstep-fold and gather from this array (kfet.fet_snp_logs).
    # EXACT mode in the LUT regime carries the per-SNP value as an int32
    # rank into the sorted LUT, so the per-window sort and selection run
    # in native int32 instead of emulated f64 — BIT-IDENTICAL results
    # (kfet.fet_snp_ranks_joint).  FAST mode prefers the float path:
    # its f32 sort costs the same as int32 and the one-hot bootstrap
    # picks then need NO [B, S] lut-mapping gathers (each ~0.3s at
    # chromosome-1 scale, round-5 decomposition).
    use_ranks = cfg.precision != "fast" and kfet.lut_active(
        pair.asize, pair.bsize, vals_d.shape[0]
    )
    if use_ranks:
        lut_sorted, snp_ranks = kfet.fet_snp_ranks_joint(
            vals_d, pair.asize, maxs, nmax, fast=cfg.precision == "fast"
        )
    else:
        snp_logs = kfet.fet_snp_logs_joint(
            vals_d, pair.asize, maxs, nmax, fast=cfg.precision == "fast"
        )

    valid = plan.valid_mask() & (plan.npos > 0)
    if slot_range is not None:
        # multi-host slot-range partitioning: evaluate only owned slots
        # (windows straddling the cut belong to exactly one host; the
        # halo SNPs they read are included in this host's input span —
        # parallel/multihost.py:partition_chromosomes).  Slot-keyed RNG
        # makes the restricted run bit-identical to the full run.
        valid &= (plan.slot >= slot_range[0]) & (plan.slot < slot_range[1])
    ids = np.nonzero(valid)[0]
    if len(ids) == 0:
        return nslots, []
    P = 32
    while P < int(plan.npos[ids].max()):
        P *= 2
    Bp = pad_batch(min(len(ids), 4096))
    n_shards = 1
    if sharding is not None:
        n_shards = getattr(sharding, "num_devices", None) or len(
            sharding.device_set
        )
    while Bp % n_shards:
        Bp += n_shards - Bp % n_shards
    Bt = -(-len(ids) // Bp) * Bp
    rows = np.zeros((3, Bt), dtype=np.int64)
    rows[0, : len(ids)] = plan.lo[ids]
    rows[1, : len(ids)] = plan.npos[ids]   # pad rows keep npos 0 (masked)
    rows[2, : len(ids)] = plan.slot[ids]
    rows_d = jnp.asarray(rows)
    if sharding is not None:
        rows_d = jax.device_put(rows_d, _row_sharding(sharding))
    # two-stage gather span bound: plan-ordered windows in one map slice
    # touch a contiguous SNP range; gathering from a dynamic_slice of it
    # reads contiguous memory instead of [Bp, P] random addresses, with
    # identical values (A/B: baseline/exp_fet_agg.py)
    L = kfet.slice_span_bound(
        plan.lo[ids], len(ids), Bp, P, vals_d.shape[0]
    )

    if summary is not None:
        # accumulate across chromosomes (one summary spans a whole run)
        c = summary.counters
        c["windows_planned"] = c.get("windows_planned", 0) + plan.num_windows
        c["windows_evaluated"] = c.get("windows_evaluated", 0) + len(ids)
        c["buckets"] = c.get("buckets", 0) + Bt // Bp

    if use_ranks:
        out = kfet.fet_aggregate_all_ranks(
            lut_sorted,
            snp_ranks,
            rows_d,
            key,
            Bp=Bp,
            P=P,
            perc=float(cfg.percentile),
            nsamples=cfg.bootstrap_samples,
            fast=cfg.precision == "fast",
            L=L,
        )
    else:
        out = kfet.fet_aggregate_all(
            snp_logs,
            rows_d,
            key,
            Bp=Bp,
            P=P,
            perc=float(cfg.percentile),
            nsamples=cfg.bootstrap_samples,
            fast=cfg.precision == "fast",
            L=L,
        )
    return nslots, [(plan.slot[ids], len(ids), out)]


def _fetch_packed(all_pending):
    """ONE host sync for any number of chromosomes' pending sweeps.

    device_get of a pytree fetches leaf-by-leaf (one round trip each), so
    everything is packed into a single [2, total] device array first.
    Blocking on the in-flight kernels before dispatching the pack keeps
    the eager concat off remote backends' slow scheduling path."""
    jax.block_until_ready([out for _, _, out in all_pending])
    packed = jnp.concatenate([out for _, _, out in all_pending], axis=1)
    return jax.device_get(packed)


def _scatter(pending, fetched, off, scores, stddev):
    for slot, Bw, out in pending:
        Bt = out.shape[1]
        scores[slot] = fetched[0, off : off + Bw]
        stddev[slot] = fetched[1, off : off + Bw]
        off += Bt
    return off


def run_fet(
    pair: SnpPair,
    regend: int,
    cfg: FetConfig | None = None,
    sharding=None,
    summary: RunSummary | None = None,
    seqid: str = "_",
    slot_range: tuple[int, int] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """FET scan of one chromosome.

    Returns (scores, stddev), each of ``regend // wstep`` slots — slot
    ``w.start // wstep`` like the reference adapter
    (statistics/FisherExactScoreStat.py:51-58).  ``sharding`` optionally
    places the window batches over a device mesh (window-axis data
    parallelism).  ``seqid`` pins the bootstrap RNG stream to the
    chromosome identity — per-chromosome runs match the same chromosome
    inside :func:`run_fet_multi` bit-for-bit, under any host partition
    (the reference seeds per worker thread from the wall clock instead,
    reference statistics/fisher/threadfisher.c:156-160)."""
    cfg = cfg or FetConfig()
    key = jax.random.fold_in(
        jax.random.PRNGKey(cfg.seed), _chrom_hash(seqid)
    )
    nslots, pending = _fet_dispatch(
        pair, regend, cfg, sharding, summary, key, slot_range
    )
    scores = np.zeros(nslots, dtype=np.float64)
    stddev = np.zeros(nslots, dtype=np.float64)
    if pending:
        fetched = _fetch_packed(pending)
        _scatter(pending, fetched, 0, scores, stddev)
    return scores, stddev


def run_fet_multi(
    pairs: dict[str, tuple[SnpPair, int]],
    cfg: FetConfig | None = None,
    sharding=None,
    summary: RunSummary | None = None,
    slot_ranges: dict[str, tuple[int, int]] | None = None,
) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """Genome-wide FET: every chromosome's kernels are enqueued before the
    single packed host sync — per-chromosome fixed latencies overlap
    (the per-chromosome result is identical to :func:`run_fet`)."""
    cfg = cfg or FetConfig()
    summary = summary or RunSummary()
    per_chrom = []
    base = jax.random.PRNGKey(cfg.seed)
    with summary.stage("fet_dispatch"):
        for seqid, (pair, regend) in sorted(pairs.items()):
            # chromosome-pinned stream: independent bootstrap noise per
            # chromosome, identical to run_fet(seqid=...) and stable
            # across multi-host chromosome partitionings
            key = jax.random.fold_in(base, _chrom_hash(seqid))
            nslots, pending = _fet_dispatch(
                pair, regend, cfg, sharding, summary, key,
                (slot_ranges or {}).get(seqid),
            )
            per_chrom.append((seqid, nslots, pending))

    all_pending = [p for _, _, pending in per_chrom for p in pending]
    with summary.stage("fet_sync"):
        fetched = _fetch_packed(all_pending) if all_pending else None

    results = {}
    off = 0
    with summary.stage("fet_scatter"):
        for seqid, nslots, pending in per_chrom:
            scores = np.zeros(nslots, dtype=np.float64)
            stddev = np.zeros(nslots, dtype=np.float64)
            if pending:
                off = _scatter(pending, fetched, off, scores, stddev)
            results[seqid] = (scores, stddev)
    return results
