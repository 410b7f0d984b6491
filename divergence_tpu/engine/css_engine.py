"""Per-chromosome CSS engine.

Orchestrates: window plan -> one fused device program per chromosome
(scores + per-window distance matrices; kcss.css_prefix_all /
css_gather_all) -> genome-wide chunked permutation MC.  Replaces the
reference pthread pool (reference statistics/css/threadcss.c:52-109);
the Monte-Carlo runs over *all* valid windows of the run at once.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from divergence_tpu.config import CssConfig
from divergence_tpu.core.batching import Bucket, _row_sharding, replicate
from divergence_tpu.core.windows import plan_windows
from divergence_tpu.engine.snp import SnpPair
from divergence_tpu.kernels import css as kcss
from divergence_tpu.kernels import perm as kperm
from divergence_tpu.utils.summary import RunSummary


# Memory guardrail for the prefix-sum dissimilarity path: the prefix is
# [N+1, m, m] on device (plus a same-size cumsum operand).  Above this
# element budget (~1 GB f32 at the default) dense/huge chromosomes fall
# back to the per-bucket gather kernel, whose footprint is bounded by
# the bucket element budget instead.
PREFIX_MAX_ELEMS = 1 << 28


def _pack_rows(plan, ids, cap: int, sharding):
    """Pack the valid windows' (lo, npos, slot) descriptors into a
    [3, Bt] device array whose window axis is a multiple of the uniform
    batch Bp = min(pow2(len(ids)), cap), rounded up to the shard count.
    Pad rows keep npos 0 (the kernels mark them invalid).  Returns
    (rows_d, Bp)."""
    Bp = 8
    while Bp < min(len(ids), cap):
        Bp *= 2
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
    rows[1, : len(ids)] = plan.npos[ids]
    rows[2, : len(ids)] = plan.slot[ids]
    rows_d = jnp.asarray(rows)
    if sharding is not None:
        rows_d = jax.device_put(rows_d, _row_sharding(sharding))
    return rows_d, Bp


def _css_phase1_dispatch(
    pair: SnpPair,
    regend: int,
    cfg: CssConfig,
    sharding,
    key: jax.Array,
    slot_range: tuple[int, int] | None = None,
):
    """Enqueue the score/distance kernels for one chromosome (no sync).

    Returns (nslots, num_windows, pending) with pending =
    [(bucket, s_dev, dist_dev, valid_dev)]."""
    w = cfg.window
    plan = plan_windows(pair.positions, regend, w.wsize, w.wstep)
    nslots = plan.nslots
    if plan.num_windows == 0 or pair.npos == 0:
        return nslots, plan.num_windows, []

    asize, bsize = pair.asize, pair.bsize
    # stickleback dissimilarity is pure ==-counting (kcss.dissimilarity*),
    # so the int16 form is result-identical at 1/4 the transfer;
    # drosophila frequency tracks keep the float upload (compare_freq
    # does real arithmetic on the values, reference statistics/css/css.c:245-264);
    # joint: ONE upload serves both populations and both engines
    vals_d = replicate(
        pair.device_values_joint(compact=not cfg.drosophila), sharding
    )

    # stickleback path: chromosome-wide mismatch prefix sums ONCE —
    # every window's dissimilarity is one [m, m] difference (windows
    # overlap wsize/wstep-fold; computed inside kcss.css_prefix_all).
    # Guarded by the PREFIX_MAX_ELEMS budget (see above).
    m_all = asize + bsize
    npad_dev = int(vals_d.shape[0])
    use_prefix = (
        not cfg.drosophila
        and (npad_dev + 1) * m_all * m_all <= PREFIX_MAX_ELEMS
    )

    valid = plan.valid_mask()
    if slot_range is not None:
        # multi-host slot-range partitioning (see fet_engine._fet_dispatch)
        valid &= (plan.slot >= slot_range[0]) & (plan.slot < slot_range[1])
    valid_npos = np.where(valid, plan.npos, 0)
    if use_prefix:
        # the prefix kernel never materializes [B, P, m] window gathers —
        # its per-window cost is independent of padded_npos — and the
        # whole chromosome runs as ONE device program (lax.map over
        # uniform descriptor slices, kcss.css_prefix_all): each launched
        # op costs a fixed dispatch round trip on remote backends
        ids = np.nonzero(valid_npos > 0)[0]
        if len(ids) == 0:
            return nslots, plan.num_windows, []
        rows_d, Bp = _pack_rows(plan, ids, 4096, sharding)
        s, dist, valid = kcss.css_prefix_all(
            vals_d,
            rows_d,
            key,
            Bp=Bp,
            asize=asize,
            bsize=bsize,
            mds=int(cfg.mds),
            smacof_iters=cfg.smacof.max_iters,
            smacof_inits=cfg.smacof.n_init,
            smacof_eps=cfg.smacof.epsilon,
            fast=cfg.precision == "fast",
        )
        bucket = Bucket(
            padded_npos=0,
            window_ids=ids,
            lo=plan.lo[ids],
            npos=plan.npos[ids],
            slot=plan.slot[ids],
        )
        return nslots, plan.num_windows, [(bucket, s, dist, valid)]

    # drosophila / over-the-prefix-budget path: the same one-program
    # sweep, window genotypes gathered in-program at a uniform padded P
    # (the per-npos bucket loop paid a dispatch round trip per launch);
    # Bp keeps the [Bp, P] gather rows under the element budget so dense
    # chromosomes stream instead of materializing multi-GB gathers
    ids = np.nonzero(valid_npos > 0)[0]
    if len(ids) == 0:
        return nslots, plan.num_windows, []
    P = 32
    while P < int(plan.npos[ids].max()):
        P *= 2
    rows_d, Bp = _pack_rows(
        plan, ids, min(4096, max(8, (1 << 21) // P)), sharding
    )
    avals_d, bvals_d = (
        replicate(v, sharding)
        for v in pair.device_values(compact=not cfg.drosophila)
    )
    s, dist, valid = kcss.css_gather_all(
        avals_d,
        bvals_d,
        rows_d,
        key,
        Bp=Bp,
        P=P,
        asize=asize,
        bsize=bsize,
        drosophila=cfg.drosophila,
        mds=int(cfg.mds),
        smacof_iters=cfg.smacof.max_iters,
        smacof_inits=cfg.smacof.n_init,
        smacof_eps=cfg.smacof.epsilon,
        fast=cfg.precision == "fast",
    )
    bucket = Bucket(
        padded_npos=P,
        window_ids=ids,
        lo=plan.lo[ids],
        npos=plan.npos[ids],
        slot=plan.slot[ids],
    )
    return nslots, plan.num_windows, [(bucket, s, dist, valid)]


def _css_phase1_fetch(all_pending):
    """ONE host sync for any number of chromosomes' phase-1 buckets.

    Fetches only (score | valid) per window — one [sumB, 2] device array
    (a pytree device_get fetches leaf-by-leaf).  The distance matrices
    STAY ON DEVICE for phase 2: round-tripping them through the host
    costs ~3.5 KB/window in each direction.  Blocks on the in-flight
    kernels first."""
    jax.block_until_ready([s for _, s, _, _ in all_pending])
    packed = jnp.concatenate(
        [
            jnp.stack([s, v.astype(s.dtype)], axis=1)
            for _, s, _, v in all_pending
        ]
    )
    return jax.device_get(packed)


def _css_collect(pending, fetched, off: int):
    """Unpack one chromosome's phase-1 rows at BUCKET-ROW granularity:
    (row_slot, row_score, row_valid, dists_dev, n_discarded, next off).

    Rows cover every padded bucket position in dispatch order — the
    per-bucket distance arrays feed the Monte-Carlo whole (one
    ``kperm.assemble_rows`` program) instead of per-bucket valid-row
    gathers (each eager gather/concat op is one more dispatch).
    Invalid and padding rows carry score -inf: every permutation of
    their zeroed distance matrix hits, so they exit the adaptive MC at
    the first chunk and their (discarded) results cost ~threshold
    permutations each."""
    row_slots, row_scores, row_valid, dists = [], [], [], []
    n_discarded = 0
    for bucket, s_d, d_dev, _ in pending:
        Bp = s_d.shape[0]
        Bw = len(bucket.window_ids)
        rows = fetched[off : off + Bw]
        off += Bp
        s = rows[:, 0]
        valid = rows[:, 1] != 0.0
        n_discarded += int((~valid & (bucket.npos > 0)).sum())
        rs = np.zeros(Bp, dtype=np.int64)
        rs[:Bw] = bucket.slot
        sc = np.full(Bp, -np.inf)
        sc[:Bw][valid] = s[valid]
        va = np.zeros(Bp, dtype=bool)
        va[:Bw] = valid
        row_slots.append(rs)
        row_scores.append(sc)
        row_valid.append(va)
        dists.append(d_dev)
    if not dists:
        return (
            np.zeros(0, np.int64),
            np.zeros(0),
            np.zeros(0, dtype=bool),
            [],
            n_discarded,
            off,
        )
    return (
        np.concatenate(row_slots),
        np.concatenate(row_scores),
        np.concatenate(row_valid),
        dists,
        n_discarded,
        off,
    )


def run_css(
    pair: SnpPair,
    regend: int,
    cfg: CssConfig | None = None,
    sharding=None,
    summary: RunSummary | None = None,
    seqid: str = "_",
    slot_range: tuple[int, int] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """CSS scan of one chromosome.

    Returns (scores, pvals) of ``regend // wstep`` slots (reference
    statistics/CategoryClusterSeparationStat.py:70-80).  Discarded or
    empty windows keep score 0 / p 0.  ``seqid`` pins the RNG streams to
    the chromosome identity, so a per-chromosome run is bit-identical to
    the same chromosome inside a genome-wide :func:`run_css_multi`."""
    cfg = cfg or CssConfig()
    results = run_css_multi(
        {seqid: (pair, regend)}, cfg, sharding=sharding, summary=summary,
        slot_ranges={seqid: slot_range} if slot_range is not None else None,
    )
    return results[seqid]


def run_css_multi(
    pairs: dict[str, tuple[SnpPair, int]],
    cfg: CssConfig | None = None,
    sharding=None,
    summary: RunSummary | None = None,
    slot_ranges: dict[str, tuple[int, int]] | None = None,
) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """Genome-wide CSS: phase 1 of every chromosome is enqueued before the
    single packed host sync, and the adaptive permutation Monte-Carlo runs
    over ALL chromosomes' valid windows at once — window batches fill
    better and the per-batch fixed latencies amortize genome-wide."""
    cfg = cfg or CssConfig()
    key = jax.random.PRNGKey(cfg.seed)
    if not pairs:
        return {}
    summary = summary or RunSummary()

    per_chrom = []
    planned_total = 0
    with summary.stage("css_dispatch"):
        for seqid, (pair, regend) in sorted(pairs.items()):
            # chromosome-pinned RNG stream: phase-1 results do not depend
            # on which other chromosomes share the run (or host partition)
            ckey = jax.random.fold_in(key, kperm.chrom_hash(seqid))
            nslots, planned, pending = _css_phase1_dispatch(
                pair, regend, cfg, sharding, ckey,
                (slot_ranges or {}).get(seqid),
            )
            planned_total += planned
            per_chrom.append(
                (seqid, nslots, pending, pair.asize, pair.bsize)
            )

    all_pending = [p for _, _, pending, _, _ in per_chrom for p in pending]
    with summary.stage("css_phase1_sync"):
        fetched = _css_phase1_fetch(all_pending) if all_pending else None

    chrom_data = []
    off = 0
    n_discarded = 0
    empty = (
        np.zeros(0, np.int64),
        np.zeros(0),
        np.zeros(0, dtype=bool),
        [],
    )
    with summary.stage("css_collect"):
        for seqid, nslots, pending, asz, bsz in per_chrom:
            if pending:
                rslot, rscore, rvalid, dists, disc, off = _css_collect(
                    pending, fetched, off
                )
            else:
                rslot, rscore, rvalid, dists = empty
                disc = 0
            n_discarded += disc
            chrom_data.append(
                (seqid, nslots, rslot, rscore, rvalid, dists, asz, bsz)
            )

    # phase 2: genome-wide adaptive permutation MC at bucket-row
    # granularity (invalid/pad rows finish at the first chunk and are
    # dropped; see _css_collect).  Chromosomes are grouped by panel size
    # (asize, bsize): the reference processes each chromosome region
    # independently and allows per-region population sizes (reference
    # statistics/CategoryClusterSeparationStat.py:32-80) — same-panel
    # chromosomes still batch into one genome-wide MC.
    n_scored = int(sum(c[4].sum() for c in chrom_data))
    results: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    mc_perms = 0
    groups: dict[tuple[int, int], list] = {}
    for c in chrom_data:
        groups.setdefault((c[6], c[7]), []).append(c)
    for (asz, bsz), group in groups.items():
        if not int(sum(c[4].sum() for c in group)):
            for seqid, nslots, *_ in group:
                results[seqid] = (
                    np.zeros(nslots, dtype=np.float64),
                    np.zeros(nslots, dtype=np.float64),
                )
            continue
        with summary.stage("css_mc"):
            valid_all = np.concatenate([c[4] for c in group])
            # one-program device assembly of every bucket's distance
            # matrices (never fetched to host; invalid rows zeroed)
            dists_all = kperm.assemble_rows(
                [d for c in group for d in c[5]], valid_all
            )
            scores_all = np.concatenate([c[3] for c in group])
            # per-window RNG identity: (chromosome, slot) — MC p-values
            # are invariant to batch composition, sharding, host partition
            chroms_all = np.concatenate(
                [
                    np.full(
                        len(c[3]), kperm.chrom_hash(c[0]), dtype=np.int64
                    )
                    for c in group
                ]
            )
            slots_all = np.concatenate(
                [np.asarray(c[2], dtype=np.int64) for c in group]
            )
            a_mc = 1 if cfg.drosophila else asz
            b_mc = 1 if cfg.drosophila else bsz
            if cfg.p_mode == "approx":
                mc = kperm.approx_significance(
                    dists_all,
                    scores_all,
                    a_mc,
                    b_mc,
                    jax.random.fold_in(key, 2),
                    chunk=max(cfg.mc_chunk, 512),
                    window_batch=cfg.mc_window_batch,
                    chroms=chroms_all,
                    slots=slots_all,
                    sharding=sharding,
                    bitgen=cfg.rng,
                    stream=cfg.mc_stream,
                )
            else:
                mc = kperm.significance(
                    dists_all,
                    scores_all,
                    a_mc,
                    b_mc,
                    cfg.mc_threshold,
                    cfg.mc_runs,
                    jax.random.fold_in(key, 2),
                    chunk=cfg.mc_chunk,
                    window_batch=cfg.mc_window_batch,
                    chroms=chroms_all,
                    slots=slots_all,
                    sharding=sharding,
                    backend=cfg.perm_backend,
                    bitgen=cfg.rng,
                    form=cfg.perm_form,
                    stream=cfg.mc_stream,
                )
        mc_off = 0
        for seqid, nslots, rslot, rscore, rvalid, *_ in group:
            scores = np.zeros(nslots, dtype=np.float64)
            pvals = np.zeros(nslots, dtype=np.float64)
            nrows = len(rscore)
            sl = rslot[rvalid]
            scores[sl] = rscore[rvalid]
            pvals[sl] = mc.pvals[mc_off : mc_off + nrows][rvalid]
            mc_perms += int(mc.nscores[mc_off : mc_off + nrows][rvalid].sum())
            mc_off += nrows
            results[seqid] = (scores, pvals)

    if summary is not None:
        c = summary.counters
        c["windows_planned"] = c.get("windows_planned", 0) + planned_total
        c["windows_scored"] = c.get("windows_scored", 0) + n_scored
        c["windows_discarded"] = c.get("windows_discarded", 0) + n_discarded
        c["mc_permutations"] = c.get("mc_permutations", 0) + mc_perms
    return results
