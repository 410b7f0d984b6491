"""The full divergence step, jitted over a device mesh (GSPMD).

One compiled SPMD program evaluates a padded window batch sharded over
the mesh's window axis: each device scores its windows (FET score +
bootstrap stddev, CSS score + distance matrix, one permutation-MC chunk
of the null) locally, and the chromosome-level summary statistics
(window counts, score sums/maxima consumed by the region callers) are
global reductions that XLA lowers to device collectives.

This is the SAME parallel mechanism the engines use in production
(window-axis data parallelism via input shardings — see
``engine/fet_engine.py`` ``sharding=`` and ``kernels/perm.py``
``significance(sharding=)``): sharded inputs + jit, no ``shard_map``.
This module is the single-dispatch composition of exactly the kernels the engines call,
used by ``__graft_entry__.dryrun_multichip`` and ``bench-scaling``.

RNG: per-window streams from :func:`divergence_tpu.kernels.perm.window_keys`
(a pure function of the window id), so results are bit-identical across
mesh sizes — the replacement for the reference's per-thread
wall-clock seeding (reference statistics/css/threadcss.c:220-223); the 1-vs-N equivalence test
(tests/test_parallel.py) is the analogue of the reference's
serial-vs-threaded diff (reference statistics/css/testcss.c:31-142).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from divergence_tpu.kernels import css as kcss
from divergence_tpu.kernels import fet as kfet
from divergence_tpu.kernels import perm as kperm
from divergence_tpu.parallel.mesh import replicated, window_sharding


def make_divergence_step(
    mesh: Mesh,
    asize: int,
    bsize: int,
    *,
    percentile: float = 0.95,
    nsamples: int = 100,
    mds: int = 0,
    smacof_iters: int = 300,
    smacof_inits: int = 4,
    smacof_eps: float = 1e-6,
    mc_chunk: int = 128,
    drosophila: bool = False,
):
    """Build the jitted sharded step.

    Returned callable signature::

        step(av, bv, npos, slot, key) -> dict

    with ``av``: [B, P, asize] genotype codes, ``bv``: [B, P, bsize],
    ``npos``: [B] true SNP counts, ``slot``: [B] window identities
    (``start // wstep`` — NOT batch positions: every stochastic stream
    is keyed off the slot so results are invariant under batching and
    sub-batch splits, per the RNG invariant in docs/PARITY.md), ``key``:
    PRNG key (replicated).  ``B`` must divide evenly by the mesh size.  Outputs: per-window arrays
    (sharded over the window axis) ``fet_scores``, ``fet_stddev``,
    ``css_scores``, ``css_valid``, ``mc_hits``, and replicated global
    summary scalars ``windows_evaluated``, ``score_sum`` (one fused
    all-reduce; order statistics are host-side by design).
    """
    maxs = kfet.support_size(asize, bsize)
    nmax = asize + bsize + 2
    wsh = window_sharding(mesh)
    rep = replicated(mesh)

    def _step(av, bv, npos, slot, key):
        B = av.shape[0]
        fet_s, fet_d = kfet.fet_window_batch(
            av,
            bv,
            npos,
            float(percentile),
            jax.random.fold_in(key, 0),
            nsamples=nsamples,
            maxs=maxs,
            nmax=nmax,
            slot=slot,
        )
        css_s, dist, valid = kcss.css_window_batch(
            av,
            bv,
            npos,
            jax.random.fold_in(key, 1),
            asize=asize,
            bsize=bsize,
            drosophila=drosophila,
            mds=mds,
            smacof_iters=smacof_iters,
            smacof_inits=smacof_inits,
            smacof_eps=smacof_eps,
            slot=slot,
        )

        # one fixed-shape chunk of the permutation null for every window
        # (the engines' adaptive MC, kperm.significance, drives many of
        # these) — per-window RNG streams, mesh-size invariant
        a_mc = 1 if drosophila else asize
        b_mc = 1 if drosophila else bsize
        keys = kperm.window_keys(
            jax.random.fold_in(key, 2),
            jnp.zeros((B,), dtype=jnp.int64),
            slot,
        )
        hits, _, _ = kperm.permutation_chunk(
            dist,
            css_s,
            jnp.ones((B,), dtype=jnp.int32),
            jnp.asarray(mc_chunk),
            keys,
            a_mc,
            b_mc,
            mc_chunk,
        )

        # chromosome-level summaries: the only genuinely collective step
        # (region callers consume global counts/sums; SURVEY.md §5).
        # Deliberately ONE all-reduce: the per-window stats are stacked
        # into a single [B, 2] array whose axis-0 sum lowers to a single
        # collective — XLA:CPU's rendezvous deadlocks intermittently
        # when a program carries several independent all-reduces (8
        # virtual devices on fewer cores), and sum/max reductions cannot
        # be combined by the all-reduce combiner.  Order statistics
        # (score max, medians) are host-side over the fetched sharded
        # outputs, as designed (SURVEY.md §5 distributed backend).
        stats = jnp.stack(
            [
                (npos > 0).astype(jnp.float64),
                jnp.where(valid, css_s, 0.0).astype(jnp.float64),
            ],
            axis=1,
        )
        totals = jnp.sum(stats, axis=0)
        return {
            "fet_scores": fet_s,
            "fet_stddev": fet_d,
            "css_scores": css_s,
            "css_valid": valid,
            "mc_hits": hits,
            "windows_evaluated": totals[0],
            "score_sum": totals[1],
        }

    out_shardings = {
        "fet_scores": wsh,
        "fet_stddev": wsh,
        "css_scores": wsh,
        "css_valid": wsh,
        "mc_hits": wsh,
        "windows_evaluated": rep,
        "score_sum": rep,
    }
    return jax.jit(
        _step,
        in_shardings=(wsh, wsh, wsh, wsh, rep),
        out_shardings=out_shardings,
    )
