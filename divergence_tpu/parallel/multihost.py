"""Multi-host launch and work partitioning.

The reference fans out per-chromosome jobs through the HyperBrowser
platform (reference tools/FisherExactTestSNPTool.py:167-171, one region job
per chromosome); there is no in-repo distributed backend (SURVEY.md §2.5).
The design: each *host* of a cluster takes a disjoint set of
chromosomes (or window shards of very large chromosomes), runs the local
mesh engine over its local devices, and writes its score-track shard; the
tiny global statistics needed by the region callers (median / percentile /
BH-FDR sort over one double per 500 bp) are computed host-side after a
gather — never as an on-device sort (SURVEY.md §5).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Bring up JAX multi-host.

    Thin wrapper over ``jax.distributed.initialize`` so single-host runs
    (the common case, and all tests) never touch it."""
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


# "to the last slot" sentinel for open-ended ranges (the true nslots may
# be unknown at partition time); any real slot index is far below it
TO_END = 1 << 62


@dataclasses.dataclass(frozen=True)
class WorkRange:
    """A contiguous slot range of one chromosome assigned to one host.

    ``slot_lo``/``slot_hi`` are window *output slots* (start // wstep),
    half-open.  A range covering ``[0, nslots)`` is the whole chromosome.
    Slot-granular splitting is the device-mesh generalization of the
    reference's window-range tasking
    (reference statistics/css/threadcss.c:114-124): because every
    stochastic stream is keyed on (chrom, slot) — never on batch or host
    position — a slot split is bit-identical to the unsplit run by
    construction (docs/PARITY.md "Stream identity")."""

    seqid: str
    slot_lo: int
    slot_hi: int

    def covers(self, nslots: int) -> bool:
        return self.slot_lo == 0 and self.slot_hi >= nslots


@dataclasses.dataclass(frozen=True)
class HostAssignment:
    """Which work this host runs."""

    process_id: int
    num_processes: int
    seqids: tuple[str, ...]
    # slot-granular assignment (round 5); seqids stays the set of
    # chromosomes this host touches, for callers that partition at
    # chromosome granularity only
    ranges: tuple[WorkRange, ...] = ()


def partition_chromosomes(
    seqid_weights: dict[str, int],
    num_processes: int,
    process_id: int,
    seqid_nslots: dict[str, int] | None = None,
) -> HostAssignment:
    """Greedy load-balanced work partitioning, slot-granular when needed.

    ``seqid_weights``: per-chromosome work estimate (window count or SNP
    count).  Without ``seqid_nslots`` the assignment is chromosome-
    granular (rounds 2-4 behavior).  With it, any chromosome whose
    weight exceeds the per-host average is first cut into near-equal
    contiguous SLOT ranges (a genome that is one large chromosome would
    otherwise get no multi-host speedup); pieces
    are then assigned largest-first to the least-loaded host.
    Deterministic across hosts — every process computes the same
    assignment with no communication.  Each host's input span is
    ``[slot_lo*wstep, (slot_hi-1)*wstep + wsize]`` — the halo beyond the
    owned slots is ``wsize - wstep`` positions at each cut
    (SURVEY.md §5 long-context analogue)."""
    if not 0 <= process_id < num_processes:
        raise ValueError("process_id out of range")
    total = sum(max(int(w), 1) for w in seqid_weights.values())
    avg = max(total / max(num_processes, 1), 1.0)

    # cut chromosomes into pieces: (weight, seqid, slot_lo, slot_hi)
    pieces: list[tuple[float, str, int, int]] = []
    for seqid in sorted(seqid_weights):
        w = max(int(seqid_weights[seqid]), 1)
        nslots = (seqid_nslots or {}).get(seqid, 0)
        k = 1
        if seqid_nslots is not None and nslots > 1 and w > avg:
            k = min(num_processes, int(np.ceil(w / avg)), nslots)
        if k == 1:
            # whole chromosome: open-ended so covers() holds whatever
            # the true nslots is (callers may not know it at
            # partition time)
            pieces.append((float(w), seqid, 0, TO_END))
        else:
            bounds = np.linspace(0, nslots, k + 1).round().astype(int)
            for i in range(k):
                hi = int(bounds[i + 1]) if i < k - 1 else TO_END
                pieces.append((w / k, seqid, int(bounds[i]), hi))

    loads = np.zeros(num_processes, dtype=np.float64)
    assign: list[list[tuple[str, int, int]]] = [
        [] for _ in range(num_processes)
    ]
    # Invariant: each host holds AT MOST ONE contiguous range per
    # chromosome.  Same-chromosome pieces have equal weight, so the
    # (-w, seqid, lo) sort assigns them consecutively in slot order; a
    # host may take a piece only if it holds none of that chromosome or
    # its held range ends exactly where this piece starts (the chain
    # then merges below).  Unconstrained argmin could hand one host two
    # NON-adjacent pieces — a shape `_host_filter`'s one-range-per-
    # chromosome contract cannot represent, silently dropping the first
    # range's windows (round-5 review finding, reproduced with 3 hosts
    # over weights {20, 2, 7}).  Eligibility is never empty: pieces
    # arrive in slot order, so the host holding the immediately
    # preceding piece always qualifies.
    last_hi: dict[tuple[int, str], int] = {}
    for w, seqid, lo, hi in sorted(
        pieces, key=lambda p: (-p[0], p[1], p[2])
    ):
        eligible = [
            h for h in range(num_processes)
            if (h, seqid) not in last_hi or last_hi[(h, seqid)] == lo
        ]
        h = min(eligible, key=lambda i: (loads[i], i))
        loads[h] += w
        assign[h].append((seqid, lo, hi))
        last_hi[(h, seqid)] = hi

    # merge contiguous same-chromosome ranges that landed on this host
    mine = sorted(assign[process_id])
    merged: list[WorkRange] = []
    for seqid, lo, hi in mine:
        if merged and merged[-1].seqid == seqid and merged[-1].slot_hi == lo:
            merged[-1] = WorkRange(seqid, merged[-1].slot_lo, hi)
        else:
            merged.append(WorkRange(seqid, lo, hi))
    return HostAssignment(
        process_id=process_id,
        num_processes=num_processes,
        seqids=tuple(dict.fromkeys(r.seqid for r in merged)),
        ranges=tuple(merged),
    )


def merge_score_shards(
    shards: list[dict[str, tuple[np.ndarray, np.ndarray]]],
) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """Merge per-host result dicts (disjoint chromosome sets) into one.

    The host-side analogue of an ``all_gather`` of score tracks; with
    per-host file outputs this is simply reading every shard file."""
    merged: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    for shard in shards:
        overlap = merged.keys() & shard.keys()
        if overlap:
            raise ValueError(f"chromosome shards overlap: {sorted(overlap)}")
        merged.update(shard)
    return merged
