"""Worker process for the 2-process jax.distributed smoke test.

Each process: joins the DCN coordination service, takes its chromosome
partition (deterministic, no communication — multihost.py), runs the FET
engine on its shard, and writes the shard to disk.  The parent test
merges shards and checks equality with a single-process run — the DCN
analogue of the reference's per-chromosome platform fan-out
(reference tools/FisherExactTestSNPTool.py:167-171).

Usage: python tests/_multihost_worker.py <pid> <nprocs> <coord> <outdir>
"""

import pathlib
import sys

import numpy as np

import jax

# The multi-host test is a group of CPU processes, whatever accelerator
# the machine has: pin the platform before any device query.
jax.config.update("jax_platforms", "cpu")


def make_genome(seed: int = 99):
    """Deterministic 3-chromosome toy genome (identical on every host)."""
    rng = np.random.default_rng(seed)
    pairs = {}
    for c, npos in (("chr1", 300), ("chr2", 200), ("chr3", 120)):
        region = npos * 60
        positions = np.sort(
            rng.choice(np.arange(1, region), npos, replace=False)
        )
        av = rng.choice([3.0, -3.0, 0.0], size=(npos, 5))
        bv = rng.choice([3.0, -3.0, 0.0], size=(npos, 4))
        pairs[c] = (positions, av, bv, region)
    return pairs


def main() -> None:
    pid, nprocs = int(sys.argv[1]), int(sys.argv[2])
    coord, outdir = sys.argv[3], pathlib.Path(sys.argv[4])

    from divergence_tpu.config import FetConfig, WindowConfig
    from divergence_tpu.engine.fet_engine import run_fet_multi
    from divergence_tpu.engine.snp import SnpPair
    from divergence_tpu.parallel.multihost import (
        initialize_distributed,
        partition_chromosomes,
    )

    initialize_distributed(
        coordinator_address=coord, num_processes=nprocs, process_id=pid
    )
    assert jax.process_count() == nprocs, jax.process_count()
    assert jax.process_index() == pid, jax.process_index()

    genome = make_genome()
    weights = {c: len(p) for c, (p, _, _, _) in genome.items()}
    assign = partition_chromosomes(weights, nprocs, pid)

    cfg = FetConfig(window=WindowConfig(2500, 500), bootstrap_samples=4)
    local = {
        c: (SnpPair(positions=p, avals=a, bvals=b), r)
        for c, (p, a, b, r) in genome.items()
        if c in assign.seqids
    }
    results = run_fet_multi(local, cfg)

    out = {}
    for c, (s, d) in results.items():
        out[f"{c}_scores"] = s
        out[f"{c}_stddev"] = d
    np.savez(outdir / f"shard{pid}.npz", **out)
    print(f"worker {pid} done: {sorted(results)}")


if __name__ == "__main__":
    main()
