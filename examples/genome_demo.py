"""Genome-scale end-to-end demo.

Generates a synthetic stickleback-shaped genome (5 chromosomes, ~1M SNPs,
11+10 individuals, ~2% divergent windows), writes GTrack files, then runs
the full CLI pipeline: run-fet -> run-css -> filter-fet ->
call-css-regions -> report.  Prints per-stage wall-clock.

Usage:  python examples/genome_demo.py [workdir]
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def generate_genome(workdir: Path, n_chrom=5, snps_per_chrom=200_000,
                    chrom_len=10_000_000, asize=11, bsize=10,
                    divergent_frac=0.02, seed=42):
    rng = np.random.default_rng(seed)
    sizes = {}
    fa = open(workdir / "popA.gtrack", "w")
    fb = open(workdir / "popB.gtrack", "w")
    for fh in (fa, fb):
        fh.write("###seqid\tstart\tvalue\tgenomeid\n")
    n_div_windows = 0
    for c in range(n_chrom):
        seqid = f"chr{c + 1}"
        sizes[seqid] = chrom_len
        positions = np.sort(
            rng.choice(np.arange(1, chrom_len, dtype=np.int64),
                       snps_per_chrom, replace=False)
        )
        # divergent 25kb blocks covering ~divergent_frac of the chromosome
        n_blocks = max(int(chrom_len * divergent_frac / 25_000), 1)
        block_starts = rng.choice(
            np.arange(0, chrom_len - 25_000, 25_000), n_blocks, replace=False
        )
        n_div_windows += n_blocks
        in_block = np.zeros(snps_per_chrom, dtype=bool)
        for bs in block_starts:
            in_block |= (positions >= bs) & (positions < bs + 25_000)

        p_shared = rng.uniform(0.15, 0.85, snps_per_chrom)
        pa = np.where(in_block, rng.uniform(0.85, 0.98, snps_per_chrom),
                      p_shared)
        pb = np.where(in_block, rng.uniform(0.02, 0.15, snps_per_chrom),
                      p_shared)

        for fh, size, p, names in (
            (fa, asize, pa, [f"A{i}" for i in range(asize)]),
            (fb, bsize, pb, [f"B{i}" for i in range(bsize)]),
        ):
            g = rng.random((snps_per_chrom, size))
            het = 2 * p * (1 - p)
            codes = np.where(
                g < (p * p)[:, None],
                3,
                np.where(g < (p * p + het)[:, None], 0, -3),
            )
            miss = rng.random((snps_per_chrom, size)) < 0.02
            codes = np.where(miss, -10000, codes)
            rows = []
            for k in range(snps_per_chrom):
                pos = positions[k]
                for i, nm in enumerate(names):
                    rows.append(f"{seqid}\t{pos}\t{codes[k, i]}\t{nm}\n")
            fh.write("".join(rows))
    fa.close()
    fb.close()
    with open(workdir / "chrom.sizes", "w") as fh:
        for k, v in sizes.items():
            fh.write(f"{k}\t{v}\n")
    return n_div_windows


def main():
    workdir = Path(sys.argv[1] if len(sys.argv) > 1 else "/tmp/genome_demo")
    workdir.mkdir(parents=True, exist_ok=True)
    stages = {}

    # --small: 2 chromosomes x 20k SNPs — CPU-friendly validation of the
    # identical pipeline (the full genome is the GPU-scale run)
    small = "--small" in sys.argv
    gen_kwargs = (
        dict(n_chrom=2, snps_per_chrom=20_000, chrom_len=1_000_000)
        if small
        else {}
    )

    if (workdir / "popA.gtrack").exists():
        print("reusing existing genome files")
        stages["generate"] = 0.0
    else:
        t0 = time.perf_counter()
        ndiv = generate_genome(workdir, **gen_kwargs)
        stages["generate"] = time.perf_counter() - t0
        print(f"generated genome with ~{ndiv} divergent 25kb blocks "
              f"({stages['generate']:.0f}s)")

    from divergence_tpu.tools.cli import main as cli

    def run(stage, args):
        t0 = time.perf_counter()
        cli(args)
        stages[stage] = time.perf_counter() - t0
        print(f"[{stage}] {stages[stage]:.1f}s")

    w = str(workdir)

    # --run-all: the single-process pipeline subcommand (round 5) — one
    # genome load + one genotype upload + one process's fixed costs
    # for the whole fet/css/regions/report chain; outputs byte-identical
    # to the staged path below (tests/test_cli.py)
    if "--run-all" in sys.argv:
        # --exact switches the whole pipeline to the reference-parity
        # precision (default: fast, the production mode)
        precision = "exact" if "--exact" in sys.argv else "fast"
        run("run-all", [
            "run-all", "--pop-a", f"{w}/popA.gtrack",
            "--pop-b", f"{w}/popB.gtrack",
            "--outdir", w, "--chrom-sizes", f"{w}/chrom.sizes",
            "--precision", precision,
        ])
        total = sum(stages.values())
        print(f"TOTAL {total:.1f}s  "
              f"({', '.join(f'{k}={v:.1f}s' for k, v in stages.items())})")
        return

    run("run-fet", [
        "run-fet", "--pop-a", f"{w}/popA.gtrack", "--pop-b", f"{w}/popB.gtrack",
        "--out", f"{w}/fet.track", "--chrom-sizes", f"{w}/chrom.sizes",
        "--precision", "fast", "--summary", f"{w}/fet_summary.json",
    ])
    p_mode = "approx" if "--approx" in sys.argv else "mc"
    run("run-css", [
        "run-css", "--pop-a", f"{w}/popA.gtrack", "--pop-b", f"{w}/popB.gtrack",
        "--out", f"{w}/css.track", "--chrom-sizes", f"{w}/chrom.sizes",
        "--precision", "fast", "--p-mode", p_mode,
        "--summary", f"{w}/css_summary.json",
    ])
    run("filter-fet", [
        "filter-fet", "--scores", f"{w}/fet.track",
        "--out", f"{w}/fet_regions.gtrack", "--chrom-sizes", f"{w}/chrom.sizes",
    ])
    run("call-css-regions", [
        "call-css-regions", "--scores", f"{w}/css.track",
        "--out", f"{w}/css_regions.gtrack", "--chrom-sizes", f"{w}/chrom.sizes",
    ])
    run("report", [
        "report", "--fet-track", f"{w}/fet.track", "--css-track", f"{w}/css.track",
        "--fet-regions", f"{w}/fet_regions.gtrack",
        "--css-regions", f"{w}/css_regions.gtrack",
        "--run-summary", f"{w}/fet_summary.json",
        "--out", f"{w}/report.html",
    ])
    total = sum(stages.values())
    print(f"TOTAL {total:.1f}s  ({', '.join(f'{k}={v:.1f}s' for k, v in stages.items())})")


if __name__ == "__main__":
    main()
