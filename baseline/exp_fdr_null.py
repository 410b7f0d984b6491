"""Null-genome FDR calibration of the CSS pipeline.

Round 4 made ``mc_stream="shared"`` (one genome-wide label permutation
per draw, shared by every window — common random numbers) the default.
Per-window p-values are exact either way (tests/test_shared_stream.py),
but shared draws POSITIVELY CORRELATE p-values across windows, and the
downstream BH-FDR region caller (stats/regions.py:call_css_regions,
reference tools/SignificantCSSRegions.py:102-123) had no calibration
evidence under that correlation.  BH is provably valid under PRDS
(positive regression dependence), which CRN induces, so the EXPECTED
result is control at or below the nominal level for both streams — this
experiment measures it instead of asserting it.

Protocol: simulate genomes with NO divergence (each SNP's minor-allele
frequency drawn once, both populations' genotypes iid from it — the
permutation-exchangeability null), run the full engine + region caller
at ``--mode fdr 0.05`` over many seeds, and record, per stream design:

* share of seeds with >= 1 discovery (under the global null, FDR ==
  FWER, so this IS the empirical FDR; nominal bound 0.05),
* total false windows / regions across seeds.

Run: python baseline/exp_fdr_null.py [--seeds N] [--npos N] [--mc-runs N]
CI: tests/test_fdr_calibration.py runs a reduced version and bounds the
null discovery rate for BOTH streams.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def make_null_chromosome(
    npos: int, region: int, asize: int, bsize: int, seed: int
):
    """Two populations with IDENTICAL per-SNP allele frequencies (the
    exchangeability null of the permutation test): any region call on
    this genome is a false discovery."""
    rng = np.random.default_rng(seed)
    positions = np.sort(
        rng.choice(np.arange(1, region, dtype=np.int64), npos, replace=False)
    )
    p_major = rng.uniform(0.2, 0.9, size=(npos, 1))

    def draw(size):
        g = rng.random((npos, size))
        het = p_major * (1 - p_major) * 2
        mat = np.where(
            g < p_major**2, 3.0, np.where(g < p_major**2 + het, 0.0, -3.0)
        )
        miss = rng.random((npos, size)) < 0.03
        return np.where(miss, -10000.0, mat)

    return positions, draw(asize), draw(bsize)


def run_campaign(
    n_seeds: int = 24,
    npos: int = 2_000,
    region: int = 100_000,
    mc_runs: int = 5_000,
    fdr: float = 0.05,
    streams: tuple[str, ...] = ("shared", "window"),
    asize: int = 11,
    bsize: int = 10,
) -> dict:
    """Returns per-stream calibration stats; importable by the CI test."""
    from divergence_tpu.config import CssConfig, CssRegionConfig
    from divergence_tpu.engine import run_css
    from divergence_tpu.engine.snp import SnpPair
    from divergence_tpu.stats.regions import call_css_regions

    out: dict = {
        "n_seeds": n_seeds, "npos": npos, "region": region,
        "mc_runs": mc_runs, "fdr": fdr,
    }
    wstep = 500
    for stream in streams:
        seeds_with_discovery = 0
        false_windows = 0
        false_regions = 0
        n_windows_total = 0
        for seed in range(n_seeds):
            pos, av, bv = make_null_chromosome(
                npos, region, asize, bsize, 1000 + seed
            )
            pair = SnpPair(positions=pos, avals=av, bvals=bv)
            cfg = CssConfig(
                precision="fast", mc_runs=mc_runs, seed=seed,
                mc_stream=stream,
            )
            scores, pvals = run_css(pair, region, cfg, seqid="chrN")
            nz = scores != 0
            n_windows_total += int(nz.sum())
            starts = np.nonzero(nz)[0] * wstep
            call = call_css_regions(
                ["chrN"] * len(starts), starts, scores[nz], pvals[nz],
                CssRegionConfig(mode="fdr", fdr=fdr),
            )
            if call.n_windows_passing:
                seeds_with_discovery += 1
                false_windows += call.n_windows_passing
                false_regions += len(call.segments)
        out[stream] = {
            # global null => FDR == FWER == P(any discovery)
            "empirical_fdr": seeds_with_discovery / n_seeds,
            "seeds_with_discovery": seeds_with_discovery,
            "false_windows_total": false_windows,
            "false_regions_total": false_regions,
            "windows_tested_total": n_windows_total,
        }
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=24)
    ap.add_argument("--npos", type=int, default=2_000)
    ap.add_argument("--region", type=int, default=100_000)
    ap.add_argument("--mc-runs", type=int, default=5_000)
    ap.add_argument("--fdr", type=float, default=0.05)
    args = ap.parse_args()
    res = run_campaign(
        n_seeds=args.seeds, npos=args.npos, region=args.region,
        mc_runs=args.mc_runs, fdr=args.fdr,
    )
    print(json.dumps(res, indent=2))


if __name__ == "__main__":
    main()
