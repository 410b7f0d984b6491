"""Pin the Pearson-III approx estimator's extreme tail.

Compares approx_significance's analytic tail against a fixed-n
1,000,000-permutation Monte-Carlo (the shared-stream matmul evaluator,
so this runs in seconds on CPU or GPU) on a ladder of two-cluster windows
whose true p spans ~[1e-5, 1e-2].  Prints per-window
log10(p_approx) - log10(p_mc) and the max over the extreme-tail band.

The MC itself carries sampling noise sigma_log10 ~ log10(e) *
sqrt((1-p)/(n*p)); at p=1e-5, n=1e6 that is ~0.14, so disagreement
bounds below ~0.3 would be unmeasurable at this n.

Run: python baseline/exp_approx_tail.py [n_perms]
"""

from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

import divergence_tpu  # noqa: F401
import jax

from divergence_tpu.kernels import perm as kperm
from divergence_tpu.oracle import reference as orc


def make_windows(gaps, asize=11, bsize=10, seed=3):
    """Two 2-D Gaussian clusters at graded separation; the returned
    distance matrices play the role of phase-1 MDS embeddings."""
    rng = np.random.default_rng(seed)
    m = asize + bsize
    dists, scores = [], []
    for g in gaps:
        xa = rng.normal(size=(asize, 2))
        xb = rng.normal(size=(bsize, 2)) + np.array([2.0 * g, 0.0])
        x = np.vstack([xa, xb])
        d = orc.calc_dist(x)
        dists.append(d)
        scores.append(
            orc.css_score(d, np.arange(asize), np.arange(asize, m))
        )
    return np.asarray(dists), np.asarray(scores)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    asize, bsize = 11, 10
    gaps = np.linspace(0.35, 1.15, 24)
    dists, scores = make_windows(gaps, asize, bsize)
    key = jax.random.PRNGKey(0)

    mc = kperm.significance(
        dists, scores, asize, bsize, 10**9, n, key,
        chunk=8192, stream="shared",
    )
    ap = kperm.approx_significance(
        dists, scores, asize, bsize, key, chunk=2048, stream="shared",
    )

    dlog = np.log10(ap.pvals) - np.log10(mc.pvals)
    sig = np.log10(np.e) * np.sqrt((1 - mc.pvals) / (n * mc.pvals))
    band = (mc.pvals >= 1e-5) & (mc.pvals <= 1e-3)
    for i, g in enumerate(gaps):
        print(
            f"gap={g:.3f} score={scores[i]:+.4f} "
            f"p_mc={mc.pvals[i]:.3e} (n={int(mc.nscores[i])}, "
            f"hits={int(mc.hits[i])}) p_approx={ap.pvals[i]:.3e} "
            f"dlog10={dlog[i]:+.3f} (mc sigma_log10={sig[i]:.3f})"
            f"{'  <- tail band' if band[i] else ''}"
        )
    if band.any():
        print(
            f"\ntail band p_mc in [1e-5,1e-3]: {int(band.sum())} windows, "
            f"max |dlog10| = {np.abs(dlog[band]).max():.3f}, "
            f"max mc sigma_log10 = {sig[band].max():.3f}"
        )


if __name__ == "__main__":
    main()
