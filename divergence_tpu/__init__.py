"""divergence_tpu — an accelerator-native framework for genome-wide analysis
of genomic divergence between two populations.

Re-designed from scratch for accelerators (JAX / XLA, runs on NVIDIA GPUs)
with the same capabilities as the reference toolkit
``tuvakt/Fast-Parallel-Tools-for-Genome-wide-Analysis-of-Genomic-Divergence``:

* **FET** — per-SNP two-tailed Fisher's Exact Test aggregated per sliding
  window as the p-th percentile of -log10(p) plus a bootstrap standard
  deviation (reference: statistics/fisher/cFisher.c).
* **CSS** — Cluster Separation Score per window: pairwise dissimilarity ->
  multi-dimensional scaling (CMDS / SMACOF) -> between-vs-within group
  distance score with a Monte-Carlo permutation p-value
  (reference: statistics/css/css.c).

Layers (bottom up):

* :mod:`divergence_tpu.kernels`  — batched JAX/XLA compute kernels
* :mod:`divergence_tpu.core`     — window planning, bucketing, batching
* :mod:`divergence_tpu.engine`   — per-chromosome engines (FET / CSS)
* :mod:`divergence_tpu.parallel` — device mesh, window-axis sharding,
  multi-host launch
* :mod:`divergence_tpu.io`       — GTrack / VCF readers & writers
* :mod:`divergence_tpu.stats`    — region filtering (Burke threshold, BH-FDR)
* :mod:`divergence_tpu.tools`    — CLI replacing the reference's 5 GUI tools
* :mod:`divergence_tpu.oracle`   — NumPy re-statement of the exact reference
  semantics used as the parity fixture generator
* ``native/``                    — C++ host runtime (threaded GTrack
  parser) loaded via ctypes, with a pure-Python fallback; the honest
  reference-C baseline harness lives in ``baseline/`` at the repo root
"""

import os as _os

import jax as _jax

# The reference computes everything in C doubles.  Score parity at ~1e-9
# requires float64 end-to-end for the numeric core; hot inner ops
# (dissimilarity counting, permutation scoring) explicitly down-cast where
# exactness is preserved (integer counts in f32-accumulated bf16 matmuls).
_jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache: CLI runs on small inputs are otherwise
# dominated by compile time (the kernels recompile per bucket shape).
# JAX reads JAX_COMPILATION_CACHE_DIR itself; without it the cache sits at
# a fixed, git-ignored directory of the checkout (the path is part of the
# cache key, so a moving location would never hit).
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache",
        ),
    )

__version__ = "0.1.0"

from divergence_tpu.config import (  # noqa: E402
    WindowConfig,
    FetConfig,
    CssConfig,
    MdsAlgorithm,
)

__all__ = [
    "WindowConfig",
    "FetConfig",
    "CssConfig",
    "MdsAlgorithm",
    "__version__",
]
