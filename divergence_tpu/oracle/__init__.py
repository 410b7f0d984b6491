"""CPU oracle: an independent NumPy statement of the exact reference
semantics, used as the parity fixture generator for the device kernels.

A faster C++ twin lives in ``native/`` (same math, std::thread pool) and is
the measured CPU baseline for the benchmarks.
"""

from divergence_tpu.oracle.reference import (
    fet_count,
    fet_point_prob,
    fet_two_tailed,
    percentile_interp,
    window_fet,
    compute_fet,
    compare_all,
    compare_freq,
    fill_averages,
    cmds,
    calc_dist,
    css_score,
    smacof,
    smacof_runs,
    significance,
    window_css,
    compute_css,
)

__all__ = [
    "fet_count",
    "fet_point_prob",
    "fet_two_tailed",
    "percentile_interp",
    "window_fet",
    "compute_fet",
    "compare_all",
    "compare_freq",
    "fill_averages",
    "cmds",
    "calc_dist",
    "css_score",
    "smacof",
    "smacof_runs",
    "significance",
    "window_css",
    "compute_css",
]
