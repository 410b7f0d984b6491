"""Typed configuration for the divergence engines.

The reference spreads its configuration over three tiers (GUI defaults,
an ``analysisDef`` kwarg string, and compile-time constants — see
reference tools/FisherExactTestSNPTool.py:118-126,
tools/ClusterSeparationScore.py:126-138, statistics/css/threadcss.c:19-20,
statistics/fisher/cFisher.c:62, statistics/css/css.c:76,213).  Here it is
one set of frozen dataclasses; nothing is compile-time.
"""

from __future__ import annotations

import dataclasses
import enum


class MdsAlgorithm(enum.IntEnum):
    """Choice of multi-dimensional-scaling algorithm.

    Integer values match the reference protocol
    (reference statistics/css/css.c:208-218).
    """

    CMDS = 0          # classical MDS (Torgerson scaling, eigendecomposition)
    SMACOF = 1        # SMACOF with random restarts
    CMDS_SMACOF = 2   # CMDS init refined by SMACOF


@dataclasses.dataclass(frozen=True)
class WindowConfig:
    """Sliding-window geometry.

    Defaults match the reference GUI defaults
    (reference tools/FisherExactTestSNPTool.py:118-122).
    """

    wsize: int = 2500   # window size in base pairs
    wstep: int = 500    # window step in base pairs

    def __post_init__(self) -> None:
        if self.wsize <= 0 or self.wstep <= 0:
            raise ValueError("wsize and wstep must be positive")
        # wstep > wsize (sparse, non-overlapping sampling) is legal: the
        # reference validates only integer-ness (reference
        # tools/FisherExactTestSNPTool.py:199-223) and the window-loop
        # semantics are well-defined for any positive geometry
        # (tests/test_ref_c_differential.py::
        #  test_sparse_window_geometry_matches_reference_c)

    def num_slots(self, regend: int) -> int:
        """Length of the output score arrays.

        The reference Python adapter allocates ``regend // wstep`` slots and
        the kernels write window ``w`` at slot ``w.start // wstep``
        (reference statistics/FisherExactScoreStat.py:51-53,
        statistics/css/threadcss.c:262).
        """
        return max(regend // self.wstep, 0)

    def num_windows(self, regend: int) -> int:
        """Number of sliding windows actually evaluated.

        The serial reference loop runs while ``start + wsize <= regend +
        wstep`` (reference statistics/css/css.c:117); window ``k`` starts at
        ``k * wstep``.
        """
        if regend + self.wstep < self.wsize:
            return 0
        return (regend + self.wstep - self.wsize) // self.wstep + 1


@dataclasses.dataclass(frozen=True)
class FetConfig:
    """Fisher's Exact Test windowed scan.

    Defaults are the Burke et al. 2010 protocol used by the reference
    (reference tools/FisherExactTestSNPTool.py:118-126,
    statistics/fisher/cFisher.c:62).
    """

    window: WindowConfig = dataclasses.field(default_factory=WindowConfig)
    percentile: float = 0.95      # window score = this percentile of -log10(p)
    bootstrap_samples: int = 100  # replicates for the stddev estimate
    seed: int = 0                 # deterministic RNG stream (reference is
                                  # wall-clock seeded; see SURVEY.md §5)

    # "exact": float64 end-to-end — bit-comparable to the reference's C
    # doubles.  "fast": float32 compute — scores agree with exact to
    # ~1e-5 relative, p-value distribution unchanged (docs/PARITY.md).
    precision: str = "exact"

    def __post_init__(self) -> None:
        if not 0.0 <= self.percentile <= 1.0:
            raise ValueError("percentile must be in [0, 1]")
        if self.bootstrap_samples <= 1:
            raise ValueError("bootstrap_samples must be > 1")
        if self.precision not in ("exact", "fast"):
            raise ValueError("precision must be 'exact' or 'fast'")


@dataclasses.dataclass(frozen=True)
class SmacofConfig:
    """SMACOF iteration control (reference statistics/css/css.c:213)."""

    max_iters: int = 300
    n_init: int = 4
    epsilon: float = 1e-6


@dataclasses.dataclass(frozen=True)
class CssConfig:
    """Cluster Separation Score windowed scan.

    Defaults match the reference GUI defaults
    (reference tools/ClusterSeparationScore.py:126-138).
    """

    window: WindowConfig = dataclasses.field(default_factory=WindowConfig)
    mc_threshold: int = 10     # stop the permutation MC after this many hits
    mc_runs: int = 200_000     # hard cap on permutations per window
    drosophila: bool = False   # frequency-track mode (2 pseudo-individuals)
    mds: MdsAlgorithm = MdsAlgorithm.CMDS
    smacof: SmacofConfig = dataclasses.field(default_factory=SmacofConfig)
    seed: int = 0

    # Device-side batching knob: permutations are evaluated in fixed-shape
    # chunks of this size inside the on-device while_loop; windows exit as
    # soon as the chunk containing their mc_threshold-th hit completes.
    # Bounds the [window_batch, mc_chunk, m, m] one-hot/matmul buffers.
    mc_chunk: int = 256

    # Windows per MC device launch.  Each launch costs a fixed dispatch
    # latency; genome-scale runs
    # have ~1e5 valid windows, so the batch must be large enough that the
    # launch count, not the latency, is negligible.  Bounds the
    # [mc_window_batch, m, mc_chunk] rank buffer (int32).
    mc_window_batch: int = 8192

    # "exact": float64 scoring (reference C doubles); "fast": float32
    # (scores to ~1e-5 relative; the permutation MC is float32 in both
    # modes).  See docs/PARITY.md.
    precision: str = "exact"

    # p-value estimator: "mc" = the reference's adaptive Monte-Carlo
    # (p=(hits+1)/(n+1), stop at mc_threshold hits or mc_runs);
    # "approx" = Pearson-III null fitted to three moments from ONE chunk
    # of permutations (MRPP-style) — ~200x less device work, model error
    # in the extreme tail (kernels/perm.py:approx_significance).
    p_mode: str = "mc"

    # MC chunk evaluator: "xla" = the device evaluator (shared-stream
    # matmul or per-window rank-fused pass, see mc_stream);
    # "native" = threaded C++ host evaluator with per-window early exit
    # (native/mc_native.cpp) — replays the same stream, the CPU-host
    # answer to the reference's pthread pool (falls back to "xla"
    # without a toolchain).
    perm_backend: str = "xla"

    # Permutation draw stream for the xla backend: "mix" = threefry-keyed
    # counter expansion (kernels/perm.py:_mix_bits, measured ~25% faster
    # in-loop on CPU — bit generation was a major share of the MC
    # kernel); "threefry" = the round-1 f32-uniform stream.  Both are
    # (seed, chrom, slot, chunk)-pinned; the estimator is
    # stream-independent.
    rng: str = "mix"

    # Arithmetic form of the xla chunk evaluator (identical permutations
    # and estimator; see kernels/perm.py:_scores_from_ranks):
    # "broadcast" = one fused [B, m, m, K] coefficient pass (the CPU
    # in-loop winner); "matmul" = between-group sum as a batched matmul
    # via the +-1 identity (the bench-mc A/B decides per device).  Applies to mc_stream="window" only.
    perm_form: str = "broadcast"

    # Permutation-stream design (kernels/perm.py:significance):
    # "shared" (default) = each chunk's permutations are keyed by
    # (seed, chunk) alone and shared by every window — one genome-wide
    # label permutation per draw (Westfall & Young's standard setup; the
    # group labels being permuted ARE the same individuals genome-wide).
    # Collapses the chunk evaluation to one matmul and makes
    # p-values invariant under batching/sharding/resume by construction.
    # "window" = per-window (seed, chrom, slot, chunk)-pinned streams
    # (the round-3 design; required by perm_backend="native",
    # independent MC noise across windows).
    mc_stream: str = "shared"

    def __post_init__(self) -> None:
        if self.mc_threshold <= 0 or self.mc_runs <= 0:
            raise ValueError("mc_threshold and mc_runs must be positive")
        if self.mc_chunk <= 0:
            raise ValueError("mc_chunk must be positive")
        if self.mc_window_batch <= 0:
            raise ValueError("mc_window_batch must be positive")
        if self.precision not in ("exact", "fast"):
            raise ValueError("precision must be 'exact' or 'fast'")
        if self.p_mode not in ("mc", "approx"):
            raise ValueError("p_mode must be 'mc' or 'approx'")
        if self.perm_backend not in ("xla", "native"):
            raise ValueError("perm_backend must be 'xla' or 'native'")
        if self.perm_backend == "native" and self.rng != "mix":
            raise ValueError(
                "perm_backend='native' replays the 'mix' stream only"
            )
        if self.rng not in ("mix", "threefry"):
            raise ValueError("rng must be 'mix' or 'threefry'")
        if self.perm_form not in ("broadcast", "matmul"):
            raise ValueError("perm_form must be 'broadcast' or 'matmul'")
        if self.mc_stream not in ("shared", "window"):
            raise ValueError("mc_stream must be 'shared' or 'window'")
        if self.perm_backend == "native" and self.mc_stream == "shared":
            # the native evaluator replays per-window streams
            object.__setattr__(self, "mc_stream", "window")


@dataclasses.dataclass(frozen=True)
class FetFilterConfig:
    """Region-calling thresholds for FET score tracks.

    Burke et al. formula: ``median(scores) + qnorm(normquantile) *
    percentile(stddevs, stddev_percentile)``
    (reference tools/FilterFisherScores.py:40-48, :84-87).
    """

    max_distance: int = 100_000       # merge windows closer than this
    norm_quantile: float = 0.999
    stddev_percentile: float = 75.0

    def __post_init__(self) -> None:
        if self.max_distance < 0:
            raise ValueError("max_distance must be >= 0")
        if not 0.0 < self.norm_quantile < 1.0:
            # 1.0 would put qnorm at +inf and silently call zero regions
            raise ValueError("norm_quantile must be in (0, 1)")
        if not 0.0 <= self.stddev_percentile <= 100.0:
            raise ValueError("stddev_percentile must be in [0, 100]")


@dataclasses.dataclass(frozen=True)
class CssRegionConfig:
    """Region calling for CSS tracks: BH-FDR or top-N
    (reference tools/SignificantCSSRegions.py:37-50)."""

    mode: str = "fdr"          # "fdr" | "top"
    fdr: float = 0.05
    num_top: int = 100
    window_size: int = 2500    # merge span

    def __post_init__(self) -> None:
        if self.mode not in ("fdr", "top"):
            raise ValueError("mode must be 'fdr' or 'top'")
        if not 0.0 < self.fdr <= 1.0:
            raise ValueError("fdr must be in (0, 1]")
        if self.num_top <= 0:
            raise ValueError("num_top must be positive")
        if self.window_size <= 0:
            raise ValueError("window_size must be positive")
