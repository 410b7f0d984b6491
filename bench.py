"""Benchmark harness: FET/CSS engine throughput vs the measured baselines.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": ...,
   ...extras}

Runs on the GPU only: with no GPU in ``jax.devices()`` it exits non-zero
before measuring anything.  Protocol (BASELINE.md): the reference
publishes no numbers, so the baselines are (a) the CPU oracle (exact
reference semantics, CPython, serial) and (b) the reference C itself
compiled with gcc -O3 -mavx and run through its own 64-thread pool
(baseline/run_baseline.py -> baseline/RESULTS.json).  Workload = the
reference default FET scan (wsize=2500, wstep=500, perc=0.95, 100
bootstrap replicates, stickleback panel 11+10 individuals) on one
synthetic chromosome; CSS = the worst-case adaptive MC (every window
divergent -> full 200k permutations).

Every headline time is the min and the median over ``BENCH_RUNS`` warm
runs; extras include css_perms_per_sec and the reference-C comparison
when baseline/RESULTS.json exists.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

import numpy as np

def _timed_runs(fn, n: int) -> list[float]:
    """Wall-clock ``fn()`` ``n`` times (after the caller's warmup run);
    callers report min AND median over the runs."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return times


def make_chromosome(npos: int, region: int, asize: int, bsize: int, seed: int):
    rng = np.random.default_rng(seed)
    if npos > 500_000:
        # materializing arange(region) for choice(replace=False) costs
        # GBs at chromosome-1 scale; oversampled unique ints give the
        # same sorted-distinct-position contract (different stream, so
        # gated to the new large sizes — existing workloads keep their
        # round-2..4 content for cross-round comparability)
        cand = rng.integers(1, region, size=int(npos * 1.05) + 64)
        positions = np.unique(cand)
        assert len(positions) >= npos, (len(positions), npos)
        positions = positions[
            np.sort(rng.choice(len(positions), npos, replace=False))
        ]
    else:
        positions = np.sort(
            rng.choice(
                np.arange(1, region, dtype=np.int64), npos, replace=False
            )
        )

    def draw(size):
        p_major = rng.uniform(0.2, 0.9, size=(npos, 1))
        g = rng.random((npos, size))
        het = p_major * (1 - p_major) * 2
        mat = np.where(
            g < p_major**2,
            3.0,
            np.where(g < p_major**2 + het, 0.0, -3.0),
        )
        miss = rng.random((npos, size)) < 0.03
        return np.where(miss, -10000.0, mat)

    return positions, draw(asize), draw(bsize)


def _ref_c_numbers() -> dict:
    """The gcc-built reference C results, if captured on this machine."""
    p = pathlib.Path(__file__).parent / "baseline" / "RESULTS.json"
    if not p.exists():
        return {}
    try:
        return json.loads(p.read_text())
    except (OSError, json.JSONDecodeError):
        return {}


def main() -> None:
    import os

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"bench.py measures the GPU; JAX found {dev.platform!r} devices"
        )

    import divergence_tpu  # noqa: F401  (x64)
    from divergence_tpu.config import CssConfig, FetConfig
    from divergence_tpu.core.windows import plan_windows
    from divergence_tpu.engine import run_css, run_fet
    from divergence_tpu.engine.snp import SnpPair
    from divergence_tpu.oracle import reference as oracle
    from divergence_tpu.tools.bench_mc import run_mc_bench
    from divergence_tpu.utils.summary import RunSummary

    asize, bsize = 11, 10
    # FET headline workload: human-chromosome-1 scale (8M SNPs over
    # 400 Mbp, ~40M window-SNP tests), large enough that per-call fixed
    # costs are a small share of the warm wall.
    region = 400_000_000
    npos = 8_000_000
    cfg = FetConfig(precision="fast")
    w = cfg.window

    positions, amat, bmat = make_chromosome(npos, region, asize, bsize, 7)
    pair = SnpPair(positions=positions, avals=amat, bvals=bmat)
    plan = plan_windows(positions, region, w.wsize, w.wstep)
    valid = plan.valid_mask()
    # a "SNP FET test" = one per-SNP exact test inside an evaluated window
    n_tests = int(plan.npos[valid].sum())
    n_windows = int(valid.sum())

    print(
        f"[bench] device={dev.platform} kind={dev.device_kind} "
        f"windows={n_windows} snp_tests={n_tests}",
        file=sys.stderr,
    )

    n_runs = int(os.environ.get("BENCH_RUNS", "4"))
    scores = None

    def _fet_once():
        nonlocal scores
        scores, _ = run_fet(pair, region, cfg)

    _fet_once()  # warmup/compile
    fet_times = _timed_runs(_fet_once, n_runs)
    fet_s = min(fet_times)
    fet_median_s = float(np.median(fet_times))
    fet_rate = n_tests / fet_s

    # --- CPU oracle baseline on a slice, extrapolated ---
    n_slice = 24
    widx = np.nonzero(valid)[0][:n_slice]
    rng = np.random.default_rng(0)
    slice_tests = 0
    t0 = time.perf_counter()
    for i in widx:
        lo, np_ = int(plan.lo[i]), int(plan.npos[i])
        oracle.window_fet(
            amat[lo : lo + np_],
            bmat[lo : lo + np_],
            cfg.percentile,
            cfg.bootstrap_samples,
            rng,
        )
        slice_tests += np_
    oracle_s = time.perf_counter() - t0
    oracle_rate = slice_tests / oracle_s

    vs = fet_rate / oracle_rate
    print(
        f"[bench] fet={fet_s:.3f}s ({fet_rate:,.0f} tests/s)  "
        f"oracle[{n_slice}w]={oracle_s:.3f}s ({oracle_rate:,.0f} tests/s)  "
        f"speedup={vs:.1f}x  windows/s={n_windows / fet_s:,.0f}",
        file=sys.stderr,
    )
    nz = int(np.count_nonzero(scores))
    print(f"[bench] nonzero-score windows: {nz}", file=sys.stderr)

    ref_c = _ref_c_numbers()
    extras = {
        "fet_windows_per_sec": round(n_windows / fet_s, 1),
        "bench_runs_n": n_runs,
        "fet_tests_per_sec_median": round(n_tests / fet_median_s, 1),
        "fet_wall_s_min": round(fet_s, 3),
        "fet_wall_s_median": round(fet_median_s, 3),
    }
    if ref_c:
        rate = ref_c.get("fet_thread", {}).get("snp_tests_per_s")
        if rate:
            extras["ref_c_fet_tests_per_sec_64thr"] = rate
            extras["vs_ref_c_fet"] = round(fet_rate / rate, 2)

    # CSS worst case: every window divergent, so each one runs the full
    # 200k-permutation MC
    css_npos, css_region = 10_000, 500_000
    cpos, camat, cbmat = make_chromosome(css_npos, css_region, asize, bsize, 11)
    cpair = SnpPair(positions=cpos, avals=camat, bvals=cbmat)
    css_cfg = CssConfig(precision="fast")
    run_css(cpair, css_region, css_cfg)
    cs = csum = None

    def _css_once():
        nonlocal cs, csum
        csum = RunSummary()
        cs, _ = run_css(cpair, css_region, css_cfg, summary=csum)

    css_times = _timed_runs(_css_once, n_runs)
    css_s = min(css_times)
    css_median_s = float(np.median(css_times))
    ncw = int(np.count_nonzero(cs))
    mc = csum.counters.get("mc_permutations", 0)

    rng_o = np.random.default_rng(0)
    dref = rng_o.random((asize + bsize, asize + bsize))
    dref = dref + dref.T
    np.fill_diagonal(dref, 0.0)
    t0 = time.perf_counter()
    oracle.significance(dref, asize, bsize, 1e9, 10, 3000, rng_o)
    oracle_perm_rate = 3000 / (time.perf_counter() - t0)
    print(
        f"[bench] css: {css_s:.2f}s for {ncw} windows "
        f"({ncw / css_s:,.0f} win/s), {mc / 1e6:.0f}M permutations "
        f"({mc / css_s / 1e6:.0f}M perms/s; oracle "
        f"{oracle_perm_rate / 1e3:.0f}k/s -> "
        f"{mc / css_s / oracle_perm_rate:,.0f}x)",
        file=sys.stderr,
    )

    # the MC phase's own rate (stage timer) beside the end-to-end one:
    # the worst-case wall also holds phase 1 (eigensolves) and fixed costs
    mc_stage_s = csum.timings_s.get("css_mc", 0.0)
    extras.update(
        {
            "css_perms_per_sec": round(mc / css_s, 1),
            "css_windows_per_sec": round(ncw / css_s, 2),
            "css_perms_per_sec_median": round(mc / css_median_s, 1),
            "css_wall_s_min": round(css_s, 3),
            "css_wall_s_median": round(css_median_s, 3),
            "css_mc_stage_s": round(mc_stage_s, 3),
            "css_mc_perms_per_sec": round(mc / mc_stage_s, 1)
            if mc_stage_s
            else None,
        }
    )

    # 16x worst-case workload (16k all-divergent windows, 3.2G perms):
    # the same measurement with fixed per-call costs amortized
    lpos, lam, lbm = make_chromosome(160_000, 8_000_000, asize, bsize, 11)
    lpair = SnpPair(positions=lpos, avals=lam, bvals=lbm)
    run_css(lpair, 8_000_000, css_cfg)  # warmup/compile
    lsum = None

    def _css_large_once():
        nonlocal lsum
        lsum = RunSummary()
        run_css(lpair, 8_000_000, css_cfg, summary=lsum)

    l_times = _timed_runs(_css_large_once, max(2, n_runs - 1))
    l_s = min(l_times)
    l_mc = lsum.counters.get("mc_permutations", 0)
    print(
        f"[bench] css 16x worst-case: {l_s:.2f}s, {l_mc / 1e6:.0f}M perms "
        f"({l_mc / l_s / 1e6:.0f}M perms/s; median "
        f"{l_mc / float(np.median(l_times)) / 1e6:.0f}M)",
        file=sys.stderr,
    )
    extras["css_perms_per_sec_large"] = round(l_mc / l_s, 1)
    extras["css_perms_per_sec_large_median"] = round(
        l_mc / float(np.median(l_times)), 1
    )
    extras["css_large_wall_s_min"] = round(l_s, 3)

    # Sustained MC throughput at production shape: the in-loop
    # shared-stream evaluator over 8192 windows x 256-perm chunks with
    # unreachable scores (every window consumes its full budget)
    mcb = run_mc_bench(
        window_batch=8192, chunk=256, iters=256,
        backends=("inloop_shared",),
    )
    rate = mcb.get("inloop_shared", {}).get("perms_per_s")
    if rate:
        extras["css_mc_inloop_perms_per_sec"] = rate
        print(
            f"[bench] css MC in-loop (8192x256x256, shared stream): "
            f"{rate / 1e9:.2f}G perms/s",
            file=sys.stderr,
        )

    # chromosome-scale CSS scan (200k SNPs over 10 Mbp, ~20k windows,
    # mixed significance like production data)
    m_region = 10_000_000
    mp, ma, mb = make_chromosome(200_000, m_region, asize, bsize, 7)
    mpair = SnpPair(positions=mp, avals=ma, bvals=mb)
    run_css(mpair, m_region, css_cfg)
    gs = None

    def _chrom_once():
        nonlocal gs
        gs, _ = run_css(mpair, m_region, css_cfg, seqid="chrG")

    g_times = _timed_runs(_chrom_once, max(2, n_runs - 1))
    g_s = min(g_times)
    g_nw = int(np.count_nonzero(gs))
    print(
        f"[bench] css chromosome-scale: {g_s:.2f}s for {g_nw} windows "
        f"({g_nw / g_s:,.0f} win/s)",
        file=sys.stderr,
    )
    extras["css_chrom_scale_windows_per_sec"] = round(g_nw / g_s, 1)
    extras["css_chrom_scale_wall_s"] = round(g_s, 2)
    extras["css_chrom_scale_wall_s_median"] = round(
        float(np.median(g_times)), 2
    )

    # --- exact-precision mode (the reference-parity configuration,
    # `--precision exact`; all doubles like the C,
    # reference statistics/fisher/cFisher.c:38) ---
    e_runs = max(2, n_runs - 1)
    e_cfg = FetConfig(precision="exact")

    def _fet_exact_once():
        run_fet(pair, region, e_cfg)

    _fet_exact_once()  # warmup/compile
    fe_times = _timed_runs(_fet_exact_once, e_runs)
    fe_s = min(fe_times)
    print(
        f"[bench] fet exact: {fe_s:.3f}s ({n_tests / fe_s:,.0f} tests/s; "
        f"median {n_tests / float(np.median(fe_times)):,.0f})",
        file=sys.stderr,
    )
    extras["fet_exact_tests_per_sec"] = round(n_tests / fe_s, 1)
    extras["fet_exact_tests_per_sec_median"] = round(
        n_tests / float(np.median(fe_times)), 1
    )
    extras["fet_exact_wall_s_min"] = round(fe_s, 3)

    ce_cfg = CssConfig(precision="exact")
    cesum = None

    def _css_exact_once():
        nonlocal cesum
        cesum = RunSummary()
        run_css(cpair, css_region, ce_cfg, summary=cesum)

    _css_exact_once()  # warmup/compile
    ce_times = _timed_runs(_css_exact_once, e_runs)
    ce_s = min(ce_times)
    ce_mc = cesum.counters.get("mc_permutations", 0)
    print(
        f"[bench] css exact: {ce_s:.2f}s, {ce_mc / 1e6:.0f}M perms "
        f"({ce_mc / ce_s / 1e6:.0f}M perms/s; median "
        f"{ce_mc / float(np.median(ce_times)) / 1e6:.0f}M)",
        file=sys.stderr,
    )
    extras["css_exact_perms_per_sec"] = round(ce_mc / ce_s, 1)
    extras["css_exact_perms_per_sec_median"] = round(
        ce_mc / float(np.median(ce_times)), 1
    )
    extras["css_exact_wall_s_min"] = round(ce_s, 3)

    if ref_c:
        perm_rate = ref_c.get("css_thread", {}).get("approx_perms_per_s")
        if perm_rate:
            extras["ref_c_css_perms_per_sec_64thr"] = perm_rate
            extras["vs_ref_c_css"] = round(mc / css_s / perm_rate, 2)

    print(
        json.dumps(
            {
                "metric": "fet_snp_tests_per_sec",
                "value": round(fet_rate, 1),
                "unit": "tests/s",
                "vs_baseline": round(vs, 2),
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
                **extras,
            }
        )
    )


if __name__ == "__main__":
    main()
