"""Command-line tools — the framework's user surface.

Replaces the reference's five Galaxy GUI tools + converters (reference
tools/, SURVEY.md §2.3) with CLI subcommands:

| subcommand        | replaces (reference tools/)            |
|-------------------|----------------------------------------|
| convert-vcf       | reference tools/ConvertVCFToGtrackTool.py + reference tools/VCFConvert.py |
| convert-snp-table | reference tools/ConvertSticklebackSnpsToGtrack.py      |
| run-fet           | reference tools/FisherExactTestSNPTool.py              |
| run-css           | reference tools/ClusterSeparationScore.py              |
| filter-fet        | reference tools/FilterFisherScores.py                  |
| call-css-regions  | reference tools/SignificantCSSRegions.py               |

Usage: ``python -m divergence_tpu.tools.cli <subcommand> --help``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def _read_population(args) -> list[str]:
    """Population members from a file (one per line) or a comma list
    (reference tools/ConvertVCFToGtrackTool.py:133-141)."""
    if args.population_file:
        with open(args.population_file) as fh:
            return [ln.strip() for ln in fh if ln.strip()]
    if args.population:
        return [x.strip() for x in args.population.split(",") if x.strip()]
    raise SystemExit("one of --population / --population-file is required")


def cmd_convert_vcf(args) -> None:
    from divergence_tpu.io import vcf_to_gtrack

    found = vcf_to_gtrack(
        args.vcf, _read_population(args), args.out, args.genome
    )
    print(f"wrote {args.out}: {len(found)} individuals ({', '.join(found)})")


def cmd_convert_snp_table(args) -> None:
    from divergence_tpu.io.snptable import snp_table_to_gtrack

    ids = [x.strip() for x in args.ids.split(",") if x.strip()]
    labels = snp_table_to_gtrack(args.table, ids, args.out, args.genome)
    print(f"wrote {args.out}: {len(labels)} individuals")


def _load_pairs(args):
    """Read both population tracks, align per chromosome, return
    {seqid: (SnpPair, regend)} plus chromosome lengths if given.

    The two tracks parse concurrently: the native parser is a ctypes
    call (GIL released), so the second file's I/O overlaps the first's
    parse threads."""
    import threading

    from divergence_tpu.engine.snp import SnpPair
    from divergence_tpu.io import read_gtrack_points
    from divergence_tpu.io.genome import read_chrom_sizes

    tracks: dict[str, object] = {}
    errs: list[BaseException] = []

    def _parse(key, path):
        try:
            tracks[key] = read_gtrack_points(path)
        except BaseException as e:  # re-raised on the main thread
            errs.append(e)

    th = threading.Thread(target=_parse, args=("b", args.pop_b))
    th.start()
    _parse("a", args.pop_a)
    th.join()
    if errs:
        raise errs[0]
    ta, tb = tracks["a"], tracks["b"]
    sizes = read_chrom_sizes(args.chrom_sizes) if args.chrom_sizes else {}
    common = sorted(set(ta) & set(tb))
    if not common:
        raise SystemExit("no chromosome appears in both tracks")
    skipped = sorted(set(ta) ^ set(tb))
    if skipped:
        print(f"skipping chromosomes present in only one track: {skipped}")
    pairs = {}
    for seqid in common:
        pair = SnpPair.from_tracks(ta[seqid], tb[seqid])
        regend = sizes.get(seqid, int(pair.positions[-1]) + 1)
        pairs[seqid] = (pair, regend)
    return pairs, sizes


def _host_filter(pairs, args):
    """Multi-host work partitioning (deterministic, no comms).

    Slot-granular since round 5: a chromosome whose weight exceeds the
    per-host average is split into contiguous slot ranges (the
    generalization of the reference's window-range tasking,
    reference statistics/css/threadcss.c:114-124), so a genome that is
    one large chromosome still scales across hosts.  Each host's input
    is sliced to its owned span plus the wsize-wstep halo at each cut;
    slot-keyed RNG makes the union of host outputs bit-identical to the
    single-host run (tests/test_parallel.py slot-range tests).

    Returns (pairs, slot_ranges) — slot_ranges only carries entries for
    partial-chromosome assignments."""
    if args.num_hosts <= 1:
        return pairs, None
    from divergence_tpu.parallel import partition_chromosomes

    weights = {s: p.npos for s, (p, _) in pairs.items()}
    nslots = {s: r // args.wstep for s, (_, r) in pairs.items()}
    assignment = partition_chromosomes(
        weights, args.num_hosts, args.host_id, seqid_nslots=nslots
    )
    out, slot_ranges = {}, {}
    for wr in assignment.ranges:
        # partition_chromosomes guarantees at most one (merged) range
        # per chromosome per host; this dict-based plumbing cannot
        # represent more, so refuse loudly rather than silently keeping
        # only the last range (= dropping windows from the genome)
        if wr.seqid in out:
            raise AssertionError(
                f"host {args.host_id}: multiple ranges for {wr.seqid} — "
                "partitioner invariant violated"
            )
        pair, regend = pairs[wr.seqid]
        if wr.covers(nslots[wr.seqid]):
            out[wr.seqid] = (pair, regend)
            continue
        # partial chromosome: slice the SNP span this range can read —
        # [slot_lo*wstep, (slot_hi-1)*wstep + wsize] inclusive (window
        # [start, start+wsize] includes both endpoints, core/windows.py)
        hi_slot = min(wr.slot_hi, nslots[wr.seqid]) - 1
        span_lo = wr.slot_lo * args.wstep
        span_hi = hi_slot * args.wstep + args.wsize
        out[wr.seqid] = (pair.slice_span(span_lo, span_hi), regend)
        slot_ranges[wr.seqid] = (wr.slot_lo, wr.slot_hi)
    desc = [
        f"{r.seqid}" if r.covers(nslots[r.seqid])
        else f"{r.seqid}[{r.slot_lo}:{min(r.slot_hi, nslots[r.seqid])}]"
        for r in assignment.ranges
    ]
    print(f"host {args.host_id}/{args.num_hosts} takes {desc}")
    return out, slot_ranges or None


def _mesh_sharding(args):
    if not args.shard:
        return None
    from divergence_tpu.parallel import make_mesh, window_sharding

    return window_sharding(make_mesh())


def _run_engine(args, engine, cfg, columns, engine_multi=None,
                preloaded=None) -> None:
    """Shared driver for run-fet / run-css.

    Per-chromosome part files make a failed genome-wide run resumable at
    chromosome granularity (SURVEY.md §5 failure model: per-job restart,
    shard = chromosome); ``--profile`` wraps the run in a
    ``jax.profiler`` trace.  ``preloaded`` = (pairs, slot_ranges,
    sharding) lets ``run-all`` load + upload the genome ONCE for both
    engines (the joint int16 genotype upload is cached on the SnpPair
    objects, engine/snp.py:device_values_joint)."""
    import contextlib

    from divergence_tpu.io import write_score_track
    from divergence_tpu.io.gtrack import read_score_track
    from divergence_tpu.utils.summary import RunSummary

    if preloaded is None:
        pairs, _ = _load_pairs(args)
        pairs, slot_ranges = _host_filter(pairs, args)
        sharding = _mesh_sharding(args)
    else:
        pairs, slot_ranges, sharding = preloaded

    def _part_name(seqid):
        # partial-chromosome shards (slot-range partitioning) get their
        # range in the part-file name, so a re-partitioned resume never
        # silently reuses a stale partial file
        r = (slot_ranges or {}).get(seqid)
        return f"{seqid}.tsv" if r is None else f"{seqid}@{r[0]}-{r[1]}.tsv"
    summary = RunSummary(name=args.cmd)

    parts_dir = None
    if args.resume:
        parts_dir = Path(args.out + ".parts")
        parts_dir.mkdir(exist_ok=True)

    profile_ctx = contextlib.nullcontext()
    if args.profile:
        import jax

        profile_ctx = jax.profiler.trace(args.profile)

    results = {}
    t0 = time.perf_counter()
    total_windows = 0

    # Backend start-up attributed to its own stage: the first device
    # interaction of a process pays the runtime's initialization, which
    # would otherwise land inside the engine's "genome" stage.
    with summary.stage("backend_init"):
        import jax
        import jax.numpy as jnp

        jax.device_get(jnp.zeros(1))

    # Resume: load chromosomes whose part files already exist and drop
    # them from the work list — the REMAINDER still runs through the
    # fused genome-wide path below (a resumed run keeps the fresh run's
    # dispatch structure; per-window RNG streams are (chrom, slot)-pinned
    # so the tracks are byte-identical, docs/PARITY.md "Stream identity").
    remaining = pairs
    if parts_dir is not None:
        import numpy as np

        remaining = {}
        for seqid, (pair, regend) in pairs.items():
            part = parts_dir / _part_name(seqid)
            if not part.exists():
                remaining[seqid] = (pair, regend)
                continue
            _, starts, c2, c3 = read_score_track(part)
            nslots = cfg.window.num_slots(regend)
            s = np.zeros(nslots)
            x = np.zeros(nslots)
            slots = starts // cfg.window.wstep
            s[slots] = c2
            x[slots] = c3
            results[seqid] = (s, x)
            print(f"{seqid}: resumed from {part}")

    def _finish_chrom(seqid):
        nonlocal total_windows
        import numpy as np

        nw = int((results[seqid][0] != 0).sum())
        total_windows += nw
        print(f"{seqid}: {nw} scored windows")
        # NaNs should be impossible in EITHER column (kernels snap
        # degenerate eigen-dust, scores are log-space-finite, p comes
        # from a counting estimator) — if a solver ever regresses to
        # emitting them intermittently, say so loudly instead of letting
        # a poisoned track flow into region calling (BH-FDR ranks the p
        # column, so a NaN there corrupts the threshold silently)
        n_nan = int(
            np.isnan(results[seqid][0]).sum()
            + np.isnan(results[seqid][1]).sum()
        )
        if n_nan:
            print(
                f"WARNING: {seqid}: {n_nan} NaN values in the output "
                "track — solver regression? (docs/PARITY.md deviation 8)",
                file=sys.stderr,
            )
        if parts_dir is not None:
            write_score_track(
                parts_dir / _part_name(seqid),
                {seqid: results[seqid]},
                cfg.window.wstep,
                columns,
            )

    if engine_multi is not None and len(remaining) > 1:
        # genome-wide path: every chromosome enqueued before the single
        # host sync (and, for CSS, one genome-wide permutation MC)
        with profile_ctx, summary.stage("genome"):
            results.update(
                engine_multi(
                    remaining, cfg, sharding=sharding, summary=summary,
                    slot_ranges={
                        s: r
                        for s, r in (slot_ranges or {}).items()
                        if s in remaining
                    } or None,
                )
            )
        for seqid in remaining:
            _finish_chrom(seqid)
    else:
        with profile_ctx:
            for seqid, (pair, regend) in remaining.items():
                with summary.stage(seqid):
                    results[seqid] = engine(
                        pair,
                        regend,
                        cfg,
                        sharding=sharding,
                        summary=summary,
                        seqid=seqid,
                        slot_range=(slot_ranges or {}).get(seqid),
                    )
                _finish_chrom(seqid)
    elapsed = time.perf_counter() - t0
    summary.counters["total_s"] = round(elapsed, 3)
    summary.counters["windows_per_s"] = round(total_windows / elapsed, 1)
    # chromosome order in the track is the load order, not the (resume
    # -dependent) completion order: resumed-vs-fresh byte identity
    results = {s: results[s] for s in pairs if s in results}
    write_score_track(args.out, results, cfg.window.wstep, columns)
    print(f"wrote {args.out}")
    if args.summary:
        summary.write(args.summary)


def cmd_run_fet(args) -> None:
    from divergence_tpu.config import FetConfig, WindowConfig
    from divergence_tpu.engine import run_fet

    from divergence_tpu.engine.fet_engine import run_fet_multi

    cfg = FetConfig(
        window=WindowConfig(wsize=args.wsize, wstep=args.wstep),
        percentile=args.percentile,
        bootstrap_samples=args.bootstrap_samples,
        seed=args.seed,
        precision=args.precision,
    )
    _run_engine(
        args, run_fet, cfg, ("score", "stddev"), engine_multi=run_fet_multi
    )


def _mds_enum(name):
    """One shared --mds string->enum map for run-css AND run-all (a
    divergent copy would break the byte-identical-pipelines contract
    for exactly the added value)."""
    from divergence_tpu.config import MdsAlgorithm

    return {
        "cmds": MdsAlgorithm.CMDS,
        "smacof": MdsAlgorithm.SMACOF,
        "cmds+smacof": MdsAlgorithm.CMDS_SMACOF,
    }[name]


def cmd_run_css(args) -> None:
    from divergence_tpu.config import CssConfig, WindowConfig
    from divergence_tpu.engine import run_css

    mds = _mds_enum(args.mds)
    if args.p_mode == "approx":
        # Measured round 4: the Pearson-III tail reads up to ~4x smaller
        # than the exact MC for true p <= 1e-3 (anti-conservative,
        # baseline/exp_approx_tail.py) AND the fused shared-stream MC is
        # no slower at genome scale — approx survives only for callers
        # that explicitly want the moment fit.
        print(
            "WARNING: --p-mode approx is ANTI-conservative in the "
            "extreme tail (p up to ~4x too small for true p <= 1e-3; "
            "docs/PARITY.md) and is not faster than the exact MC at "
            "genome scale — prefer the default --p-mode mc",
            file=sys.stderr,
        )
    cfg = CssConfig(
        window=WindowConfig(wsize=args.wsize, wstep=args.wstep),
        mc_threshold=args.mc_threshold,
        mc_runs=args.mc_runs,
        drosophila=args.drosophila,
        mds=mds,
        seed=args.seed,
        mc_chunk=args.mc_chunk,
        precision=args.precision,
        p_mode=args.p_mode,
        perm_backend=args.perm_backend,
        rng=args.rng,
        perm_form=args.perm_form,
        mc_stream=args.mc_stream,
    )
    from divergence_tpu.engine.css_engine import run_css_multi

    _run_engine(
        args, run_css, cfg, ("score", "p"), engine_multi=run_css_multi
    )


def cmd_run_all(args) -> None:
    """Whole pipeline in ONE process: run-fet + run-css + both region
    callers + HTML report.

    The platform runs every statistic inside one job
    (reference tools/FisherExactTestSNPTool.py:167-171); staged CLI runs
    re-pay the per-process constants (backend init, tracing, cache
    loads) and the genotype upload per subcommand.  Here the genome is read, aligned, and
    uploaded ONCE (the SnpPair device cache is shared by both engines)
    and every fixed cost is paid once.  Outputs are byte-identical to
    the staged subcommands (RNG streams are (seed, chrom, slot)-pinned;
    tests/test_cli.py::test_run_all_matches_staged_pipeline)."""
    import argparse as _ap

    from divergence_tpu.config import CssConfig, FetConfig, WindowConfig
    from divergence_tpu.engine import run_css, run_fet
    from divergence_tpu.engine.css_engine import run_css_multi
    from divergence_tpu.engine.fet_engine import run_fet_multi

    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    pairs, _ = _load_pairs(args)
    pairs, slot_ranges = _host_filter(pairs, args)
    sharding = _mesh_sharding(args)
    preloaded = (pairs, slot_ranges, sharding)

    def stage_args(cmd, out, summary):
        d = dict(vars(args))
        d.update(cmd=cmd, out=str(out), summary=summary)
        return _ap.Namespace(**d)

    wcfg = WindowConfig(wsize=args.wsize, wstep=args.wstep)
    fet_cfg = FetConfig(
        window=wcfg,
        percentile=args.percentile,
        bootstrap_samples=args.bootstrap_samples,
        seed=args.seed,
        precision=args.precision,
    )
    fet_track = outdir / "fet.track"
    _run_engine(
        stage_args("run-fet", fet_track, str(outdir / "fet_summary.json")),
        run_fet, fet_cfg, ("score", "stddev"),
        engine_multi=run_fet_multi, preloaded=preloaded,
    )

    mds = _mds_enum(args.mds)
    css_cfg = CssConfig(
        window=wcfg,
        mc_threshold=args.mc_threshold,
        mc_runs=args.mc_runs,
        drosophila=args.drosophila,
        mds=mds,
        seed=args.seed,
        mc_chunk=args.mc_chunk,
        precision=args.precision,
        p_mode=args.p_mode,
        perm_backend=args.perm_backend,
        rng=args.rng,
        perm_form=args.perm_form,
        mc_stream=args.mc_stream,
    )
    css_track = outdir / "css.track"
    _run_engine(
        stage_args("run-css", css_track, str(outdir / "css_summary.json")),
        run_css, css_cfg, ("score", "p"),
        engine_multi=run_css_multi, preloaded=preloaded,
    )

    # A user-supplied --summary used to be silently discarded (the
    # per-engine stage_args override it); honor it with the combined
    # per-engine summaries.
    if getattr(args, "summary", None):
        combined = {
            name: json.loads((outdir / f"{name}_summary.json").read_text())
            for name in ("fet", "css")
        }
        Path(args.summary).write_text(json.dumps(combined, indent=1) + "\n")
        print(f"wrote {args.summary}")

    # Region thresholds are GENOME-WIDE statistics (the Burke limit's
    # score median, BH-FDR's rank over all windows — stats/regions.py),
    # so calling them on one host's partial track would silently produce
    # wrong regions.  Under multi-host partitioning each host emits its
    # track shards only; region calling runs once after merge-tracks.
    if args.num_hosts > 1:
        print(
            f"multi-host shard {args.host_id}/{args.num_hosts}: wrote "
            "track shards only (region thresholds are genome-wide "
            "statistics).  After all hosts finish: merge-tracks the "
            "fet/css shards, then filter-fet + call-css-regions + "
            "report on the merged tracks."
        )
        return

    cmd_filter_fet(_ap.Namespace(
        scores=str(fet_track),
        out=str(outdir / "fet_regions.gtrack"),
        max_distance=args.max_distance,
        norm_quantile=args.norm_quantile,
        stddev_percentile=args.stddev_percentile,
        chrom_sizes=args.chrom_sizes,
    ))
    cmd_call_css_regions(_ap.Namespace(
        scores=str(css_track),
        out=str(outdir / "css_regions.gtrack"),
        mode=args.mode,
        fdr=args.fdr,
        num_top=args.num_top,
        window_size=args.wsize,
        chrom_sizes=args.chrom_sizes,
    ))
    _cmd_report(_ap.Namespace(
        fet_track=str(fet_track),
        css_track=str(css_track),
        fet_regions=str(outdir / "fet_regions.gtrack"),
        css_regions=str(outdir / "css_regions.gtrack"),
        run_summary=str(outdir / "fet_summary.json"),
        out=str(outdir / "report.html"),
        title=args.title,
    ))


def _cmd_report(args) -> None:
    from divergence_tpu.tools.report import write_report

    write_report(
        args.out,
        fet_track=args.fet_track,
        css_track=args.css_track,
        fet_regions=args.fet_regions,
        css_regions=args.css_regions,
        summary_json=args.run_summary,
        title=args.title,
    )
    print(f"wrote {args.out}")


def _cmd_merge_tracks(args) -> None:
    """Merge per-host score-track shards into one genome-wide track.

    The host-side half of the multi-host fan-out (each host runs
    ``--num-hosts N --host-id k`` over a disjoint chromosome set and
    writes its shard; SURVEY.md §5 distributed backend: per-host file
    writes + host-side concat instead of an on-device gather)."""
    from divergence_tpu.io.gtrack import read_score_track

    # slot-range shards (round 5) may legitimately split one chromosome
    # across hosts, so overlap detection is per-ROW: the same (seqid,
    # start) window appearing in two shards means the partitions
    # overlap (or the same shard was passed twice) — refuse.
    seen_rows: dict[tuple[str, int], str] = {}
    rows: list[tuple[str, int, str]] = []
    header = None
    for path in args.inputs:
        with open(path) as fh:
            first = fh.readline().rstrip("\n")
        if first.startswith("#"):
            if header is None:
                header = first
            elif first != header:
                raise SystemExit(
                    f"{path}: column header {first!r} differs from "
                    f"{header!r} — refusing to merge mixed track types"
                )
        seqids, starts, c2, c3 = read_score_track(path)
        for s, st, a, b in zip(seqids, starts, c2, c3):
            rk = (s, int(st))
            if rk in seen_rows:
                raise SystemExit(
                    f"window {s}:{st} appears in both {seen_rows[rk]} "
                    f"and {path} — host shards overlap"
                )
            seen_rows[rk] = str(path)
            rows.append(
                (s, int(st), f"{s}\t{st}\t{float(a)!r}\t{float(b)!r}\n")
            )
    rows.sort(key=lambda r: (r[0], r[1]))
    with open(args.out, "w") as out:
        out.write((header or "#seqid\tstart\tscore\taux") + "\n")
        for _, _, line in rows:
            out.write(line)
    print(f"merged {len(args.inputs)} shards, {len(rows)} rows -> {args.out}")


def _cmd_doctor(args) -> None:
    from divergence_tpu.tools.doctor import main as doctor_main

    doctor_main(args)


def _cmd_bench_mc(args) -> None:
    from divergence_tpu.tools.bench_mc import main as bench_mc_main

    bench_mc_main(args)


def _cmd_bench_scaling(args) -> None:
    from divergence_tpu.tools.bench_scaling import main as bench_main

    bench_main(args)


def cmd_filter_fet(args) -> None:
    from divergence_tpu.config import FetFilterConfig
    from divergence_tpu.io import read_score_track, write_segments_track
    from divergence_tpu.io.genome import read_chrom_sizes
    from divergence_tpu.stats import filter_fet_regions

    seqids, starts, scores, stddevs = read_score_track(args.scores)
    sizes = read_chrom_sizes(args.chrom_sizes) if args.chrom_sizes else None
    call = filter_fet_regions(
        seqids,
        starts,
        scores,
        stddevs,
        FetFilterConfig(
            max_distance=args.max_distance,
            norm_quantile=args.norm_quantile,
            stddev_percentile=args.stddev_percentile,
        ),
        chrom_lengths=sizes,
    )
    write_segments_track(args.out, call.segments)
    print(
        json.dumps(
            {
                "windows_passing": call.n_windows_passing,
                "limit": call.threshold,
                "regions": len(call.segments),
                **call.info,
            }
        )
    )


def cmd_call_css_regions(args) -> None:
    from divergence_tpu.config import CssRegionConfig
    from divergence_tpu.io import read_score_track, write_segments_track
    from divergence_tpu.io.genome import read_chrom_sizes
    from divergence_tpu.stats import call_css_regions

    seqids, starts, scores, pvals = read_score_track(args.scores)
    sizes = read_chrom_sizes(args.chrom_sizes) if args.chrom_sizes else None
    call = call_css_regions(
        seqids,
        starts,
        scores,
        pvals,
        CssRegionConfig(
            mode=args.mode,
            fdr=args.fdr,
            num_top=args.num_top,
            window_size=args.window_size,
        ),
        chrom_lengths=sizes,
    )
    write_segments_track(args.out, call.segments)
    print(
        json.dumps(
            {
                "windows_passing": call.n_windows_passing,
                "threshold": call.threshold,
                "regions": len(call.segments),
                **{k: v for k, v in call.info.items()},
            }
        )
    )


def _add_run_common(p: argparse.ArgumentParser, with_out: bool = True) -> None:
    p.add_argument("--pop-a", required=True, help="population A GTrack file")
    p.add_argument("--pop-b", required=True, help="population B GTrack file")
    if with_out:
        p.add_argument("--out", required=True, help="output score track")
    p.add_argument("--wsize", type=int, default=2500)
    p.add_argument("--wstep", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--chrom-sizes",
        default=None,
        help="chrom.sizes file; without it regend = last SNP position + 1",
    )
    p.add_argument("--summary", default=None, help="write run-summary JSON here")
    p.add_argument(
        "--shard",
        action="store_true",
        help="shard window batches over all local devices",
    )
    p.add_argument("--num-hosts", type=int, default=1)
    p.add_argument("--host-id", type=int, default=0)
    p.add_argument(
        "--resume",
        action="store_true",
        help="keep per-chromosome part files next to --out and skip "
        "chromosomes already completed by a previous (failed) run",
    )
    p.add_argument(
        "--profile",
        default=None,
        help="write a jax.profiler trace to this directory",
    )
    p.add_argument(
        "--precision",
        choices=["exact", "fast"],
        default="fast",
        help="fast = float32 (the production default; ~1e-5 relative "
        "score accuracy, docs/PARITY.md); exact = float64 end-to-end "
        "(the reference-parity mode — the reference C is all doubles; "
        "bench.py measures both, fet_exact_* / css_exact_* fields)",
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="divergence_tpu",
        description="genome-wide divergence analysis on the GPU (FET + CSS)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("convert-vcf", help="VCF → GTrack valued points")
    p.add_argument("--vcf", required=True)
    p.add_argument("--population", default=None, help="comma-separated names")
    p.add_argument("--population-file", default=None, help="one name per line")
    p.add_argument("--out", required=True)
    p.add_argument("--genome", default="unknown")
    p.set_defaults(fn=cmd_convert_vcf)

    p = sub.add_parser(
        "convert-snp-table", help="Jones-et-al SNP table → GTrack"
    )
    p.add_argument("--table", required=True)
    p.add_argument("--ids", required=True, help="comma list of IDs/offsets")
    p.add_argument("--out", required=True)
    p.add_argument("--genome", default="unknown")
    p.set_defaults(fn=cmd_convert_snp_table)

    def _add_fet_args(p):
        p.add_argument("--percentile", type=float, default=0.95)
        p.add_argument("--bootstrap-samples", type=int, default=100)

    p = sub.add_parser("run-fet", help="windowed Fisher's Exact Test scan")
    _add_run_common(p)
    _add_fet_args(p)
    p.set_defaults(fn=cmd_run_fet)

    def _add_css_args(p):
        p.add_argument(
            "--mds",
            choices=["cmds", "smacof", "cmds+smacof"],
            default="cmds",
        )
        p.add_argument("--mc-threshold", type=int, default=10)
        p.add_argument("--mc-runs", type=int, default=200_000)
        p.add_argument("--mc-chunk", type=int, default=256)
        p.add_argument(
            "--p-mode",
            choices=["mc", "approx"],
            default="mc",
            help="mc = reference-exact adaptive Monte-Carlo (default; the "
            "fused genome-wide MC matches approx-mode wall time at genome "
            "scale).  approx = Pearson-III moment fit from a few "
            "permutation chunks — caps worst-case all-divergent latency, "
            "but is ANTI-conservative in the extreme tail: p can read up "
            "to ~4x smaller than the exact MC for true p <= 1e-3 "
            "(measured: baseline/exp_approx_tail.py; docs/PARITY.md)",
        )
        p.add_argument("--drosophila", action="store_true")
        p.add_argument(
            "--perm-backend",
            choices=["xla", "native"],
            default="xla",
            help="MC chunk evaluator: xla = device evaluator (shared-stream "
            "matmul by default, per-window threefry streams with "
            "--mc-stream window); native = threaded C++ host evaluator "
            "(window streams, per-window early exit — for CPU hosts)",
        )
        p.add_argument(
            "--rng",
            choices=["mix", "threefry"],
            default="mix",
            help="permutation draw stream (xla backend): mix = counter "
            "expansion (faster), threefry = round-1 f32-uniform stream; "
            "both (seed, chrom, slot, chunk)-pinned",
        )
        p.add_argument(
            "--perm-form",
            choices=["broadcast", "matmul"],
            default="broadcast",
            help="arithmetic form of the xla chunk evaluator (identical "
            "permutations; bench-mc inloop A/B decides per hardware)",
        )
        p.add_argument(
            "--mc-stream",
            choices=["shared", "window"],
            default="shared",
            help="permutation-stream design: shared = one genome-wide label "
            "permutation per draw, shared by all windows (Westfall-Young "
            "setup; one matmul per chunk, batch/shard/resume-invariant "
            "by construction); window = independent per-window streams "
            "(round-3 design, required by --perm-backend native)",
        )

    p = sub.add_parser("run-css", help="windowed Cluster Separation Score scan")
    _add_run_common(p)
    _add_css_args(p)
    p.set_defaults(fn=cmd_run_css)

    p = sub.add_parser(
        "run-all",
        help="whole pipeline in one process: run-fet + run-css + both "
        "region callers + HTML report (per-process constants and "
        "the genotype upload are paid once; outputs byte-identical to "
        "the staged subcommands)",
    )
    _add_run_common(p, with_out=False)
    p.add_argument(
        "--outdir", required=True,
        help="output directory: fet.track, css.track, fet_regions.gtrack, "
        "css_regions.gtrack, report.html, *_summary.json",
    )
    _add_fet_args(p)
    _add_css_args(p)
    p.add_argument("--max-distance", type=int, default=100_000)
    p.add_argument("--norm-quantile", type=float, default=0.999)
    p.add_argument("--stddev-percentile", type=float, default=75.0)
    p.add_argument("--mode", choices=["fdr", "top"], default="fdr")
    p.add_argument("--fdr", type=float, default=0.05)
    p.add_argument("--num-top", type=int, default=100)
    p.add_argument("--title", default="divergence_tpu run report")
    p.set_defaults(fn=cmd_run_all)

    p = sub.add_parser(
        "report", help="self-contained HTML summary of score tracks/regions"
    )
    p.add_argument("--fet-track", default=None)
    p.add_argument("--css-track", default=None)
    p.add_argument("--fet-regions", default=None)
    p.add_argument("--css-regions", default=None)
    p.add_argument("--run-summary", default=None, help="run-summary JSON file")
    p.add_argument("--out", required=True)
    p.add_argument("--title", default="divergence_tpu run report")
    p.set_defaults(fn=_cmd_report)

    p = sub.add_parser(
        "bench-scaling",
        help="weak+strong scaling of the sharded step over 1..N devices",
    )
    p.add_argument("--devices", type=int, default=None)
    p.add_argument("--windows-per-device", type=int, default=256)
    p.add_argument("--total-windows", type=int, default=None)
    p.add_argument("--mc-chunk", type=int, default=128)
    p.set_defaults(fn=_cmd_bench_scaling)

    p = sub.add_parser(
        "bench-mc",
        help="permutation-MC chunk throughput: evaluator A/B (in-loop window-stream vs shared-stream, native host row)",
    )
    p.add_argument("--window-batch", type=int, default=1024)
    p.add_argument("--chunk", type=int, default=256)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--backends", default="inloop,inloop_shared")
    p.set_defaults(fn=_cmd_bench_mc)

    p = sub.add_parser(
        "doctor",
        help="environment diagnostics: devices, card, caches, native",
    )
    p.set_defaults(fn=_cmd_doctor)

    p = sub.add_parser(
        "merge-tracks",
        help="merge per-host score-track shards (disjoint chromosomes "
        "or slot ranges; duplicate windows are refused)",
    )
    p.add_argument("--inputs", nargs="+", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=_cmd_merge_tracks)

    p = sub.add_parser("filter-fet", help="FET region calling (Burke limit)")
    p.add_argument("--scores", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--max-distance", type=int, default=100_000)
    p.add_argument("--norm-quantile", type=float, default=0.999)
    p.add_argument("--stddev-percentile", type=float, default=75.0)
    p.add_argument("--chrom-sizes", default=None)
    p.set_defaults(fn=cmd_filter_fet)

    p = sub.add_parser(
        "call-css-regions", help="CSS region calling (BH-FDR / top-N)"
    )
    p.add_argument("--scores", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--mode", choices=["fdr", "top"], default="fdr")
    p.add_argument("--fdr", type=float, default=0.05)
    p.add_argument("--num-top", type=int, default=100)
    p.add_argument("--window-size", type=int, default=2500)
    p.add_argument("--chrom-sizes", default=None)
    p.set_defaults(fn=cmd_call_css_regions)

    return ap


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
