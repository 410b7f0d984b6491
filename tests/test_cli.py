"""End-to-end CLI pipeline test: convert-vcf → run-fet/run-css →
filter-fet / call-css-regions (the reference's five GUI tools as one flow,
SURVEY.md §3.1-3.4)."""

import json

import numpy as np
import pytest

from divergence_tpu.tools.cli import main as cli_main


@pytest.fixture(scope="module")
def toy_vcf(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(17)
    anames = [f"A{i}" for i in range(6)]
    bnames = [f"B{i}" for i in range(5)]
    names = anames + bnames
    pos = np.sort(rng.choice(np.arange(100, 20_000), 250, replace=False))
    lines = [
        "##fileformat=VCFv4.2",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        + "\t".join(names),
    ]
    for p in pos:
        div = rng.random() < 0.25
        gts = []
        for i in range(len(names)):
            pa = 0.9 if (div and i < 6) else 0.35
            r = rng.random()
            if r < 0.02:
                g = "./."
            elif r < pa:
                g = "0/0"
            elif r < pa + 0.2:
                g = "0/1"
            else:
                g = "1/1"
            gts.append(g)
        lines.append(f"chrT\t{p}\t.\tA\tT\t50\tPASS\t.\tGT\t" + "\t".join(gts))
    vcf = tmp / "toy.vcf"
    vcf.write_text("\n".join(lines) + "\n")
    sizes = tmp / "chrom.sizes"
    sizes.write_text("chrT\t20000\n")
    # Produce the shared artifacts (popA/popB gtracks, baseline fet/css
    # tracks) at FIXTURE scope so every test is standalone-runnable —
    # several tests compare against tmp/fet.track etc., and depending on
    # test_cli_full_pipeline having run first broke any -k selection or
    # reordering (round-5 review finding).  test_cli_full_pipeline
    # re-runs the same commands; outputs are byte-identical overwrites.
    cli_main(
        [
            "convert-vcf", "--vcf", str(vcf),
            "--population", ",".join(anames),
            "--out", str(tmp / "popA.gtrack"), "--genome", "toy",
        ]
    )
    cli_main(
        [
            "convert-vcf", "--vcf", str(vcf),
            "--population", ",".join(bnames),
            "--out", str(tmp / "popB.gtrack"),
        ]
    )
    cli_main(
        [
            "run-fet", "--pop-a", str(tmp / "popA.gtrack"),
            "--pop-b", str(tmp / "popB.gtrack"),
            "--out", str(tmp / "fet.track"), "--chrom-sizes", str(sizes),
        ]
    )
    cli_main(
        [
            "run-css", "--pop-a", str(tmp / "popA.gtrack"),
            "--pop-b", str(tmp / "popB.gtrack"),
            "--out", str(tmp / "css.track"), "--chrom-sizes", str(sizes),
            "--mc-runs", "2000", "--mc-chunk", "512",
        ]
    )
    return tmp, vcf, sizes, anames, bnames


def test_cli_full_pipeline(toy_vcf, capsys):
    tmp, vcf, sizes, anames, bnames = toy_vcf

    cli_main(
        [
            "convert-vcf",
            "--vcf", str(vcf),
            "--population", ",".join(anames),
            "--out", str(tmp / "popA.gtrack"),
            "--genome", "toy",
        ]
    )
    cli_main(
        [
            "convert-vcf",
            "--vcf", str(vcf),
            "--population", ",".join(bnames),
            "--out", str(tmp / "popB.gtrack"),
        ]
    )

    cli_main(
        [
            "run-fet",
            "--pop-a", str(tmp / "popA.gtrack"),
            "--pop-b", str(tmp / "popB.gtrack"),
            "--out", str(tmp / "fet.track"),
            "--chrom-sizes", str(sizes),
            "--summary", str(tmp / "fet_summary.json"),
        ]
    )
    fet_lines = [
        ln
        for ln in (tmp / "fet.track").read_text().splitlines()
        if not ln.startswith("#")
    ]
    assert len(fet_lines) > 10
    summary = json.loads((tmp / "fet_summary.json").read_text())
    assert summary["counters"]["windows_planned"] > 0

    cli_main(
        [
            "run-css",
            "--pop-a", str(tmp / "popA.gtrack"),
            "--pop-b", str(tmp / "popB.gtrack"),
            "--out", str(tmp / "css.track"),
            "--chrom-sizes", str(sizes),
            "--mc-runs", "2000",
            "--mc-chunk", "512",
        ]
    )
    css_lines = [
        ln
        for ln in (tmp / "css.track").read_text().splitlines()
        if not ln.startswith("#")
    ]
    assert len(css_lines) > 10

    cli_main(
        [
            "filter-fet",
            "--scores", str(tmp / "fet.track"),
            "--out", str(tmp / "fet_regions.gtrack"),
            "--max-distance", "2000",
            "--chrom-sizes", str(sizes),
        ]
    )
    out = capsys.readouterr().out
    stats_line = json.loads(out.strip().splitlines()[-1])
    assert "limit" in stats_line

    cli_main(
        [
            "call-css-regions",
            "--scores", str(tmp / "css.track"),
            "--out", str(tmp / "css_regions.gtrack"),
            "--mode", "top",
            "--num-top", "10",
            "--chrom-sizes", str(sizes),
        ]
    )
    seg_lines = [
        ln
        for ln in (tmp / "css_regions.gtrack").read_text().splitlines()
        if not ln.startswith("#")
    ]
    assert len(seg_lines) >= 1
    for ln in seg_lines:
        seqid, start, end = ln.split("\t")
        assert seqid == "chrT"
        assert 0 <= int(start) < int(end) <= 19_999


def test_cli_sharded_matches_unsharded(toy_vcf):
    tmp, vcf, sizes, anames, bnames = toy_vcf
    cli_main(
        [
            "run-fet",
            "--pop-a", str(tmp / "popA.gtrack"),
            "--pop-b", str(tmp / "popB.gtrack"),
            "--out", str(tmp / "fet_sharded.track"),
            "--chrom-sizes", str(sizes),
            "--shard",
        ]
    )
    base = (tmp / "fet.track").read_text()
    sharded = (tmp / "fet_sharded.track").read_text()
    assert base == sharded


def test_cli_native_backend_matches_xla(toy_vcf):
    """--perm-backend native writes a byte-identical CSS track (same
    fold_in-pinned stream, native/mc_native.cpp); skips without g++.

    Generates its own xla baseline so the test is order-independent."""
    from divergence_tpu.native import native_available

    if not native_available():
        pytest.skip("native toolchain unavailable")
    tmp, vcf, sizes, anames, bnames = toy_vcf
    common = [
        "run-css",
        "--pop-a", str(tmp / "popA.gtrack"),
        "--pop-b", str(tmp / "popB.gtrack"),
        "--chrom-sizes", str(sizes),
        "--mc-runs", "2000",
        "--mc-chunk", "512",
        # native replays the per-WINDOW stream; pin the xla side to it
        "--mc-stream", "window",
    ]
    cli_main(common + ["--out", str(tmp / "css_xla_base.track")])
    cli_main(
        common
        + [
            "--out", str(tmp / "css_native.track"),
            "--perm-backend", "native",
        ]
    )
    assert (tmp / "css_xla_base.track").read_text() == (
        tmp / "css_native.track"
    ).read_text()


def test_cli_multihost_partition(toy_vcf):
    tmp, vcf, sizes, anames, bnames = toy_vcf
    # single chromosome, 2 hosts: host 0 gets it, host 1 writes empty track
    cli_main(
        [
            "run-fet",
            "--pop-a", str(tmp / "popA.gtrack"),
            "--pop-b", str(tmp / "popB.gtrack"),
            "--out", str(tmp / "fet_h0.track"),
            "--chrom-sizes", str(sizes),
            "--num-hosts", "2",
            "--host-id", "0",
        ]
    )
    cli_main(
        [
            "run-fet",
            "--pop-a", str(tmp / "popA.gtrack"),
            "--pop-b", str(tmp / "popB.gtrack"),
            "--out", str(tmp / "fet_h1.track"),
            "--chrom-sizes", str(sizes),
            "--num-hosts", "2",
            "--host-id", "1",
        ]
    )
    h0 = [
        ln
        for ln in (tmp / "fet_h0.track").read_text().splitlines()
        if not ln.startswith("#")
    ]
    h1 = [
        ln
        for ln in (tmp / "fet_h1.track").read_text().splitlines()
        if not ln.startswith("#")
    ]
    base = [
        ln
        for ln in (tmp / "fet.track").read_text().splitlines()
        if not ln.startswith("#")
    ]
    assert sorted(h0 + h1) == sorted(base)


def test_convert_snp_table(tmp_path):
    table = tmp_path / "snps.tsv"
    table.write_text(
        "#seqid\tpos\tallele1\tallele2\tfish0\tfish1\tfish2\n"
        "chrI\t100\tA\tG\tAA\tAG\tGG\n"
        "chrI\t200\tC\tT\tCC\tNN\tTC\n"
    )
    cli_main(
        [
            "convert-snp-table",
            "--table", str(table),
            "--ids", "fish0,fish1,fish2",
            "--out", str(tmp_path / "out.gtrack"),
        ]
    )
    rows = [
        ln
        for ln in (tmp_path / "out.gtrack").read_text().splitlines()
        if ln and not ln.startswith("#")
    ]
    assert rows == [
        "chrI\t100\t3\tfish0",
        "chrI\t100\t0\tfish1",
        "chrI\t100\t-3\tfish2",
        "chrI\t200\t3\tfish0",
        "chrI\t200\t-10000\tfish1",
        "chrI\t200\t0\tfish2",
    ]


def test_cli_resume_parts(toy_vcf):
    tmp, vcf, sizes, anames, bnames = toy_vcf
    args = [
        "run-fet",
        "--pop-a", str(tmp / "popA.gtrack"),
        "--pop-b", str(tmp / "popB.gtrack"),
        "--out", str(tmp / "fet_resume.track"),
        "--chrom-sizes", str(sizes),
        "--resume",
    ]
    cli_main(args)
    first = (tmp / "fet_resume.track").read_text()
    part = tmp / "fet_resume.track.parts" / "chrT.tsv"
    assert part.exists()
    # second run resumes from the part file and reproduces the output
    cli_main(args)
    assert (tmp / "fet_resume.track").read_text() == first
    # identical to a non-resume run
    assert first == (tmp / "fet.track").read_text()


def test_cli_drosophila_mode(tmp_path):
    """Frequency-track (drosophila) mode through the CLI: one pseudo-
    individual per population, values = minor-allele frequencies."""
    rng = np.random.default_rng(23)
    pos = np.sort(rng.choice(np.arange(100, 10_000), 150, replace=False))
    for name, seed in (("freqA", 1), (("freqB"), 2)):
        r = np.random.default_rng(seed)
        with open(tmp_path / f"{name}.gtrack", "w") as fh:
            fh.write("###seqid\tstart\tvalue\tgenomeid\n")
            for p in pos:
                fh.write(f"chrT\t{p}\t{r.uniform():.4f}\tpop\n")
    (tmp_path / "chrom.sizes").write_text("chrT\t10000\n")
    cli_main(
        [
            "run-css",
            "--pop-a", str(tmp_path / "freqA.gtrack"),
            "--pop-b", str(tmp_path / "freqB.gtrack"),
            "--out", str(tmp_path / "css_dros.track"),
            "--chrom-sizes", str(tmp_path / "chrom.sizes"),
            "--drosophila",
            "--mc-runs", "500",
        ]
    )
    rows = [
        ln.split("\t")
        for ln in (tmp_path / "css_dros.track").read_text().splitlines()
        if ln and not ln.startswith("#")
    ]
    assert len(rows) > 5
    # reference quirk: p == 1 for every scored window in drosophila mode
    assert all(float(r[3]) == 1.0 for r in rows)


def test_cli_report(toy_vcf, tmp_path):
    tmp, vcf, sizes, anames, bnames = toy_vcf
    out = tmp_path / "report.html"
    cli_main(
        [
            "report",
            "--fet-track", str(tmp / "fet.track"),
            "--css-track", str(tmp / "css.track"),
            "--out", str(out),
        ]
    )
    doc = out.read_text()
    assert "<html>" in doc
    assert "FET score track" in doc and "CSS score track" in doc
    assert "Top 20 windows" in doc
    assert "chrT" in doc


def test_cli_multi_chromosome_genome(tmp_path):
    """>1 chromosome triggers the genome-wide engine path; the output
    track must contain every chromosome with plausible rows."""
    rng = np.random.default_rng(31)
    with open(tmp_path / "a.gtrack", "w") as fa, open(
        tmp_path / "b.gtrack", "w"
    ) as fb:
        for fh in (fa, fb):
            fh.write("###seqid\tstart\tvalue\tgenomeid\n")
        for chrom in ("chr1", "chr2"):
            pos = np.sort(
                rng.choice(np.arange(100, 12_000), 120, replace=False)
            )
            for fh, size in ((fa, 4), (fb, 3)):
                for p in pos:
                    for i in range(size):
                        v = rng.choice([3, -3, 0])
                        fh.write(f"{chrom}\t{p}\t{v}\tind{i}\n")
    (tmp_path / "chrom.sizes").write_text("chr1\t12000\nchr2\t12000\n")
    cli_main(
        [
            "run-fet",
            "--pop-a", str(tmp_path / "a.gtrack"),
            "--pop-b", str(tmp_path / "b.gtrack"),
            "--out", str(tmp_path / "fet.track"),
            "--chrom-sizes", str(tmp_path / "chrom.sizes"),
            "--summary", str(tmp_path / "s.json"),
        ]
    )
    rows = [
        ln.split("\t")
        for ln in (tmp_path / "fet.track").read_text().splitlines()
        if ln and not ln.startswith("#")
    ]
    seqs = {r[0] for r in rows}
    assert seqs == {"chr1", "chr2"}
    summary = json.loads((tmp_path / "s.json").read_text())
    assert summary["counters"]["windows_planned"] > 30
    cli_main(
        [
            "run-css",
            "--pop-a", str(tmp_path / "a.gtrack"),
            "--pop-b", str(tmp_path / "b.gtrack"),
            "--out", str(tmp_path / "css.track"),
            "--chrom-sizes", str(tmp_path / "chrom.sizes"),
            "--mc-runs", "300",
        ]
    )
    rows = [
        ln.split("\t")
        for ln in (tmp_path / "css.track").read_text().splitlines()
        if ln and not ln.startswith("#")
    ]
    assert {r[0] for r in rows} == {"chr1", "chr2"}

    # multi-host fan-out: each host runs its chromosome partition, then
    # merge-tracks reassembles the genome-wide track bit-for-bit
    for host in (0, 1):
        cli_main(
            [
                "run-fet",
                "--pop-a", str(tmp_path / "a.gtrack"),
                "--pop-b", str(tmp_path / "b.gtrack"),
                "--out", str(tmp_path / f"fet_h{host}.track"),
                "--chrom-sizes", str(tmp_path / "chrom.sizes"),
                "--num-hosts", "2",
                "--host-id", str(host),
            ]
        )
    cli_main(
        [
            "merge-tracks",
            "--inputs",
            str(tmp_path / "fet_h0.track"),
            str(tmp_path / "fet_h1.track"),
            "--out", str(tmp_path / "fet_merged.track"),
        ]
    )
    merged = (tmp_path / "fet_merged.track").read_text()
    single = (tmp_path / "fet.track").read_text()
    assert sorted(merged.splitlines()[1:]) == sorted(single.splitlines()[1:])
    with pytest.raises(SystemExit, match="appears in both"):
        cli_main(
            [
                "merge-tracks",
                "--inputs",
                str(tmp_path / "fet_h0.track"),
                str(tmp_path / "fet_h0.track"),
                "--out", str(tmp_path / "bad.track"),
            ]
        )

    # the per-chromosome loop (--resume) and the genome-wide engine must
    # write identical tracks — RNG streams are (seed, chrom, slot)-pinned
    # so the CSS MC p-values agree bit-for-bit across the two paths
    cli_main(
        [
            "run-css",
            "--pop-a", str(tmp_path / "a.gtrack"),
            "--pop-b", str(tmp_path / "b.gtrack"),
            "--out", str(tmp_path / "css_resume.track"),
            "--chrom-sizes", str(tmp_path / "chrom.sizes"),
            "--mc-runs", "300",
            "--resume",
        ]
    )
    assert (tmp_path / "css_resume.track").read_text() == (
        tmp_path / "css.track"
    ).read_text()


def test_cli_partial_resume_uses_fused_genome_path(tmp_path):
    """A resumed genome run must keep the fused genome-wide dispatch for
    the REMAINING chromosomes (--resume used to fall back to the
    per-chromosome dispatch loop) and reproduce the
    fresh run's track byte-for-byte ((chrom, slot)-pinned streams)."""
    rng = np.random.default_rng(41)
    with open(tmp_path / "a.gtrack", "w") as fa, open(
        tmp_path / "b.gtrack", "w"
    ) as fb:
        for fh in (fa, fb):
            fh.write("###seqid\tstart\tvalue\tgenomeid\n")
        for chrom in ("chr1", "chr2", "chr3"):
            pos = np.sort(
                rng.choice(np.arange(100, 12_000), 100, replace=False)
            )
            for fh, size in ((fa, 4), (fb, 3)):
                for p in pos:
                    for i in range(size):
                        v = rng.choice([3, -3, 0])
                        fh.write(f"{chrom}\t{p}\t{v}\tind{i}\n")
    (tmp_path / "chrom.sizes").write_text(
        "chr1\t12000\nchr2\t12000\nchr3\t12000\n"
    )
    common = [
        "run-css",
        "--pop-a", str(tmp_path / "a.gtrack"),
        "--pop-b", str(tmp_path / "b.gtrack"),
        "--chrom-sizes", str(tmp_path / "chrom.sizes"),
        "--mc-runs", "300",
    ]
    # fresh genome-wide run (no resume) = the reference output
    cli_main(common + ["--out", str(tmp_path / "css_fresh.track")])
    fresh = (tmp_path / "css_fresh.track").read_text()

    # run with --resume (writes part files), then simulate a crash:
    # drop the output and one chromosome's part, resume
    out = tmp_path / "css_resume.track"
    cli_main(common + ["--out", str(out), "--resume"])
    assert out.read_text() == fresh
    parts = out.parent / (out.name + ".parts")
    assert sorted(p.name for p in parts.iterdir()) == [
        "chr1.tsv", "chr2.tsv", "chr3.tsv",
    ]
    out.unlink()
    (parts / "chr2.tsv").unlink()
    cli_main(
        common
        + [
            "--out", str(out), "--resume",
            "--summary", str(tmp_path / "resume_summary.json"),
        ]
    )
    assert out.read_text() == fresh
    # the resumed run must NOT have fallen back to the per-chromosome
    # loop... with only one chromosome missing the single-engine path is
    # fine, so exercise the fused path with TWO missing parts too
    out.unlink()
    (parts / "chr1.tsv").unlink()
    (parts / "chr3.tsv").unlink()
    cli_main(
        common
        + [
            "--out", str(out), "--resume",
            "--summary", str(tmp_path / "resume2_summary.json"),
        ]
    )
    assert out.read_text() == fresh
    s2 = json.loads((tmp_path / "resume2_summary.json").read_text())
    assert "genome" in s2["timings_s"]      # fused genome-wide dispatch


def test_cli_slot_range_partitioning_one_chromosome(toy_vcf):
    """--num-hosts 2 on a ONE-chromosome
    genome splits it into slot ranges (each host evaluates only its half
    of the windows — nonzero rows on BOTH hosts, disjoint, in the right
    slot halves) and merge-tracks reassembles a track byte-identical to
    the single-host run.  Covers both engines; the CSS side additionally
    pins the genome-wide MC's partition invariance under a slot split."""
    tmp, vcf, sizes, anames, bnames = toy_vcf
    nslots = 20_000 // 500

    for sub, extra, out in (
        ("run-fet", [], "sr_fet"),
        ("run-css", ["--mc-runs", "400"], "sr_css"),
    ):
        common = [
            sub,
            "--pop-a", str(tmp / "popA.gtrack"),
            "--pop-b", str(tmp / "popB.gtrack"),
            "--chrom-sizes", str(sizes),
        ] + extra
        cli_main(common + ["--out", str(tmp / f"{out}_single.track")])
        for host in (0, 1):
            cli_main(
                common
                + [
                    "--out", str(tmp / f"{out}_h{host}.track"),
                    "--num-hosts", "2",
                    "--host-id", str(host),
                ]
            )
        cli_main(
            [
                "merge-tracks",
                "--inputs",
                str(tmp / f"{out}_h0.track"),
                str(tmp / f"{out}_h1.track"),
                "--out", str(tmp / f"{out}_merged.track"),
            ]
        )

        def rows(name):
            return [
                ln
                for ln in (tmp / name).read_text().splitlines()
                if ln and not ln.startswith("#")
            ]

        h0, h1 = rows(f"{out}_h0.track"), rows(f"{out}_h1.track")
        # both hosts did real work, each strictly inside its slot half
        assert h0 and h1
        cut = nslots // 2 * 500
        assert all(int(ln.split("\t")[1]) < cut for ln in h0)
        assert all(int(ln.split("\t")[1]) >= cut for ln in h1)
        # byte-identical reassembly (headers + rows + row order)
        assert (tmp / f"{out}_merged.track").read_text() == (
            tmp / f"{out}_single.track"
        ).read_text()


def test_partition_chromosomes_slot_ranges():
    """Slot-granular partitioning: ranges are disjoint, cover every
    slot, and balance a one-chromosome genome across hosts."""
    from divergence_tpu.parallel import partition_chromosomes

    weights = {"big": 10_000, "small": 400}
    nslots = {"big": 100, "small": 7}
    got = {}
    for h in range(4):
        a = partition_chromosomes(weights, 4, h, seqid_nslots=nslots)
        assert a.process_id == h
        for r in a.ranges:
            got.setdefault(r.seqid, []).append((r.slot_lo, r.slot_hi))
    # union covers [0, nslots) exactly, no overlap
    for seqid, n in nslots.items():
        ivs = sorted(got[seqid])
        assert ivs[0][0] == 0
        for (al, ah), (bl, bh) in zip(ivs, ivs[1:]):
            assert ah == bl
        assert ivs[-1][1] >= n
    # the big chromosome was actually split
    assert len(got["big"]) == 4
    # at most ONE merged range per chromosome per host — the engines'
    # slot_ranges dict cannot represent more, and an unconstrained
    # greedy assignment DID produce two non-adjacent ranges for one
    # host, silently dropping the first range's windows (round-5
    # review finding; repro: 3 hosts over weights {20, 2, 7})
    w2 = {"chrA": 20, "chrY": 2, "chrX": 7}
    n2 = {"chrA": 1000, "chrY": 300, "chrX": 100}
    cov = {}
    for h in range(3):
        a = partition_chromosomes(w2, 3, h, seqid_nslots=n2)
        per = {}
        for r in a.ranges:
            per.setdefault(r.seqid, []).append((r.slot_lo, r.slot_hi))
            cov.setdefault(r.seqid, []).append((r.slot_lo, r.slot_hi))
        assert all(len(v) == 1 for v in per.values()), (h, per)
    for seqid, n in n2.items():
        ivs = sorted(cov[seqid])
        assert ivs[0][0] == 0 and ivs[-1][1] >= n
        for (al, ah), (bl, bh) in zip(ivs, ivs[1:]):
            assert ah == bl
    # chromosome-granular mode unchanged (no nslots)
    a0 = partition_chromosomes(weights, 2, 0)
    a1 = partition_chromosomes(weights, 2, 1)
    assert {s for s in a0.seqids} | {s for s in a1.seqids} == set(weights)
    assert not (set(a0.seqids) & set(a1.seqids))


def test_run_all_matches_staged_pipeline(toy_vcf, tmp_path):
    """run-all (one process, one genome load/upload) writes tracks,
    region calls, and report byte-identical to the staged subcommands
    (RNG streams are (seed, chrom, slot)-pinned)."""
    tmp, vcf, sizes, anames, bnames = toy_vcf
    outdir = tmp_path / "all"
    combined = tmp_path / "combined_summary.json"
    cli_main(
        [
            "run-all",
            "--pop-a", str(tmp / "popA.gtrack"),
            "--pop-b", str(tmp / "popB.gtrack"),
            "--outdir", str(outdir),
            "--chrom-sizes", str(sizes),
            "--mc-runs", "400",
            "--summary", str(combined),
        ]
    )
    # --summary was silently discarded before round 5's review fixes;
    # it now carries both engines' summaries
    import json

    merged = json.loads(combined.read_text())
    assert set(merged) == {"fet", "css"}
    assert merged["fet"]["counters"]["windows_planned"] > 0
    assert merged["css"]["counters"]["mc_permutations"] > 0
    # staged equivalents (fet.track/css.track exist from the pipeline
    # test; regenerate the region calls + report from those tracks)
    staged = tmp_path / "staged"
    staged.mkdir()
    cli_main(
        [
            "filter-fet", "--scores", str(tmp / "fet.track"),
            "--out", str(staged / "fet_regions.gtrack"),
            "--chrom-sizes", str(sizes),
        ]
    )
    # the staged css track was produced with default mc-runs; rerun the
    # engine track with the same mc-runs as run-all for comparability
    cli_main(
        [
            "run-css",
            "--pop-a", str(tmp / "popA.gtrack"),
            "--pop-b", str(tmp / "popB.gtrack"),
            "--out", str(staged / "css.track"),
            "--chrom-sizes", str(sizes),
            "--mc-runs", "400",
        ]
    )
    cli_main(
        [
            "call-css-regions", "--scores", str(staged / "css.track"),
            "--out", str(staged / "css_regions.gtrack"),
            "--chrom-sizes", str(sizes),
        ]
    )
    assert (outdir / "fet.track").read_text() == (
        tmp / "fet.track"
    ).read_text()
    assert (outdir / "css.track").read_text() == (
        staged / "css.track"
    ).read_text()
    assert (outdir / "fet_regions.gtrack").read_text() == (
        staged / "fet_regions.gtrack"
    ).read_text()
    assert (outdir / "css_regions.gtrack").read_text() == (
        staged / "css_regions.gtrack"
    ).read_text()
    html = (outdir / "report.html").read_text()
    assert "<html" in html and "chrT" in html
    assert (outdir / "fet_summary.json").exists()
    assert (outdir / "css_summary.json").exists()


def test_run_all_sharded_matches_unsharded(toy_vcf, tmp_path):
    """run-all composes with --shard (window-axis GSPMD over the virtual
    mesh): the sharding is passed once through the preloaded tuple and
    both engines' tracks stay byte-identical (slot-pinned RNG)."""
    tmp, vcf, sizes, anames, bnames = toy_vcf
    outs = {}
    for name, extra in (("plain", []), ("sharded", ["--shard"])):
        outdir = tmp_path / name
        cli_main(
            [
                "run-all",
                "--pop-a", str(tmp / "popA.gtrack"),
                "--pop-b", str(tmp / "popB.gtrack"),
                "--outdir", str(outdir),
                "--chrom-sizes", str(sizes),
                "--mc-runs", "400",
                *extra,
            ]
        )
        outs[name] = outdir
    for f in ("fet.track", "css.track", "fet_regions.gtrack",
              "css_regions.gtrack"):
        assert (outs["plain"] / f).read_text() == (
            outs["sharded"] / f
        ).read_text(), f


def test_run_all_resume_parts(toy_vcf, tmp_path):
    """--resume composes with run-all: each engine keeps its own
    .parts directory under the outdir, a rerun resumes from both, and
    the outputs stay byte-identical to the first run."""
    tmp, vcf, sizes, anames, bnames = toy_vcf
    outdir = tmp_path / "resall"
    args = [
        "run-all",
        "--pop-a", str(tmp / "popA.gtrack"),
        "--pop-b", str(tmp / "popB.gtrack"),
        "--outdir", str(outdir),
        "--chrom-sizes", str(sizes),
        "--mc-runs", "400",
        "--resume",
    ]
    cli_main(args)
    first = {f: (outdir / f).read_text()
             for f in ("fet.track", "css.track", "css_regions.gtrack")}
    assert (outdir / "fet.track.parts" / "chrT.tsv").exists()
    assert (outdir / "css.track.parts" / "chrT.tsv").exists()
    cli_main(args)
    for f, body in first.items():
        assert (outdir / f).read_text() == body, f


def test_run_all_multihost_shards_skip_region_calling(toy_vcf, tmp_path):
    """run-all under --num-hosts writes track shards ONLY: region
    thresholds (Burke median, BH-FDR rank) are genome-wide statistics,
    so calling them per-shard would be silently wrong.  Merged shards
    equal the single-host run-all tracks."""
    tmp, vcf, sizes, anames, bnames = toy_vcf
    single = tmp_path / "single"
    cli_main(
        [
            "run-all",
            "--pop-a", str(tmp / "popA.gtrack"),
            "--pop-b", str(tmp / "popB.gtrack"),
            "--outdir", str(single),
            "--chrom-sizes", str(sizes),
            "--mc-runs", "400",
        ]
    )
    shard_dirs = []
    for h in range(2):
        d = tmp_path / f"host{h}"
        cli_main(
            [
                "run-all",
                "--pop-a", str(tmp / "popA.gtrack"),
                "--pop-b", str(tmp / "popB.gtrack"),
                "--outdir", str(d),
                "--chrom-sizes", str(sizes),
                "--mc-runs", "400",
                "--num-hosts", "2", "--host-id", str(h),
            ]
        )
        # shards only — no region calls or report on partial data
        assert not (d / "fet_regions.gtrack").exists()
        assert not (d / "css_regions.gtrack").exists()
        assert not (d / "report.html").exists()
        shard_dirs.append(d)
    for f in ("fet.track", "css.track"):
        merged = tmp_path / f"merged_{f}"
        cli_main(
            [
                "merge-tracks",
                "--inputs", str(shard_dirs[0] / f), str(shard_dirs[1] / f),
                "--out", str(merged),
            ]
        )
        assert merged.read_text() == (single / f).read_text(), f
