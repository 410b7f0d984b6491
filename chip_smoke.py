"""Chip smoke test: the FET/CSS pipeline once on a GPU, at genome scale.

Usage, from the repository root:

    python chip_smoke.py            # phases 1-5 on one GPU
    python chip_smoke.py --multi    # phase 6 only: --shard on 4 GPUs

Phases (each one raises on failure; nothing is caught):

1. Device: JAX must see GPU devices; prints the card's name and power
   limit as ``nvidia-smi`` reports them.
2. Genome: the README's genome-scale run (``examples/genome_demo.py``'s
   generator with its defaults: 5 chromosomes x 200k SNPs x 10 Mbp, the
   11+10 stickleback panel, 2% of windows in divergent 25 kb blocks)
   through ``run-all`` twice, ``--precision fast`` and ``--precision
   exact``, with per-stage times.
3. Parity: 64 windows spread over the genome against the oracle
   (``window_fet`` / ``window_css``), and no NaN in any track column.
4. Stochastic columns: one chromosome cut to 20k SNPs through
   ``run_fet`` / ``run_css`` on the GPU and on the CPU in this process.
5. Large panel: 20k SNPs with 110+90 individuals (m = 200) through
   ``run-fet`` / ``run-css`` in both precisions, three windows against
   the oracle.
6. ``--multi``: ``run-all --shard`` over 4 GPUs against ``run-all`` on
   GPU 0 alone over the phase-2 genome; the tracks must be
   byte-identical (docs/PARITY.md "Stream identity").

The last line of standard output is one JSON object with ``"ok": true``
and the device as JAX reports it; a failed phase exits non-zero before
that line is printed.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

import jax

ROOT = Path(__file__).resolve().parent
WORK = ROOT / ".smoke_work"
WSIZE, WSTEP = 2500, 500
CARD = "unknown card"


def log(msg: str) -> None:
    print(msg, flush=True)


def log_time(label: str, seconds: float) -> None:
    """Every printed time carries the card it was taken on."""
    log(f"  {label}: {seconds:.3f} s  [{CARD}]")


# ------------------------------------------------------------- phase 1
def phase_device(n_expected: int) -> list:
    global CARD
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found {devs[0].platform!r} devices, not a GPU"
        )
    if len(devs) < n_expected:
        raise SystemExit(
            f"chip_smoke: needs {n_expected} GPUs, JAX found {len(devs)}"
        )
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    cards = r.stdout.strip().splitlines()
    CARD = cards[0].strip()
    log(f"[phase 1] devices: {len(devs)} x {devs[0].device_kind}")
    log(f"[phase 1] nvidia-smi name, power.limit: {'; '.join(cards)}")
    return devs


# ------------------------------------------------------------- phase 2
def make_genome(workdir: Path, **kwargs) -> Path:
    """The README's genome, written by examples/genome_demo.py."""
    sys.path.insert(0, str(ROOT / "examples"))
    from genome_demo import generate_genome

    workdir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    n_blocks = generate_genome(workdir, **kwargs)
    log(f"[phase 2] genome written ({n_blocks} divergent 25 kb blocks)")
    log_time("generate", time.perf_counter() - t0)
    return workdir


def cli_run(argv: list[str]) -> float:
    from divergence_tpu.tools.cli import main as cli

    t0 = time.perf_counter()
    cli(argv)
    return time.perf_counter() - t0


def run_all(genome: Path, outdir: Path, precision: str,
            shard: bool = False) -> float:
    argv = [
        "run-all", "--pop-a", str(genome / "popA.gtrack"),
        "--pop-b", str(genome / "popB.gtrack"),
        "--chrom-sizes", str(genome / "chrom.sizes"),
        "--outdir", str(outdir), "--precision", precision,
    ]
    return cli_run(argv + (["--shard"] if shard else []))


def print_stages(outdir: Path) -> None:
    for name in ("fet", "css"):
        s = json.loads((outdir / f"{name}_summary.json").read_text())
        for stage, sec in s["timings_s"].items():
            log_time(f"{name}.{stage}", sec)


def phase_genome(genome: Path) -> dict[str, Path]:
    outs = {}
    for precision in ("fast", "exact"):
        out = WORK / f"run_all_{precision}"
        wall = run_all(genome, out, precision)
        log(f"[phase 2] run-all --precision {precision}")
        log_time("run-all wall", wall)
        print_stages(out)
        outs[precision] = out
    return outs


# ------------------------------------------------------------- phase 3
def load_pairs(genome: Path) -> dict:
    from divergence_tpu.engine.snp import SnpPair
    from divergence_tpu.io import read_gtrack_points
    from divergence_tpu.io.genome import read_chrom_sizes

    ta = read_gtrack_points(genome / "popA.gtrack")
    tb = read_gtrack_points(genome / "popB.gtrack")
    sizes = read_chrom_sizes(genome / "chrom.sizes")
    return {
        s: (SnpPair.from_tracks(ta[s], tb[s]), sizes[s]) for s in sorted(ta)
    }


def track_dict(path: Path) -> dict[tuple[str, int], tuple[float, float]]:
    """(seqid, start) -> (score, aux); fails on a NaN in either column."""
    from divergence_tpu.io import read_score_track

    seqids, starts, c2, c3 = read_score_track(path)
    n_nan = int(np.isnan(c2).sum() + np.isnan(c3).sum())
    if n_nan:
        raise AssertionError(f"{path}: {n_nan} NaN values")
    return {
        (s, int(st)): (a, b) for s, st, a, b in zip(seqids, starts, c2, c3)
    }


def spread_windows(pairs: dict, n: int) -> list[tuple[str, int, int, int]]:
    """``n`` evenly spaced non-empty windows over the genome:
    (seqid, start, lo, npos)."""
    from divergence_tpu.core.windows import plan_windows

    wins = []
    for seqid, (pair, regend) in pairs.items():
        plan = plan_windows(pair.positions, regend, WSIZE, WSTEP)
        for i in np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]:
            wins.append((seqid, int(plan.slot[i]) * WSTEP,
                         int(plan.lo[i]), int(plan.npos[i])))
    pick = np.linspace(0, len(wins) - 1, min(n, len(wins))).astype(int)
    return [wins[i] for i in pick]


# fast-mode bands are those of tests/test_engines.py::test_fast_precision_mode
TOL = {
    "exact": {"fet": (1e-9, 1e-12), "css": (1e-9, 1e-12)},
    "fast": {"fet": (2e-4, 1e-4), "css": (2e-3, 1e-4)},
}


def check_windows(pairs, wins, fet_track, css_track, tol) -> None:
    from divergence_tpu.oracle import reference as orc

    fet = track_dict(fet_track)
    css = track_dict(css_track)
    for seqid, start, lo, n in wins:
        pair = pairs[seqid][0]
        aw, bw = pair.avals[lo:lo + n], pair.bvals[lo:lo + n]
        want_f = orc.window_fet(aw, bw, 0.95, 1)[0]
        want_c = orc.window_css(aw, bw)[0]
        want_c = 0.0 if want_c < 0 else want_c     # discarded window
        got_f = fet.get((seqid, start), (0.0, 0.0))[0]
        got_c = css.get((seqid, start), (0.0, 0.0))[0]
        where = f"{seqid}:{start} ({n} SNPs)"
        if tol["fet"] is not None:
            np.testing.assert_allclose(
                got_f, want_f, rtol=tol["fet"][0], atol=tol["fet"][1],
                err_msg=f"FET score {where}",
            )
        np.testing.assert_allclose(
            got_c, want_c, rtol=tol["css"][0], atol=tol["css"][1],
            err_msg=f"CSS score {where}",
        )


def phase_parity(pairs: dict, outs: dict[str, Path]) -> None:
    wins = spread_windows(pairs, 64)
    for precision, out in outs.items():
        check_windows(pairs, wins, out / "fet.track", out / "css.track",
                      TOL[precision])
        log(f"[phase 3] {precision}: {len(wins)} windows match the oracle "
            f"(rtol fet {TOL[precision]['fet'][0]:g}, "
            f"css {TOL[precision]['css'][0]:g}); no NaN in either track")


# ------------------------------------------------------------- phase 4
def mc_tie_explains(dist: np.ndarray, score: float, cfg, asize: int,
                    bsize: int, n_perms: int) -> bool:
    """True when some permutation among the first ``n_perms`` of the
    shared MC stream scores within float32 rounding of ``score``.

    The device and the CPU each compare an f32 matmul result with the
    f32 observed score; they sum the m^2 products in different orders,
    so the two can only disagree on a hit where the exact (f64) permuted
    score lies within the worst-case f32 dot-product error bound,
    m^2 * 2^-24 * sum|D||C|, of the observed one."""
    from divergence_tpu.kernels import perm as kperm

    m = asize + bsize
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 2)
    d = dist.astype(np.float32).astype(np.float64).reshape(-1)
    s_obs = float(np.float32(score))
    with jax.default_device(jax.devices("cpu")[0]):
        for k in range(-(-n_perms // cfg.mc_chunk)):
            c = np.asarray(kperm._shared_coeff(
                key, k, m, asize, bsize, cfg.mc_chunk, cfg.rng
            ), dtype=np.float64)                       # [m*m, chunk]
            exact = d @ c
            bound = m * m * 2.0 ** -24 * (np.abs(d) @ np.abs(c))
            if np.any(np.abs(exact - s_obs) <= bound):
                return True
    return False


def phase_cpu_agreement(pairs: dict, n_snps: int = 20_000) -> None:
    from divergence_tpu.config import CssConfig, FetConfig, WindowConfig
    from divergence_tpu.engine import run_css, run_fet
    from divergence_tpu.engine.snp import SnpPair
    from divergence_tpu.core.windows import plan_windows
    from divergence_tpu.oracle import reference as orc

    seqid = sorted(pairs)[0]
    full = pairs[seqid][0]
    n = min(n_snps, full.npos)
    regend = int(full.positions[n - 1]) + 1

    def cut():
        # a fresh pair per backend: the device upload is cached on it
        return SnpPair(positions=full.positions[:n], avals=full.avals[:n],
                       bvals=full.bvals[:n])

    wcfg = WindowConfig(wsize=WSIZE, wstep=WSTEP)
    fcfg = FetConfig(window=wcfg, precision="exact")
    ccfg = CssConfig(window=wcfg, precision="exact")
    res = {}
    for name, dev in (("gpu", jax.devices()[0]), ("cpu", jax.devices("cpu")[0])):
        with jax.default_device(dev):
            pair = cut()
            t0 = time.perf_counter()
            fs, fd = run_fet(pair, regend, fcfg, seqid=seqid)
            cs, cp = run_css(pair, regend, ccfg, seqid=seqid)
            res[name] = (fs, fd, cs, cp)
        log_time(f"{name} run_fet + run_css, {n} SNPs, exact",
                 time.perf_counter() - t0)
    (gfs, gfd, gcs, gcp), (cfs, cfd, ccs, ccp) = res["gpu"], res["cpu"]
    np.testing.assert_allclose(gfs, cfs, rtol=1e-9, atol=1e-12,
                               err_msg="FET score gpu vs cpu")
    np.testing.assert_allclose(gfd, cfd, rtol=1e-9, atol=1e-12,
                               err_msg="FET stddev gpu vs cpu")
    np.testing.assert_allclose(gcs, ccs, rtol=1e-9, atol=1e-12,
                               err_msg="CSS score gpu vs cpu")

    # CSS p criterion: identical in every window, except windows where a
    # permuted score ties the observed score within f32 rounding (the
    # hit comparison may then fall either way; see mc_tie_explains)
    differ = np.nonzero(gcp != ccp)[0]
    pair = cut()
    plan = plan_windows(pair.positions, regend, WSIZE, WSTEP)
    by_slot = {int(s): i for i, s in enumerate(plan.slot)}
    unexplained = []
    for slot in differ:
        i = by_slot[int(slot)]
        lo, npos = int(plan.lo[i]), int(plan.npos[i])
        _, dist = orc.window_css(pair.avals[lo:lo + npos],
                                 pair.bvals[lo:lo + npos])
        # p = (hits+1)/(n+1) with hits <= threshold bounds the draws used
        n_used = min(ccfg.mc_runs, int(np.ceil(
            (ccfg.mc_threshold + 1) / min(gcp[slot], ccp[slot])
        )))
        if dist is None or not mc_tie_explains(
            dist, gcs[slot], ccfg, pair.asize, pair.bsize, n_used
        ):
            unexplained.append(int(slot))
    n_scored = int(np.count_nonzero(gcs))
    log(f"[phase 4] {seqid}[:{n}]: FET score/stddev and CSS score equal "
        f"to rtol 1e-9; CSS p differs in {len(differ)} of {n_scored} "
        f"windows, {len(unexplained)} not explained by an f32 tie")
    if unexplained:
        raise AssertionError(
            f"CSS p differs gpu vs cpu at slots {unexplained[:10]} "
            "with no permuted score within f32 rounding of the observed"
        )


# ------------------------------------------------------------- phase 5
def phase_large_panel(n_snps: int = 20_000, chrom_len: int = 1_000_000,
                      asize: int = 110, bsize: int = 90) -> None:
    genome = make_genome(
        WORK / "large_panel", n_chrom=1, snps_per_chrom=n_snps,
        chrom_len=chrom_len, asize=asize, bsize=bsize,
    )
    pairs = load_pairs(genome)
    common = [
        "--pop-a", str(genome / "popA.gtrack"),
        "--pop-b", str(genome / "popB.gtrack"),
        "--chrom-sizes", str(genome / "chrom.sizes"),
    ]
    wins = spread_windows(pairs, 3)
    for precision in ("fast", "exact"):
        out = WORK / f"large_{precision}"
        out.mkdir(parents=True, exist_ok=True)
        for cmd, track in (("run-fet", "fet.track"), ("run-css", "css.track")):
            wall = cli_run([cmd, *common, "--out", str(out / track),
                            "--precision", precision])
            log_time(f"m={asize + bsize} {cmd} --precision {precision}",
                     wall)
        # tolerances of tests/test_large_panels.py: FET 1e-9 (exact mode;
        # the tests pin no f32 band at m=200, so the fast FET column is
        # checked for NaN only), CSS 2e-3 / 1e-4
        tol = {"fet": (1e-9, 1e-12) if precision == "exact" else None,
               "css": (2e-3, 1e-4)}
        check_windows(pairs, wins, out / "fet.track", out / "css.track", tol)
        log(f"[phase 5] m={asize + bsize} {precision}: {len(wins)} windows "
            "match the oracle; no NaN in either track")


# ------------------------------------------------------------- phase 6
def phase_multi(genome: Path) -> None:
    one = WORK / "multi_one"
    four = WORK / "multi_shard"
    log_time("run-all on GPU 0", run_all(genome, one, "fast"))
    log_time(f"run-all --shard on {len(jax.devices())} GPUs",
             run_all(genome, four, "fast", shard=True))
    for name in ("fet.track", "css.track", "fet_regions.gtrack",
                 "css_regions.gtrack"):
        a, b = (one / name).read_bytes(), (four / name).read_bytes()
        if a != b:
            raise AssertionError(f"{name}: --shard output differs")
    track_dict(four / "fet.track")
    track_dict(four / "css.track")
    # the sharded run must have used every card, not only the default one
    # (devices 1.. held nothing before it)
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in jax.devices()]
    log(f"[phase 6] peak bytes in use per device: {peaks}")
    if any(p is not None and p == 0 for p in peaks[1:]):
        raise AssertionError(f"--shard left a device idle: {peaks}")
    log(f"[phase 6] --shard over {len(jax.devices())} GPUs: tracks and "
        "regions byte-identical to GPU 0 alone")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-GPU --shard phase")
    args = ap.parse_args(argv)

    devs = phase_device(4 if args.multi else 1)
    import divergence_tpu  # noqa: F401  (x64; fails outside the repo)

    shutil.rmtree(WORK, ignore_errors=True)
    try:
        genome = make_genome(WORK / "genome")
        if args.multi:
            phase_multi(genome)
        else:
            outs = phase_genome(genome)
            pairs = load_pairs(genome)
            phase_parity(pairs, outs)
            phase_cpu_agreement(pairs)
            phase_large_panel()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}))


if __name__ == "__main__":
    main()
