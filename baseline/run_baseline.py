"""Run the gcc-built reference C kernels on the bench.py workload.

Produces the honest native baseline the device engine must beat:
the reference's own 64-thread pool
(threadfisher.c:19-25, threadcss.c:19-25) compiled -O3 -mavx on THIS
machine, timed on the exact synthetic chromosome bench.py uses.

Writes baseline/RESULTS.json and prints a human summary.  Run:
    python baseline/run_baseline.py [--quick]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent
sys.path.insert(0, str(REPO))

from bench import make_chromosome  # noqa: E402  (numpy-only module)

# Load the window planner without importing the jax-touching package.
_spec = importlib.util.spec_from_file_location(
    "windows", REPO / "divergence_tpu" / "core" / "windows.py"
)
_windows = importlib.util.module_from_spec(_spec)
sys.modules["windows"] = _windows  # dataclasses resolves __module__
_spec.loader.exec_module(_windows)
plan_windows = _windows.plan_windows


def write_gtrack(path: pathlib.Path, positions: np.ndarray, mat: np.ndarray):
    """Valued-points GTrack in the layout the reference harness parses
    (testFisher.c:190-230: 5 header lines, then `seqid\\tpos\\tval` rows,
    position-major so population size = run-length of the first
    position, comparative.c:25-34)."""
    with open(path, "w") as f:
        f.write("##gtrack version: 1.0\n")
        f.write("##track type: valued points\n")
        f.write("###seqid\tstart\tvalue\n")
        f.write("# synthetic bench chromosome\n")
        f.write("#\n")
        size = mat.shape[1]
        for k in range(positions.shape[0]):
            p = int(positions[k])
            row = mat[k]
            for i in range(size):
                f.write(f"chr1\t{p}\t{row[i]:g}\n")


def run_binary(binary, fa, fb, mode, regend=None, extra=()):
    cmd = [str(binary), str(fa), str(fb), mode]
    if regend is not None:
        cmd.append(str(regend))
    cmd += [str(x) for x in extra]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=7200)
    wall_outer = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"{cmd} failed: {r.stderr}")
    out = dict(
        line.split() for line in r.stdout.splitlines() if len(line.split()) == 2
    )
    return {
        "windows": int(out["WINDOWS"]),
        "nonzero": int(out["NONZERO"]),
        "wall_s": float(out["WALL"]),
        "wall_outer_s": round(wall_outer, 3),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--quick",
        action="store_true",
        help="small regions only (CI smoke, not baseline numbers)",
    )
    args = ap.parse_args()

    build = HERE / "build"
    if not (build / "bench_ref_fet").exists():
        subprocess.run([str(HERE / "build.sh")], check=True)

    results = {"machine_note": "gcc -O3 -mavx -pthread, 64-thread pool"}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="refbase_"))

    # --- FET workload (bench.py protocol: seed 7, 11+10 individuals) ---
    asize, bsize = 11, 10
    region = 1_000_000 if args.quick else 10_000_000
    npos = 20_000 if args.quick else 200_000
    positions, amat, bmat = make_chromosome(npos, region, asize, bsize, 7)
    plan = plan_windows(positions, region, 2500, 500)
    valid = plan.valid_mask()
    n_tests = int(plan.npos[valid].sum())
    fa, fb = tmp / "fet_a.gtrack", tmp / "fet_b.gtrack"
    write_gtrack(fa, positions, amat)
    write_gtrack(fb, positions, bmat)

    print(f"[fet] {int(valid.sum())} windows, {n_tests} SNP tests")
    for mode in ("serial", "thread"):
        r = run_binary(build / "bench_ref_fet", fa, fb, mode)
        r["snp_tests_per_s"] = round(n_tests / r["wall_s"], 1)
        results[f"fet_{mode}"] = r
        print(f"[fet {mode}] {r}")

    # --- CSS workload (bench.py protocol: seed 11, divergent pops ->
    # worst-case MC: every scored window runs to mcR=200k) ---
    cregion = 100_000 if args.quick else 500_000
    cnpos = 2_000 if args.quick else 10_000
    cpos, camat, cbmat = make_chromosome(cnpos, cregion, asize, bsize, 11)
    cplan = plan_windows(cpos, cregion, 2500, 500)
    cvalid = cplan.valid_mask()
    fca, fcb = tmp / "css_a.gtrack", tmp / "css_b.gtrack"
    write_gtrack(fca, cpos, camat)
    write_gtrack(fcb, cpos, cbmat)

    print(f"[css] {int(cvalid.sum())} windows")
    # serial CSS at 200k perms/window is slow: time a prefix region and
    # extrapolate per scored window.
    serial_regend = 25_000 if args.quick else 50_000
    r = run_binary(build / "bench_ref_css", fca, fcb, "serial", serial_regend)
    r["s_per_scored_window"] = round(r["wall_s"] / max(r["nonzero"], 1), 4)
    results["css_serial_prefix"] = r
    print(f"[css serial prefix] {r}")

    r = run_binary(build / "bench_ref_css", fca, fcb, "thread")
    r["scored_windows_per_s"] = round(r["nonzero"] / r["wall_s"], 2)
    # every scored window in this workload saturates mcR=200k perms
    # (divergent populations; confirmed by p == 1/(200001+... ) pattern)
    r["approx_perms_per_s"] = round(r["nonzero"] * 200_000 / r["wall_s"], 0)
    results["css_thread"] = r
    print(f"[css thread] {r}")

    out = HERE / "RESULTS.json"
    out.write_text(json.dumps(results, indent=2) + "\n")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
