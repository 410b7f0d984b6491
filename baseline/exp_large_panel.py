"""Device throughput vs panel size m.

Measures warm FET and CSS engine throughput at stickleback scale
(11+10) and modern resequencing scales (m=128: 70+58, m=200: 110+90) on
the same chromosome shape, so BASELINE.md can state the measured cost
of leaving the LUT/21-lane sweet spots (correctness at these sizes is
pinned by tests/test_large_panels.py).

Run alone on the GPU: python baseline/exp_large_panel.py
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

import divergence_tpu  # noqa: F401
import jax

from bench import make_chromosome
from divergence_tpu.config import CssConfig, FetConfig
from divergence_tpu.core.windows import plan_windows
from divergence_tpu.engine import run_css, run_fet
from divergence_tpu.engine.snp import SnpPair


def main() -> None:
    print(f"device: {jax.devices()[0]}", file=sys.stderr)
    out = {}
    npos, region = 200_000, 10_000_000
    css_npos, css_region = 10_000, 500_000
    for label, asize, bsize in (
        ("m21", 11, 10), ("m128", 70, 58), ("m200", 110, 90)
    ):
        pos, av, bv = make_chromosome(npos, region, asize, bsize, 7)
        pair = SnpPair(positions=pos, avals=av, bvals=bv)
        plan = plan_windows(pos, region, 2500, 500)
        n_tests = int(plan.npos[plan.valid_mask()].sum())
        cfg = FetConfig(precision="fast")
        run_fet(pair, region, cfg)   # warmup/compile
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            run_fet(pair, region, cfg)
            times.append(time.perf_counter() - t0)
        fet_s = min(times)

        cpos, cav, cbv = make_chromosome(
            css_npos, css_region, asize, bsize, 11
        )
        cpair = SnpPair(positions=cpos, avals=cav, bvals=cbv)
        ccfg = CssConfig(precision="fast", mc_runs=20_000)
        from divergence_tpu.utils.summary import RunSummary

        run_css(cpair, css_region, ccfg)  # warmup/compile
        ctimes, mc = [], 0
        for _ in range(3):
            s = RunSummary()
            t0 = time.perf_counter()
            run_css(cpair, css_region, ccfg, summary=s)
            ctimes.append(time.perf_counter() - t0)
            mc = s.counters.get("mc_permutations", 0)
        css_s = min(ctimes)
        out[label] = {
            "asize": asize, "bsize": bsize,
            "fet_tests_per_sec": round(n_tests / fet_s, 1),
            "fet_wall_s": round(fet_s, 3),
            "css_wall_s": round(css_s, 3),
            "css_perms_per_sec": round(mc / css_s, 1),
            "css_mc_perms": mc,
        }
        print(f"{label}: fet {n_tests / fet_s / 1e6:.1f}M tests/s "
              f"({fet_s:.2f}s), css {css_s:.2f}s "
              f"({mc / css_s / 1e6:.0f}M perms/s)", file=sys.stderr)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
