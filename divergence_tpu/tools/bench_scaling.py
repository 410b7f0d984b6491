"""Scaling-efficiency benchmark: the sharded divergence step over 1..N
devices.

Two series:

* **weak scaling** — fixed windows per device; efficiency =
  t(1) / t(N) at N-proportional work;
* **strong scaling** — fixed TOTAL windows; efficiency =
  t(1) / (N * t(N)).

Plus an MC-heavy case: the same step with a large permutation chunk, the
shape of SURVEY §3.2 hot loop B where sharding matters most.

North-star (BASELINE.json): >= 80% scaling efficiency from 1 GPU to N.
On a multi-GPU host this measures real scaling; on a virtual CPU
mesh (xla_force_host_platform_device_count) it validates the harness and
the sharding itself (the window axis is embarrassingly parallel — the
only collective is the fused chromosome-summary all-reduce).
"""

from __future__ import annotations

import json
import time

import numpy as np


def _mesh_sizes(max_devices: int) -> list[int]:
    sizes = []
    n = 1
    while n <= max_devices:
        sizes.append(n)
        n *= 2
    if sizes[-1] != max_devices:
        sizes.append(max_devices)
    return sizes


def _make_batch(rng, B, npos, asize, bsize):
    codes = np.array([3.0, -3.0, 0.0, -10000.0])
    av = rng.choice(codes, size=(B, npos, asize), p=[0.45, 0.35, 0.15, 0.05])
    bv = rng.choice(codes, size=(B, npos, bsize), p=[0.45, 0.35, 0.15, 0.05])
    nposs = np.full(B, npos, dtype=np.int64)
    return av, bv, nposs


def _time_step(step, sh, av, bv, nposs, repeats, timed_ctx=None):
    import contextlib

    import jax
    import jax.numpy as jnp

    args = (
        jax.device_put(jnp.asarray(av), sh),
        jax.device_put(jnp.asarray(bv), sh),
        jax.device_put(jnp.asarray(nposs), sh),
        jax.device_put(jnp.arange(len(nposs)), sh),  # window slots
        jax.random.PRNGKey(0),
    )

    def fetch(out):
        # a d2h fetch of a scalar depending on every output path forces
        # execution
        chk = (
            jnp.sum(out["fet_scores"])
            + jnp.sum(out["fet_stddev"])
            + jnp.sum(jnp.where(out["css_valid"], out["css_scores"], 0.0))
            + jnp.sum(out["mc_hits"]).astype(jnp.float64)
        )
        return float(jax.device_get(chk))

    fetch(step(*args))                # compile + warm
    ctx = timed_ctx() if timed_ctx is not None else contextlib.nullcontext()
    with ctx:  # e.g. a no-compiles-while-timed guard
        t0 = time.perf_counter()
        for _ in range(repeats):
            fetch(step(*args))
        dt = (time.perf_counter() - t0) / repeats
    return dt


def run_scaling_bench(
    max_devices: int | None = None,
    windows_per_device: int = 256,
    total_windows: int | None = None,
    npos: int = 64,
    asize: int = 11,
    bsize: int = 10,
    nsamples: int = 25,
    mc_chunk: int = 128,
    repeats: int = 3,
    timed_ctx=None,
) -> dict:
    import jax

    from divergence_tpu.parallel import (
        make_divergence_step,
        make_mesh,
        window_sharding,
    )

    n_avail = len(jax.devices())
    max_devices = min(max_devices or n_avail, n_avail)
    sizes = _mesh_sizes(max_devices)
    if total_windows is None:
        total_windows = windows_per_device * max_devices

    rng = np.random.default_rng(0)
    weak, strong = [], []
    for nd in sizes:
        mesh = make_mesh(nd)
        step = make_divergence_step(
            mesh, asize, bsize, nsamples=nsamples, mc_chunk=mc_chunk
        )
        sh = window_sharding(mesh)

        B = windows_per_device * nd
        av, bv, nposs = _make_batch(rng, B, npos, asize, bsize)
        dt = _time_step(step, sh, av, bv, nposs, repeats, timed_ctx)
        weak.append(
            {
                "devices": nd,
                "windows": B,
                "wall_s": round(dt, 4),
                "windows_per_s": round(B / dt, 1),
            }
        )

        av, bv, nposs = _make_batch(rng, total_windows, npos, asize, bsize)
        dt = _time_step(step, sh, av, bv, nposs, repeats, timed_ctx)
        strong.append(
            {
                "devices": nd,
                "windows": total_windows,
                "wall_s": round(dt, 4),
                "windows_per_s": round(total_windows / dt, 1),
            }
        )

    for r in weak:
        # weak scaling: same time at N-proportional work is perfect
        r["efficiency"] = round(weak[0]["wall_s"] / r["wall_s"], 3)
    for r in strong:
        # strong scaling: N-fold speedup at fixed work is perfect
        r["efficiency"] = round(
            strong[0]["wall_s"] / (r["devices"] * r["wall_s"]), 3
        )

    return {
        "windows_per_device": windows_per_device,
        "total_windows": total_windows,
        "mc_chunk": mc_chunk,
        "backend": jax.default_backend(),
        "weak_scaling": weak,
        "strong_scaling": strong,
    }


def main(args) -> None:
    report = run_scaling_bench(
        max_devices=args.devices,
        windows_per_device=args.windows_per_device,
        total_windows=args.total_windows,
        mc_chunk=args.mc_chunk,
    )
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--windows-per-device", type=int, default=256)
    ap.add_argument("--total-windows", type=int, default=None)
    ap.add_argument("--mc-chunk", type=int, default=128)
    main(ap.parse_args())
