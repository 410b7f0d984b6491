"""Decompose the FET aggregate stage on the GPU.

At the chromosome-1 bench shape (4M SNPs -> ~400k windows, P=128) the
aggregate — gather [B,P] ranks, sort, percentile picks, 100-replicate
order-statistic bootstrap — is most of the FET wall.  This measures,
alone on the card, each term and the headroom knobs:

  gather        gather-only (bandwidth bound)
  gather_sort   + int32 sort + percentile picks (no bootstrap)
  ns1           full aggregate, nsamples=1 (bootstrap RNG nearly off)
  full          production kernel (nsamples=100)
  full_BpX      production at larger map-slice sizes

Run: python baseline/exp_fet_agg.py [--nwin N] [--P P]
"""

from __future__ import annotations

import argparse
import functools
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

import divergence_tpu  # noqa: F401
import jax
import jax.numpy as jnp

from divergence_tpu.kernels import fet as kfet


@functools.partial(jax.jit, static_argnames=("Bp", "P"))
def _gather_only(ranks, rows, Bp, P):
    nb = rows.shape[1] // Bp

    def one(start):
        r = jax.lax.dynamic_slice_in_dim(rows, start, Bp, axis=1)
        lo, npos = r[0], r[1]
        offs = jnp.arange(P, dtype=lo.dtype)[None, :]
        idx = jnp.where(offs < npos[:, None], lo[:, None] + offs, 0)
        w = jnp.take(ranks, idx, axis=0)
        return jnp.sum(w, dtype=jnp.int64)

    return jnp.sum(jax.lax.map(one, jnp.arange(nb, dtype=jnp.int32) * Bp))


@functools.partial(jax.jit, static_argnames=("Bp", "P", "perc"))
def _gather_sort(lut_sorted, ranks, rows, Bp, P, perc):
    nb = rows.shape[1] // Bp

    def one(start):
        r = jax.lax.dynamic_slice_in_dim(rows, start, Bp, axis=1)
        lo, npos = r[0], r[1]
        offs = jnp.arange(P, dtype=lo.dtype)[None, :]
        idx = jnp.where(offs < npos[:, None], lo[:, None] + offs, 0)
        w = jnp.take(ranks, idx, axis=0)
        mask = jnp.arange(P)[None, :] < npos[:, None]
        rs = jnp.sort(jnp.where(mask, w, -1), axis=-1)
        i, hi, d = kfet._interp_ranks(npos, perc, dtype=jnp.float32)
        v_lo = kfet._sorted_pick(rs, npos, i[..., None])[..., 0]
        v_hi = kfet._sorted_pick(rs, npos, hi[..., None])[..., 0]
        lo_v = jnp.take(lut_sorted, jnp.clip(v_lo, 0, lut_sorted.shape[0] - 1))
        hi_v = jnp.take(lut_sorted, jnp.clip(v_hi, 0, lut_sorted.shape[0] - 1))
        return jnp.sum((1.0 - d) * lo_v + d * hi_v)

    return jnp.sum(jax.lax.map(one, jnp.arange(nb, dtype=jnp.int32) * Bp))


def _time(fn, n=3):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.device_get(fn())
        times.append(time.perf_counter() - t0)
    return min(times)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nwin", type=int, default=399_997)
    ap.add_argument("--nsnp", type=int, default=4_194_304)
    ap.add_argument("--P", type=int, default=128)
    args = ap.parse_args()
    print(f"device: {jax.devices()[0]}", file=sys.stderr)

    rng = np.random.default_rng(0)
    G = 12 * 12 * 11 * 11 * 11  # stickleback grid size ballpark (17k)
    N, P = args.nsnp, args.P
    lut_sorted = jnp.asarray(
        np.sort(rng.exponential(size=G)).astype(np.float32)
    )
    ranks = jnp.asarray(rng.integers(0, G, size=N, dtype=np.int32))
    key = jax.random.PRNGKey(0)

    def rows_for(Bp):
        B = args.nwin
        Bt = -(-B // Bp) * Bp
        rows = np.zeros((3, Bt), dtype=np.int64)
        rows[0, :B] = rng.integers(0, N - P, size=B)
        rows[1, :B] = rng.integers(P // 3, P + 1, size=B)
        rows[2, :B] = np.arange(B)
        return jnp.asarray(rows)

    n_tests = int(np.asarray(rows_for(4096)[1]).sum())
    out = {}
    rows = rows_for(4096)

    for name, fn in (
        ("gather", lambda: _gather_only(ranks, rows, 4096, P)),
        ("gather_sort", lambda: _gather_sort(
            lut_sorted, ranks, rows, 4096, P, 0.95)),
        ("ns1", lambda: kfet.fet_aggregate_all_ranks(
            lut_sorted, ranks, rows, key, Bp=4096, P=P, perc=0.95,
            nsamples=1, fast=True)),
        ("full", lambda: kfet.fet_aggregate_all_ranks(
            lut_sorted, ranks, rows, key, Bp=4096, P=P, perc=0.95,
            nsamples=100, fast=True)),
    ):
        fn()  # compile
        s = _time(fn)
        out[name] = s
        print(f"{name:12s} {s:7.3f}s  ({n_tests / s / 1e6:7.1f}M tests/s)",
              file=sys.stderr)

    for Bp in (8192, 16384, 32768):
        rows_b = rows_for(Bp)
        fn = lambda: kfet.fet_aggregate_all_ranks(  # noqa: E731
            lut_sorted, ranks, rows_b, key, Bp=Bp, P=P, perc=0.95,
            nsamples=100, fast=True)
        fn()
        s = _time(fn)
        out[f"full_Bp{Bp}"] = s
        print(f"full_Bp{Bp:<6d} {s:7.3f}s  "
              f"({n_tests / s / 1e6:7.1f}M tests/s)", file=sys.stderr)

    import json

    print(json.dumps({"n_tests": n_tests, "walls_s": out}))


if __name__ == "__main__":
    main()
