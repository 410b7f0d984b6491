"""Permutation-MC evaluator micro-benchmark (evaluator A/B).

Measures permutations/second of the chunk evaluators on the current
backend, on the production shape (stickleback panel, m=21).  This is
the measured artifact behind the ``perm_backend``/``rng``/``perm_form``
choices: run on the GPU, keep the winner as the default.

Two protocols:

- ``inloop_*`` — the variant inside the production
  :func:`kernels.perm.mc_significance` while-loop, scores pinned so no
  window stops early.  THIS is the number that predicts engine
  throughput: XLA fuses the chunk evaluator differently inside the loop
  (measured 5x faster than the same chunk standalone on CPU — the
  standalone protocol materializes what the in-loop reduction consumes
  fused).
- standalone — one jitted chunk call per measurement; kept to document
  that fusion-context effect and for kernels with no loop form.

Variants: ``xla`` (mix bitgen, broadcast form — the production
default), ``xla_threefry`` (round-1 stream), ``xla_matmul``
(between-sum as a batched matmul via the +-1 identity), ``xla_mlast``
(chunk axis second), ``native`` (threaded C++ host evaluator, same
stream — the CPU-host row), and ``inloop``, ``inloop_threefry``,
``inloop_matmul``, ``inloop_shared`` (the shared-stream matmul production
default).

Timing protocol: each measurement fetches a reduced scalar that depends
on every output, so the time covers the device work; the first call per
shape pays the (persistent-cached) compile.
"""

from __future__ import annotations

import json
import time

import numpy as np


def run_mc_bench(
    window_batch: int = 1024,
    chunk: int = 256,
    iters: int = 4,
    asize: int = 11,
    bsize: int = 10,
    backends: tuple[str, ...] = ("inloop", "inloop_shared"),
) -> dict:
    import jax
    import jax.numpy as jnp

    from divergence_tpu.kernels import perm as kperm

    m = asize + bsize
    rng = np.random.default_rng(0)
    d = rng.random((window_batch, m, m))
    d = d + d.transpose(0, 2, 1)
    for i in range(window_batch):
        np.fill_diagonal(d[i], 0.0)
    distf = jnp.asarray(d, dtype=jnp.float32)
    keys = kperm.window_keys(
        jax.random.PRNGKey(1),
        jnp.zeros(window_batch, dtype=jnp.int64),
        jnp.arange(window_batch, dtype=jnp.int64),
    )

    def make_xla(bitgen, form):
        @jax.jit
        def f(k):
            s = kperm._perm_scores(
                distf, kperm._fold_chunk(keys, k), asize, bsize, chunk,
                bitgen=bitgen, form=form,
            )
            return jnp.sum(s)

        return f

    @jax.jit
    def xla_mlast_chunk(k):
        s = kperm._perm_scores_mlast(
            distf, kperm._fold_chunk(keys, k), asize, bsize, chunk
        )
        return jnp.sum(s)

    def run_inloop(bitgen, form, backend, stream="window"):
        """Time mc_significance with unreachable scores: every window
        runs its full permutation budget — steady-state in-loop rate."""
        nperm = chunk
        runs = nperm * iters
        scores = jnp.full(window_batch, 1e30, dtype=jnp.float64)
        ks = jax.random.PRNGKey(1) if stream == "shared" else keys

        def go():
            out = kperm.mc_significance(
                distf, scores, ks, asize, bsize, nperm, runs,
                10, backend=backend, bitgen=bitgen,
                form=form, stream=stream,
            )
            return jax.device_get(out[0])

        go()                                          # compile + warm
        t0 = time.perf_counter()
        pv = go()
        dt = time.perf_counter() - t0
        return {
            "chunk": nperm,
            "loop_chunks": iters,
            "wall_s": round(dt, 4),
            "perms_per_s": round(window_batch * runs / dt),
            "checksum": round(float(np.sum(pv)), 2),
        }

    def run_native():
        """The threaded C++ host evaluator (native/mc_native.cpp) on the
        saturated workload — the CPU-host row of the A/B (its perms ride
        host cores, not the device)."""
        from divergence_tpu import native as nat

        if not nat.native_available():
            return {"error": "native toolchain unavailable"}
        wk = np.asarray(
            jax.device_get(jax.random.key_data(keys)), dtype=np.uint32
        )
        runs = chunk * iters
        hi = np.full(window_batch, 1e30)
        nat.mc_native(d, hi, wk, asize, chunk, chunk, 10)  # warm/build
        t0 = time.perf_counter()
        pv, n, h = nat.mc_native(d, hi, wk, asize, chunk, runs, 10)
        dt = time.perf_counter() - t0
        return {
            "chunk": chunk,
            "loop_chunks": iters,
            "wall_s": round(dt, 4),
            "perms_per_s": round(int(n.sum()) / dt),
            "checksum": round(float(np.sum(pv)), 2),
        }

    results = {
        "backend": jax.default_backend(),
        "window_batch": window_batch,
        "m": m,
    }
    for name in backends:
        try:
            if name == "native":
                results[name] = run_native()
                continue
            if name.startswith("inloop"):
                variant = name[len("inloop"):].lstrip("_") or "xla"
                bitgen, form, backend, stream = {
                    "xla": ("mix", "broadcast", "xla", "window"),
                    "threefry": ("threefry", "broadcast", "xla", "window"),
                    "matmul": ("mix", "matmul", "xla", "window"),
                    # the production default since round 4: one genome-
                    # wide label permutation per draw, evaluated as an
                    # matmul (kernels/perm.py:_shared_perm_scores)
                    "shared": ("mix", "broadcast", "xla", "shared"),
                }[variant]
                results[name] = run_inloop(bitgen, form, backend, stream)
                continue
            if name == "xla":
                fn, arg0, nperm = make_xla("mix", "broadcast"), jnp.int32(0), chunk
            elif name == "xla_threefry":
                fn, arg0, nperm = make_xla("threefry", "broadcast"), jnp.int32(0), chunk
            elif name == "xla_matmul":
                fn, arg0, nperm = make_xla("mix", "matmul"), jnp.int32(0), chunk
            elif name == "xla_mlast":
                fn, arg0, nperm = xla_mlast_chunk, jnp.int32(0), chunk
            else:
                raise ValueError(f"unknown backend {name!r}")
            jax.device_get(fn(arg0))                  # compile + warm
            t0 = time.perf_counter()
            acc = 0.0
            for i in range(iters):
                acc += float(jax.device_get(fn(arg0 + i + 1)))
            dt = time.perf_counter() - t0
            perms = window_batch * nperm * iters
            results[name] = {
                "chunk": nperm,
                "wall_s": round(dt, 4),
                "perms_per_s": round(perms / dt),
                "checksum": round(acc, 2),
            }
        except Exception as e:  # e.g. native toolchain absent
            results[name] = {"error": f"{type(e).__name__}: {e}"[:300]}
    return results


def main(args) -> None:
    report = run_mc_bench(
        window_batch=args.window_batch,
        chunk=args.chunk,
        iters=args.iters,
        backends=tuple(args.backends.split(",")),
    )
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--window-batch", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--backends", default="inloop,inloop_shared")
    main(ap.parse_args())
