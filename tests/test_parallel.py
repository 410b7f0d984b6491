"""Mesh / GSPMD parallelism tests on the virtual 8-device CPU mesh.

The reference's only parallel-correctness test is a serial-vs-threaded
output diff (reference testcss.c:31-142).  The device-mesh equivalent is
1-device-vs-N-device equivalence of the sharded divergence step — and,
since every RNG stream is (seed, chrom, slot)-pinned, the equivalence is
bitwise for the stochastic outputs too.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from divergence_tpu.parallel import (
    make_divergence_step,
    make_mesh,
    merge_score_shards,
    pad_to_multiple,
    partition_chromosomes,
    window_sharding,
)


def _batch(B, P, asize=5, bsize=4, seed=3):
    rng = np.random.default_rng(seed)
    codes = np.array([3.0, -3.0, 0.0, -10000.0])
    av = rng.choice(codes, size=(B, P, asize), p=[0.45, 0.35, 0.15, 0.05])
    bv = rng.choice(codes, size=(B, P, bsize), p=[0.45, 0.35, 0.15, 0.05])
    npos = rng.integers(P // 2, P + 1, size=(B,))
    return jnp.asarray(av), jnp.asarray(bv), jnp.asarray(npos)


def test_mesh_construction():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    mesh = make_mesh(8)
    assert mesh.devices.shape == (8,)
    with pytest.raises(ValueError):
        make_mesh(10_000)


def test_pad_to_multiple():
    assert pad_to_multiple(13, 8) == 16
    assert pad_to_multiple(16, 8) == 16
    assert pad_to_multiple(1, 8) == 8


def _run(mesh, av, bv, npos, slot=None, **kw):
    step = make_divergence_step(mesh, av.shape[-1], bv.shape[-1], **kw)
    sh = window_sharding(mesh)
    if slot is None:
        slot = jnp.arange(av.shape[0])
    out = step(
        jax.device_put(av, sh),
        jax.device_put(bv, sh),
        jax.device_put(npos, sh),
        jax.device_put(slot, sh),
        jax.random.PRNGKey(0),
    )
    return jax.tree.map(np.asarray, out)


def test_one_vs_eight_device_equivalence():
    """All outputs — including the RNG-dependent bootstrap stddev and MC
    hits — must match across mesh sizes: RNG streams are window-pinned,
    not shard-pinned (the analogue of the reference's serial-vs-threaded
    diff, testcss.c:31-142, strengthened to the stochastic outputs)."""
    B, P = 16, 32
    av, bv, npos = _batch(B, P)
    out1 = _run(make_mesh(1), av, bv, npos, nsamples=4, mc_chunk=8)
    out8 = _run(make_mesh(8), av, bv, npos, nsamples=4, mc_chunk=8)

    np.testing.assert_allclose(
        out1["fet_scores"], out8["fet_scores"], rtol=1e-12, atol=1e-12
    )
    np.testing.assert_allclose(
        out1["css_scores"], out8["css_scores"], rtol=1e-9, atol=1e-11
    )
    np.testing.assert_array_equal(out1["css_valid"], out8["css_valid"])
    np.testing.assert_allclose(
        out1["fet_stddev"], out8["fet_stddev"], rtol=1e-9, atol=1e-12
    )
    np.testing.assert_array_equal(out1["mc_hits"], out8["mc_hits"])
    assert int(out1["windows_evaluated"]) == int(out8["windows_evaluated"])
    np.testing.assert_allclose(
        out1["score_sum"], out8["score_sum"], rtol=1e-9
    )
    assert (out8["fet_stddev"][np.asarray(npos) > 0] >= 0).all()


def test_step_sub_batch_invariance():
    """Evaluating the same windows in one step call vs two half-batch
    calls gives identical stochastic outputs: streams are slot-keyed,
    not batch-position-keyed (CLAUDE.md RNG invariant)."""
    B, P = 16, 32
    av, bv, npos = _batch(B, P, seed=7)
    slot = jnp.arange(B)
    mesh = make_mesh(8)
    kw = dict(nsamples=4, mc_chunk=8, mds=1, smacof_iters=5,
              smacof_inits=2)
    full = _run(mesh, av, bv, npos, slot=slot, **kw)
    halves = [
        _run(mesh, av[s], bv[s], npos[s], slot=slot[s], **kw)
        for s in (slice(0, B // 2), slice(B // 2, B))
    ]
    for name in ("fet_scores", "fet_stddev", "css_scores", "mc_hits"):
        cat = np.concatenate([h[name] for h in halves])
        np.testing.assert_array_equal(full[name], cat, err_msg=name)


def test_sharded_matches_unsharded_kernels():
    """The shard_map step's deterministic outputs equal direct kernel calls."""
    from divergence_tpu.kernels import css as kcss
    from divergence_tpu.kernels import fet as kfet

    B, P, asize, bsize = 8, 32, 5, 4
    av, bv, npos = _batch(B, P, asize, bsize, seed=11)
    out = _run(make_mesh(8), av, bv, npos, nsamples=4, mc_chunk=8)

    maxs = kfet.support_size(asize, bsize)
    s, _ = kfet.fet_window_batch(
        av,
        bv,
        npos,
        0.95,
        jax.random.PRNGKey(1),
        nsamples=4,
        maxs=maxs,
        nmax=asize + bsize + 2,
    )
    np.testing.assert_allclose(out["fet_scores"], np.asarray(s), rtol=1e-12)

    cs, _, valid = kcss.css_window_batch(
        av,
        bv,
        npos,
        jax.random.PRNGKey(2),
        asize=asize,
        bsize=bsize,
    )
    np.testing.assert_allclose(
        out["css_scores"], np.asarray(cs), rtol=1e-9, atol=1e-11
    )
    np.testing.assert_array_equal(out["css_valid"], np.asarray(valid))


def test_engine_sharding_path(panel):
    """run_fet with an explicit window sharding gives identical scores to
    the unsharded path."""
    from divergence_tpu.engine import run_fet
    from divergence_tpu.engine.snp import SnpPair

    apos, avals, bpos, bvals, positions, amat, bmat = panel
    pair = SnpPair(positions=positions, avals=amat, bvals=bmat)
    regend = int(positions[-1]) + 1

    s0, d0 = run_fet(pair, regend)
    sh = window_sharding(make_mesh(8))
    s1, d1 = run_fet(pair, regend, sharding=sh)
    np.testing.assert_allclose(s0, s1, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(d0, d1, rtol=1e-12, atol=1e-12)


def test_scaling_bench_smoke():
    """run_scaling_bench (the bench-scaling CLI core) executes across
    mesh sizes and reports both weak- and strong-scaling series with
    finite efficiencies — guards the sharded-step call signature."""
    from divergence_tpu.tools.bench_scaling import run_scaling_bench

    report = run_scaling_bench(
        max_devices=2,
        windows_per_device=8,
        total_windows=16,
        npos=16,
        nsamples=2,
        mc_chunk=8,
        repeats=1,
    )
    assert [r["devices"] for r in report["weak_scaling"]] == [1, 2]
    assert [r["devices"] for r in report["strong_scaling"]] == [1, 2]
    for series in ("weak_scaling", "strong_scaling"):
        for r in report[series]:
            assert np.isfinite(r["efficiency"]) and r["windows_per_s"] > 0


def test_partition_chromosomes_balanced_and_deterministic():
    weights = {f"chr{i}": (i + 1) * 100 for i in range(10)}
    parts = [partition_chromosomes(weights, 4, p) for p in range(4)]
    all_seqids = [s for p in parts for s in p.seqids]
    assert sorted(all_seqids) == sorted(weights)
    loads = [sum(weights[s] for s in p.seqids) for p in parts]
    assert max(loads) <= 2 * min(loads)
    with pytest.raises(ValueError):
        partition_chromosomes(weights, 4, 7)


def test_merge_score_shards():
    a = {"chr1": (np.ones(3), np.zeros(3))}
    b = {"chr2": (np.ones(2), np.zeros(2))}
    merged = merge_score_shards([a, b])
    assert set(merged) == {"chr1", "chr2"}
    with pytest.raises(ValueError):
        merge_score_shards([a, a])


def _null_dists(rng_seed, B, m):
    rng = np.random.default_rng(rng_seed)
    d = rng.random((B, m, m)) * 2.0
    d = d + d.transpose(0, 2, 1)
    for i in range(B):
        np.fill_diagonal(d[i], 0.0)
    return d


def test_sharded_mc_matches_unsharded():
    """The CSS permutation MC (SURVEY §3.2 hot loop B) sharded over the
    8-device mesh must reproduce the single-device p-values exactly —
    per-window RNG streams are placement-invariant."""
    from divergence_tpu.kernels import perm as kperm

    B, m, asize, bsize = 24, 9, 5, 4
    dist = _null_dists(21, B, m)
    scores = np.quantile(
        dist.reshape(B, -1), 0.7, axis=-1
    )  # mixed-significance observed scores
    key = jax.random.PRNGKey(3)
    slots = np.arange(B, dtype=np.int64) * 7 + 3
    chroms = np.where(np.arange(B) % 2 == 0, 11, 22).astype(np.int64)

    r0 = kperm.significance(
        dist, scores, asize, bsize, 5, 2000, key,
        chunk=128, chroms=chroms, slots=slots,
    )
    sh = window_sharding(make_mesh(8))
    r8 = kperm.significance(
        dist, scores, asize, bsize, 5, 2000, key,
        chunk=128, chroms=chroms, slots=slots, sharding=sh,
    )
    np.testing.assert_array_equal(r0.pvals, r8.pvals)
    np.testing.assert_array_equal(r0.nscores, r8.nscores)
    np.testing.assert_array_equal(r0.hits, r8.hits)


def test_mc_batch_composition_invariance():
    """P-values are a pure function of (seed, chrom, slot): evaluating a
    window alone, in a different batch, or with a different window_batch
    split gives the identical result."""
    from divergence_tpu.kernels import perm as kperm

    B, m, asize, bsize = 20, 9, 5, 4
    dist = _null_dists(5, B, m)
    scores = np.quantile(dist.reshape(B, -1), 0.8, axis=-1)
    key = jax.random.PRNGKey(9)
    slots = np.arange(B, dtype=np.int64)
    chroms = np.full(B, 17, dtype=np.int64)

    full = kperm.significance(
        dist, scores, asize, bsize, 5, 1500, key,
        chunk=128, chroms=chroms, slots=slots,
    )
    split = kperm.significance(
        dist, scores, asize, bsize, 5, 1500, key,
        chunk=128, chroms=chroms, slots=slots, window_batch=7,
    )
    np.testing.assert_array_equal(full.pvals, split.pvals)

    one = kperm.significance(
        dist[4:5], scores[4:5], asize, bsize, 5, 1500, key,
        chunk=128, chroms=chroms[4:5], slots=slots[4:5],
    )
    assert one.pvals[0] == full.pvals[4]


def test_two_stage_compaction_matches_single_pass():
    """significance()'s stage-1/stage-2 compaction (runs > stage-1
    budget) must equal the uncompacted on-device loop bit-for-bit —
    the chunk-indexed streams make the resume exact."""
    import jax.numpy as jnp

    from divergence_tpu.kernels import perm as kperm

    B, m, asize, bsize = 12, 9, 5, 4
    dist = _null_dists(31, B, m)
    # high quantile -> some windows stay unfinished past stage 1
    scores = np.quantile(dist.reshape(B, -1), 0.97, axis=-1)
    key = jax.random.PRNGKey(4)
    chunk, runs, threshold = 64, 8000, 10
    chroms = np.full(B, 3, dtype=np.int64)
    slots = np.arange(B, dtype=np.int64)

    got = kperm.significance(
        dist, scores, asize, bsize, threshold, runs, key,
        chunk=chunk, chroms=chroms, slots=slots,
    )
    # sanity: the workload actually exercises stage 2
    stage1_perms = max(1, -(-4096 // chunk)) * chunk
    assert (got.nscores > stage1_perms).any(), "fixture finished in stage 1"

    keys = kperm.window_keys(
        key, jnp.asarray(chroms), jnp.asarray(slots)
    )
    pv, n, h, fin = kperm.mc_significance(
        jnp.asarray(dist), jnp.asarray(scores), keys,
        asize, bsize, chunk, runs, threshold,
    )
    assert bool(np.asarray(fin).all())
    np.testing.assert_array_equal(got.pvals, np.asarray(pv))
    np.testing.assert_array_equal(got.nscores, np.asarray(n))
    np.testing.assert_array_equal(got.hits, np.asarray(h))


def test_css_engine_sharded_mc_path(panel):
    """run_css with --shard semantics: both phases sharded, results equal
    to the unsharded run (the round-1 gap: the MC ignored sharding)."""
    from divergence_tpu.config import CssConfig, WindowConfig
    from divergence_tpu.engine import run_css
    from divergence_tpu.engine.snp import SnpPair

    apos, avals, bpos, bvals, positions, amat, bmat = panel
    pair = SnpPair(positions=positions, avals=amat, bvals=bmat)
    regend = int(positions[-1]) + 1
    cfg = CssConfig(
        window=WindowConfig(2500, 500), mc_runs=400, mc_chunk=128
    )

    s0, p0 = run_css(pair, regend, cfg)
    sh = window_sharding(make_mesh(8))
    s1, p1 = run_css(pair, regend, cfg, sharding=sh)
    np.testing.assert_allclose(s0, s1, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(p0, p1)


def test_approx_significance_sharded_matches_unsharded():
    """Pearson-III p-values are placement-invariant too (same per-window
    moment streams)."""
    from divergence_tpu.kernels import perm as kperm

    B, m, asize, bsize = 16, 9, 5, 4
    dist = _null_dists(41, B, m)
    scores = np.quantile(dist.reshape(B, -1), 0.9, axis=-1)
    key = jax.random.PRNGKey(6)
    slots = np.arange(B, dtype=np.int64)
    chroms = np.full(B, 5, dtype=np.int64)
    r0 = kperm.approx_significance(
        dist, scores, asize, bsize, key, chunk=512,
        chroms=chroms, slots=slots,
    )
    sh = window_sharding(make_mesh(8))
    r8 = kperm.approx_significance(
        dist, scores, asize, bsize, key, chunk=512,
        chroms=chroms, slots=slots, sharding=sh,
    )
    np.testing.assert_allclose(r0.pvals, r8.pvals, rtol=1e-9)
    np.testing.assert_array_equal(r0.nscores, r8.nscores)


def test_two_process_distributed_smoke(tmp_path):
    """2-process jax.distributed over loopback DCN: deterministic
    chromosome partition, per-host engine runs, shard merge == the
    single-process genome-wide run (the platform fan-out analogue,
    reference FisherExactTestSNPTool.py:167-171)."""
    import importlib.util
    import os
    import socket
    import subprocess
    import sys as _sys

    worker = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")

    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", 0))
        except OSError:
            pytest.skip("cannot bind loopback port")
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(worker)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    # the worker forces the CPU platform itself (config route)
    procs = [
        subprocess.Popen(
            [_sys.executable, worker, str(p), "2", coord, str(tmp_path)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for p in range(2)
    ]
    outs = []
    try:
        for pr in procs:
            out, _ = pr.communicate(timeout=240)
            outs.append(out.decode())
    except subprocess.TimeoutExpired:
        for pr in procs:
            pr.kill()
        pytest.skip("distributed workers timed out (coordination service)")
    for pr, out in zip(procs, outs):
        assert pr.returncode == 0, out[-2000:]

    # merge the two shards and compare with a single-process run
    spec = importlib.util.spec_from_file_location("_mh_worker", worker)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    from divergence_tpu.config import FetConfig, WindowConfig
    from divergence_tpu.engine.fet_engine import run_fet_multi
    from divergence_tpu.engine.snp import SnpPair

    genome = mod.make_genome()
    cfg = FetConfig(window=WindowConfig(2500, 500), bootstrap_samples=4)
    want = run_fet_multi(
        {
            c: (SnpPair(positions=p, avals=a, bvals=b), r)
            for c, (p, a, b, r) in genome.items()
        },
        cfg,
    )

    shards = []
    for p in range(2):
        z = np.load(tmp_path / f"shard{p}.npz")
        chroms = {k[: -len("_scores")] for k in z.files if k.endswith("_scores")}
        shards.append(
            {c: (z[f"{c}_scores"], z[f"{c}_stddev"]) for c in chroms}
        )
    merged = merge_score_shards(shards)
    assert set(merged) == set(want)
    for c in want:
        np.testing.assert_array_equal(merged[c][0], want[c][0])
        np.testing.assert_array_equal(merged[c][1], want[c][1])
