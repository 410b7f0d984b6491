"""Test harness configuration.

Tests run on CPU with a virtual 8-device mesh so the multi-device
sharding path is exercised without GPUs (the GPU runs are
``python chip_smoke.py`` and ``python bench.py``).  Must run before jax
is imported.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def make_panel(
    rng,
    npos_total: int = 400,
    asize: int = 11,
    bsize: int = 10,
    region: int = 20_000,
    divergent_frac: float = 0.15,
    missing_frac: float = 0.05,
):
    """Synthetic stickleback-shaped two-population SNP panel.

    Returns flattened position-major arrays (apos, avals, bpos, bvals)
    exactly like the reference data model, plus (positions, amat, bmat).
    """
    positions = np.sort(rng.choice(np.arange(1, region), npos_total, replace=False))
    amat = np.zeros((npos_total, asize))
    bmat = np.zeros((npos_total, bsize))
    for k in range(npos_total):
        divergent = rng.random() < divergent_frac
        pa = rng.uniform(0.6, 0.95) if divergent else rng.uniform(0.3, 0.7)
        pb = rng.uniform(0.05, 0.4) if divergent else pa
        for mat, size, p in ((amat, asize, pa), (bmat, bsize, pb)):
            g = rng.random(size)
            hw = np.where(
                g < p * p, 3, np.where(g < p * p + (1 - p) * (1 - p), -3, 0)
            )
            miss = rng.random(size) < missing_frac
            mat[k] = np.where(miss, -10000, hw)
    apos = np.repeat(positions, asize)
    bpos = np.repeat(positions, bsize)
    return (
        apos,
        amat.ravel(),
        bpos,
        bmat.ravel(),
        positions,
        amat,
        bmat,
    )


@pytest.fixture(scope="session")
def panel():
    # dedicated generator: the shared session rng's state depends on test
    # execution order, which made the panel (and every statistical bound
    # computed on it) order-dependent
    return make_panel(np.random.default_rng(777))
