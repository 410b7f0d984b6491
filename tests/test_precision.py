"""Matmul precision pins of the Monte-Carlo and SMACOF paths.

On the GPU a float32 matmul without a precision argument may run in
TF32 (~1e-3 relative error).  The permutation MC counts a hit by
comparing each permuted score with the observed one, so TF32 would flip
hits near the threshold and bias the p-values; SMACOF's Guttman
transform would drift off the reference's iterates.  Each lowered
program must carry ``precision = [HIGHEST, HIGHEST]`` on every
``dot_general`` — checked on the CPU lowering, which is the same
StableHLO the GPU compiler receives.
"""

import re

import jax
import jax.numpy as jnp
import pytest

from divergence_tpu.kernels import css as kcss
from divergence_tpu.kernels import perm as kperm

B, ASIZE, BSIZE = 8, 11, 10
M = ASIZE + BSIZE


def _mc_lowering(stream, form):
    dist = jnp.zeros((B, M, M))
    scores = jnp.zeros(B)
    key = jax.random.PRNGKey(0)
    keys = key if stream == "shared" else jax.vmap(
        lambda i: jax.random.fold_in(key, i)
    )(jnp.arange(B))
    return kperm.mc_significance.lower(
        dist, scores, keys, asize=ASIZE, bsize=BSIZE, chunk=16, runs=64,
        threshold=10, form=form, stream=stream,
    ).as_text()


def _smacof_lowering():
    return kcss.smacof.lower(
        jnp.zeros((B, M, M), jnp.float32), jnp.zeros((B, M, 2), jnp.float32),
        max_iters=3,
    ).as_text()


@pytest.mark.parametrize(
    "lower",
    [
        pytest.param(lambda: _mc_lowering("shared", "broadcast"),
                     id="mc-shared-stream"),
        pytest.param(lambda: _mc_lowering("window", "matmul"),
                     id="mc-window-matmul-form"),
        pytest.param(_smacof_lowering, id="smacof-guttman"),
    ],
)
def test_f32_matmuls_pinned_highest(lower):
    text = lower()
    dots = [ln for ln in text.splitlines() if "stablehlo.dot_general" in ln]
    assert dots, "expected at least one matmul in the lowered program"
    for ln in dots:
        assert re.search(r"precision = \[HIGHEST, HIGHEST\]", ln), ln
