"""Batched small-matrix linear algebra for the CSS pipeline.

The CSS pipeline needs the top-2 eigenpairs of thousands of small
(m ~ 21, up to a few hundred for resequencing panels) symmetric matrices
per chromosome (reference statistics/css/css.c:529-541 calls GSL's symmv
per window, serially).  XLA's batched ``eigh`` solves the whole batch in
one call: LAPACK ``syevd`` on the CPU, cuSOLVER ``syevd``/batched
``syevj`` on the GPU.
"""

from __future__ import annotations

import jax.numpy as jnp


def top2_eig(a: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Top-2 eigenpairs (descending) of a batch of symmetric matrices.

    Returns (vals [..., 2], vecs [..., m, 2]).  Matches the reference's
    'keep the dims largest eigenvalues' (reference
    statistics/css/css.c:543-553).  A solver failure surfaces as NaN
    eigenpairs (JAX's ``eigh`` contract), which the callers' NaN checks
    report."""
    w, v = jnp.linalg.eigh(a)          # ascending
    return w[..., ::-1][..., :2], v[..., ::-1][..., :2]
