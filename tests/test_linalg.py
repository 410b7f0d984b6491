"""Top-2 eigensolver (kernels.linalg.top2_eig) unit tests.

``top2_eig`` is the CMDS eigensolver of every CSS window: XLA's batched
``eigh`` with the two largest eigenpairs kept in descending order.  The
cases span the stickleback panel (m = 21) through resequencing panels
(m = 200) in both precisions, plus degenerate and tied spectra, where
the eigenvectors of a repeated eigenvalue are not unique and only the
invariant properties can be pinned.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from divergence_tpu.kernels.linalg import top2_eig


def _sym(rng, b, m):
    s = rng.standard_normal((b, m, m))
    return s + np.swapaxes(s, -1, -2)


def test_top2_eig_matches_numpy(rng):
    s = _sym(rng, 7, 21)
    vals, vecs = top2_eig(jnp.asarray(s))
    wn, vn = np.linalg.eigh(s)
    np.testing.assert_allclose(
        np.asarray(vals), wn[..., ::-1][..., :2], rtol=1e-10, atol=1e-12
    )
    # compare eigenvectors up to sign
    got = np.abs(np.asarray(vecs))
    want = np.abs(vn[..., ::-1][..., :2])
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-8)


# relative eigenvalue / residual bounds per dtype: f32 roundoff grows
# with m (the backward error of a symmetric eigensolver is O(m eps |A|))
_TOL = {np.float32: 2e-5, np.float64: 1e-11}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m", [2, 21, 64, 128, 200])
def test_top2_eig_sizes_and_dtypes(m, dtype):
    """Descending top-2 eigenvalues match numpy (f64 reference), the
    pair's residual ||A v - w v|| is at roundoff, the vectors are
    orthonormal, and the output keeps the input dtype."""
    rng = np.random.default_rng(m)
    s = _sym(rng, 4, m)
    a = s.astype(dtype)
    vals, vecs = top2_eig(jnp.asarray(a))
    assert vals.dtype == dtype and vecs.dtype == dtype
    assert vals.shape == (4, 2) and vecs.shape == (4, m, 2)
    vals = np.asarray(vals, dtype=np.float64)
    vecs = np.asarray(vecs, dtype=np.float64)
    a64 = a.astype(np.float64)
    want = np.linalg.eigvalsh(a64)[..., ::-1][..., :2]
    scale = np.abs(np.linalg.eigvalsh(a64)).max(axis=-1, keepdims=True)
    tol = _TOL[dtype]
    assert (np.abs(vals - want) / scale).max() < tol
    assert (vals[..., 0] >= vals[..., 1]).all()
    res = a64 @ vecs - vecs * vals[..., None, :]
    assert (np.linalg.norm(res, axis=-2) / scale).max() < 10 * tol
    gram = np.swapaxes(vecs, -1, -2) @ vecs
    np.testing.assert_allclose(gram, np.broadcast_to(np.eye(2), gram.shape),
                               atol=10 * tol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_top2_eig_degenerate_and_tied(dtype):
    """Diagonal, all-equal, zero and tied-top spectra: eigenvalues exact
    to roundoff, no NaN, and the returned vectors span an eigenspace of
    the right eigenvalue (any basis of a repeated eigenvalue is valid)."""
    m = 6
    tied = np.diag([5.0, 5.0, 1.0, 0.0, -1.0, 2.0])
    rot = np.linalg.qr(np.random.default_rng(3).normal(size=(m, m)))[0]
    mats = np.stack([
        np.diag([3.0, -1.0, 2.0, 0.5, 0.0, 1.0]),
        np.full((m, m), 1.0),          # rank one: top-2 = (m, 0)
        np.zeros((m, m)),
        np.eye(m),                      # every eigenvalue tied
        rot @ tied @ rot.T,             # tied top pair, dense
    ]).astype(dtype)
    vals, vecs = top2_eig(jnp.asarray(mats))
    vals = np.asarray(vals, dtype=np.float64)
    vecs = np.asarray(vecs, dtype=np.float64)
    assert np.isfinite(vals).all() and np.isfinite(vecs).all()
    tol = _TOL[dtype] * 10
    want = np.array([[3.0, 2.0], [m, 0.0], [0.0, 0.0], [1.0, 1.0],
                     [5.0, 5.0]])
    np.testing.assert_allclose(vals, want, atol=tol)
    a64 = mats.astype(np.float64)
    res = a64 @ vecs - vecs * vals[..., None, :]
    assert np.abs(res).max() < tol
    gram = np.swapaxes(vecs, -1, -2) @ vecs
    np.testing.assert_allclose(gram, np.broadcast_to(np.eye(2), gram.shape),
                               atol=tol)
