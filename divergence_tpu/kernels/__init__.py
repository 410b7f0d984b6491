"""Batched device compute kernels (JAX/XLA).

Submodules are imported lazily by the engines to keep import costs low:

* :mod:`divergence_tpu.kernels.fet`    — Fisher's Exact Test window batch
* :mod:`divergence_tpu.kernels.css`    — CSS dissimilarity/MDS/score batch
* :mod:`divergence_tpu.kernels.perm`   — chunked permutation Monte-Carlo
* :mod:`divergence_tpu.kernels.linalg` — batched top-2 eigensolve
"""
