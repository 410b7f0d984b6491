"""Device mesh construction and window-axis shardings.

The reference parallelizes with a 64-thread pthread pool pulling 100-window
tasks off a mutex-guarded counter (reference statistics/css/threadcss.c:19-25, :226-236).
Here the same work distribution is a 1-D device mesh with the *window*
axis sharded over the devices: windows are embarrassingly parallel (disjoint output
slots, reference statistics/css/threadcss.c:262-269), so no collective is needed for scoring — only
the chromosome-level summary statistics reduce (see ``sharded.py``).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

WINDOW_AXIS = "windows"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the window axis.

    ``n_devices`` limits the mesh to the first n devices (useful for the
    1-vs-N equivalence tests on a virtual CPU mesh)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, have {len(devices)}"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (WINDOW_AXIS,))


def window_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (window-batch) axis across the mesh."""
    return NamedSharding(mesh, P(WINDOW_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    """Fully replicated placement (SNP matrices, configs, keys)."""
    return NamedSharding(mesh, P())


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``n`` (window batches must
    divide evenly over the mesh)."""
    return ((n + m - 1) // m) * m
