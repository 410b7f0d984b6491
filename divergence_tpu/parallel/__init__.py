"""Device-mesh parallelism: window-axis sharding, multi-host launch.

Replaces the reference's entire parallel runtime — the 64-thread pthread
pool with its mutex-guarded dynamic task counter (reference
reference statistics/css/threadcss.c:19-25, reference statistics/fisher/threadfisher.c:19-25) — with static SPMD sharding of
the window axis over a :class:`jax.sharding.Mesh` (SURVEY.md §2.5).
"""

from divergence_tpu.parallel.mesh import (
    WINDOW_AXIS,
    make_mesh,
    pad_to_multiple,
    replicated,
    window_sharding,
)
from divergence_tpu.parallel.multihost import (
    HostAssignment,
    WorkRange,
    merge_score_shards,
    partition_chromosomes,
)
from divergence_tpu.parallel.sharded import make_divergence_step

__all__ = [
    "WINDOW_AXIS",
    "make_mesh",
    "window_sharding",
    "replicated",
    "pad_to_multiple",
    "make_divergence_step",
    "HostAssignment",
    "WorkRange",
    "partition_chromosomes",
    "merge_score_shards",
]
