"""Bucketing ragged windows into a few static padded shapes.

Window SNP counts vary; XLA wants static shapes.  Windows are grouped into
power-of-two ``padded_npos`` buckets so that (a) padding waste is bounded by
2x and (b) the number of distinct compiled shapes stays logarithmic
(SURVEY.md §7 "hard parts" #1).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Bucket:
    """A group of windows sharing one padded SNP-count shape."""

    padded_npos: int       # static SNP-axis length for this bucket
    window_ids: np.ndarray  # [Bw] indices into the WindowPlan arrays
    lo: np.ndarray          # [Bw] first SNP index per window
    npos: np.ndarray        # [Bw] true SNP count per window
    slot: np.ndarray        # [Bw] output slot per window


def _next_pow2(n: int, floor: int) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def pad_batch(n: int, floor: int = 8) -> int:
    """Round a batch size up to a power of two (>= ``floor``) so the
    number of distinct compiled shapes stays logarithmic."""
    return _next_pow2(n, floor)


def upload_bucket(bucket: Bucket, sharding=None):
    """Pad a bucket's [Bw] window descriptors to the power-of-two batch
    and upload them as device arrays, optionally placed with the window
    sharding (the engines' one shared pad/upload path — only the [B]
    descriptors travel; gather index matrices are built on device).

    Padding rows repeat lo/npos/slot 0 — harmless: their npos=0 marks
    them invalid, the kernels zero them, and the engines never scatter
    them back.  The three descriptors ship as ONE packed [3, B] transfer
    and are sliced apart on device.  Returns
    (lo_d, npos_d, slot_d)."""
    import jax
    import jax.numpy as jnp

    Bw = len(bucket.window_ids)
    pads = ((0, 0), (0, pad_batch(Bw) - Bw))
    packed = jnp.asarray(
        np.pad(
            np.stack([bucket.lo, bucket.npos, bucket.slot]).astype(
                np.int64
            ),
            pads,
        )
    )
    if sharding is not None:
        packed = jax.device_put(
            packed,
            sharding if packed.ndim == 1 else _row_sharding(sharding),
        )
    return packed[0], packed[1], packed[2]


def _row_sharding(sharding):
    """The window sharding lifted to the packed [3, B] descriptor array
    (replicate the leading row axis, shard the window axis)."""
    import jax

    if isinstance(sharding, jax.sharding.NamedSharding):
        spec = sharding.spec
        return jax.sharding.NamedSharding(
            sharding.mesh, jax.sharding.PartitionSpec(None, *spec)
        )
    return sharding


def replicate(x, sharding):
    """``x`` placed on every device of the window sharding's mesh, so a
    sharded program reads its replicated inputs (the genotype upload)
    from local memory rather than from the default device.  Unchanged
    without a mesh sharding."""
    import jax

    if isinstance(sharding, jax.sharding.NamedSharding):
        return jax.device_put(
            x, jax.sharding.NamedSharding(
                sharding.mesh, jax.sharding.PartitionSpec()
            )
        )
    return x


def bucketize(
    lo: np.ndarray,
    npos: np.ndarray,
    slot: np.ndarray,
    min_pad: int = 32,
    max_batch: int | None = None,
    max_elems: int | None = 1 << 21,
) -> list[Bucket]:
    """Group valid windows (npos > 0) by padded SNP count.

    ``max_batch`` optionally splits a bucket into device-friendly batches so
    a huge chromosome streams through HBM instead of materializing at once.
    ``max_elems`` bounds batch_size * padded_npos (window-rows per batch),
    so dense chromosomes (thousands of SNPs per window) scale the batch
    down instead of materializing multi-GB [B, P, m] gathers: at the
    default 2M rows a stickleback bucket stays under ~350 MB f64.
    """
    valid = np.nonzero(npos > 0)[0]
    if len(valid) == 0:
        return []
    pads = np.array([_next_pow2(int(n), min_pad) for n in npos[valid]])
    buckets: list[Bucket] = []
    for pad in np.unique(pads):
        ids = valid[pads == pad]
        cap = max_batch if max_batch is not None else len(ids)
        if max_elems is not None:
            cap = min(cap, max(8, int(max_elems) // int(pad)))
        chunks = [ids]
        if len(ids) > cap:
            chunks = [ids[i : i + cap] for i in range(0, len(ids), cap)]
        for chunk in chunks:
            buckets.append(
                Bucket(
                    padded_npos=int(pad),
                    window_ids=chunk,
                    lo=lo[chunk],
                    npos=npos[chunk],
                    slot=slot[chunk],
                )
            )
    return buckets


