"""Aligned two-population SNP pair — the engines' input contract.

The reference keeps two flattened position-major arrays per group and
assumes their position sets are identical (the kernels index group B's
window with group A's SNP count, reference statistics/fisher/cFisher.c:85-92).  Here the alignment is
*verified* at construction and the matrices are kept 2-D.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from divergence_tpu.io.gtrack import PopulationTrack


@dataclasses.dataclass
class SnpPair:
    """Aligned SNP matrices for two populations on one chromosome."""

    positions: np.ndarray  # [npos] unique sorted positions
    avals: np.ndarray      # [npos, asize] genotype codes
    bvals: np.ndarray      # [npos, bsize]

    def device_values_joint(self, compact: bool = False):
        """Both populations as ONE [npad, asize+bsize] device array
        (group-A columns first), uploaded once and cached — one
        host→device transfer serves both engines and repeated runs
        (device memory holds one genotype copy).

        The SNP axis is padded to the next power of two (fill = -10000,
        the missing code, which counts nothing in any kernel): the
        chromosome-level kernels (``fet_snp_logs``,
        ``dissimilarity_prefix``) would otherwise compile once per
        distinct chromosome length instead of once per power of two.  Window plans never
        index past the true ``npos``, so the pad rows are unreachable
        from any gather.

        ``compact=True`` uploads int16 instead of the host float64 when
        every value is an integer in int16 range (always true for the
        converter's genotype codes {3, -3, 0, -10000},
        reference tools/VCFConvert.py:8-17).  Callers that only *compare*
        values — FET's ``count_tables`` is pure ``==`` counting
        (reference statistics/fisher/cFisher.c:208-238) — get identical results from a 4x
        smaller host→device transfer.  Non-integral values (drosophila
        frequency tracks) fall back to the float upload; a non-compact
        view of int16-safe values is DERIVED on device from the cached
        int16 upload (one ``astype``, exact for int16-range integers)."""
        key = "_device_joint_i16" if compact else "_device_joint"
        if compact and not self._int16_safe():
            compact, key = False, "_device_joint"
        cached = getattr(self, key, None)
        if cached is None:
            import jax.numpy as jnp

            if not compact and self._int16_safe():
                tgt = jnp.result_type(self.avals.dtype)
                cached = self.device_values_joint(compact=True).astype(tgt)
                object.__setattr__(self, key, cached)
                return cached

            n = len(self.positions)
            npad = 8
            while npad < n:
                npad *= 2
            pad = npad - n

            mat = np.concatenate([self.avals, self.bvals], axis=1)
            if compact:
                mat = mat.astype(np.int16)
            elif (
                np.issubdtype(mat.dtype, np.integer)
                and np.iinfo(mat.dtype).min > -10000
            ):
                # the pad sentinel must be representable (int8/uint*
                # would overflow or wrap); int16-safe inputs never
                # reach here, so this is the >32767-range case
                mat = mat.astype(np.int64)
            if pad:
                mat = np.pad(mat, ((0, pad), (0, 0)),
                             constant_values=mat.dtype.type(-10000))
            cached = jnp.asarray(mat)
            object.__setattr__(self, key, cached)
        return cached

    def device_values(self, compact: bool = False):
        """(avals, bvals) device views, sliced from the single joint
        upload (:meth:`device_values_joint`) and cached — kernels that
        take the populations separately share the same HBM transfer."""
        key = (
            "_device_vals_i16"
            if compact and self._int16_safe()
            else "_device_vals"
        )
        cached = getattr(self, key, None)
        if cached is None:
            joint = self.device_values_joint(compact=compact)
            cached = (joint[:, : self.asize], joint[:, self.asize :])
            object.__setattr__(self, key, cached)
        return cached

    def _int16_safe(self) -> bool:
        """True when both matrices hold integers representable in int16
        (cached — one host pass over each matrix)."""
        ok = getattr(self, "_i16_ok", None)
        if ok is None:
            def check(mat):
                if np.issubdtype(mat.dtype, np.integer):
                    return bool(
                        mat.min(initial=0) >= -32768
                        and mat.max(initial=0) <= 32767
                    )
                return bool(
                    np.all(np.abs(mat) <= 32767.0)
                    and np.all(mat == np.trunc(mat))
                )
            ok = check(self.avals) and check(self.bvals)
            object.__setattr__(self, "_i16_ok", ok)
        return ok

    @property
    def asize(self) -> int:
        return self.avals.shape[1]

    @property
    def bsize(self) -> int:
        return self.bvals.shape[1]

    @property
    def npos(self) -> int:
        return len(self.positions)

    def slice_span(self, pos_lo: int, pos_hi: int) -> "SnpPair":
        """New pair restricted to positions in ``[pos_lo, pos_hi]``
        (inclusive, matching the window span contract of
        core/windows.plan_windows).  Used by slot-range multi-host
        partitioning: a host's input is its owned slots' span plus the
        wsize-wstep halo at each cut — window contents, and therefore
        scores and slot-keyed RNG streams, are unchanged."""
        i0 = int(np.searchsorted(self.positions, pos_lo, side="left"))
        i1 = int(np.searchsorted(self.positions, pos_hi, side="right"))
        return SnpPair(
            positions=self.positions[i0:i1],
            avals=self.avals[i0:i1],
            bvals=self.bvals[i0:i1],
        )

    @classmethod
    def from_tracks(cls, a: PopulationTrack, b: PopulationTrack) -> "SnpPair":
        pa = a.positions_unique()
        pb = b.positions_unique()
        if len(pa) != len(pb) or not np.array_equal(pa, pb):
            raise ValueError(
                f"{a.seqid}: population position sets differ "
                f"({len(pa)} vs {len(pb)} SNPs); the divergence statistics "
                "require both groups called at the same SNPs"
            )
        return cls(
            positions=pa,
            avals=a.values_matrix(),
            bvals=b.values_matrix(),
        )

    @classmethod
    def from_flat(
        cls,
        avals: np.ndarray,
        bvals: np.ndarray,
        apos: np.ndarray,
        bpos: np.ndarray,
        asize: int,
        bsize: int,
    ) -> "SnpPair":
        """From the reference's flattened arrays (test/oracle interop)."""
        na = len(avals) // asize
        nb = len(bvals) // bsize
        pa = np.asarray(apos)[: na * asize : asize]
        pb = np.asarray(bpos)[: nb * bsize : bsize]
        if not np.array_equal(pa, pb):
            raise ValueError("population position sets differ")
        return cls(
            positions=pa,
            avals=np.asarray(avals)[: na * asize].reshape(na, asize),
            bvals=np.asarray(bvals)[: nb * bsize].reshape(nb, bsize),
        )
