"""GTrack reading/writing.

The whole pipeline's data contract is the "GTrack valued points" SNP matrix
of the reference: four tab-separated columns ``seqid  start  value
genomeid`` with one row per (SNP, individual), position-major
(reference tools/FisherExactTestSNPTool.py:290,
tools/ClusterSeparationScore.py:302-306, SURVEY.md §1 data model).

Genotype codes: 3 homozygous major, -3 homozygous minor, 0 heterozygous,
-10000 missing (reference tools/VCFConvert.py:8-17).

The reference relies on the HyperBrowser platform for track storage; here a
plain file-based reader produces per-chromosome :class:`PopulationTrack`
arrays directly.  When the native C++ parser (``native/``) is built it is
used automatically for large files; this module is the portable fallback
and the semantics definition.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Iterable

import numpy as np


@dataclasses.dataclass
class PopulationTrack:
    """One population's SNP rows for one chromosome.

    Arrays are flattened position-major exactly like the reference kernels
    expect: element ``vals[k*size + i]`` is individual ``i`` at SNP ``k``
    (reference statistics/css/css.c:291, reference statistics/fisher/cFisher.c:212-216)."""

    seqid: str
    pos: np.ndarray    # [n] int64, each position repeated `size` times
    vals: np.ndarray   # [n] float64 genotype codes
    size: int          # number of individuals

    @property
    def npos(self) -> int:
        return len(self.pos) // self.size if self.size else 0

    def values_matrix(self) -> np.ndarray:
        """[npos, size] genotype matrix."""
        return self.vals[: self.npos * self.size].reshape(self.npos, self.size)

    def positions_unique(self) -> np.ndarray:
        """[npos] unique positions."""
        return self.pos[:: self.size] if self.size else self.pos


def _infer_population_size(pos: np.ndarray) -> int:
    """Run length of the first position (reference statistics/css/comparative.c:25-34)."""
    if len(pos) == 0:
        return 0
    n = int(np.argmax(pos != pos[0]))
    return n if n > 0 else len(pos)


def read_gtrack_points(
    path: str | Path,
    seqids: Iterable[str] | None = None,
) -> dict[str, PopulationTrack]:
    """Read a GTrack valued-points file into per-chromosome tracks.

    Lines starting with ``#`` are headers/comments (the reference C test
    harness skips a fixed 5-line header, reference statistics/css/testcss.c:213-219; we accept any
    number of ``#`` lines anywhere).
    """
    path = Path(path)
    try:
        from divergence_tpu.native import parse_gtrack_native_indexed

        parsed = parse_gtrack_native_indexed(path)
        if parsed is not None:
            return _group_rows_indexed(*parsed, seqids=seqids)
    except ImportError:
        pass

    names, seq_idx, pos, vals = _read_rows_chunked(path)
    return _group_rows_indexed(names, seq_idx, pos, vals, seqids=seqids)


def _read_rows_chunked(
    path: str | Path, block_bytes: int = 16 << 20
) -> tuple[list[str], np.ndarray, np.ndarray, np.ndarray]:
    """Portable fallback parser with bounded per-block memory.

    Reads ~``block_bytes`` of lines at a time and converts each block
    straight into compact numpy arrays (8 B/row) with interned seqids —
    no per-row Python objects outlive a block, so chromosome-scale files
    (hundreds of MB) parse in bounded memory even without the native
    parser."""
    names: list[str] = []
    name_idx: dict[str, int] = {}
    seq_chunks: list[np.ndarray] = []
    pos_chunks: list[np.ndarray] = []
    val_chunks: list[np.ndarray] = []
    with open(path, "r") as fh:
        while True:
            lines = fh.readlines(block_bytes)
            if not lines:
                break
            si = np.empty(len(lines), dtype=np.int64)
            po = np.empty(len(lines), dtype=np.int64)
            va = np.empty(len(lines), dtype=np.float64)
            n = 0
            for line in lines:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                cols = line.split("\t")
                if len(cols) < 3:
                    cols = line.split()
                idx = name_idx.get(cols[0])
                if idx is None:
                    idx = name_idx[cols[0]] = len(names)
                    names.append(cols[0])
                si[n] = idx
                po[n] = int(cols[1])
                va[n] = float(cols[2])
                n += 1
            if n:
                seq_chunks.append(si[:n].copy())
                pos_chunks.append(po[:n].copy())
                val_chunks.append(va[:n].copy())
    if not seq_chunks:
        empty = np.zeros(0, dtype=np.int64)
        return names, empty, empty, np.zeros(0, dtype=np.float64)
    return (
        names,
        np.concatenate(seq_chunks),
        np.concatenate(pos_chunks),
        np.concatenate(val_chunks),
    )


def _group_rows_indexed(
    names: list[str],
    seq_idx: np.ndarray,
    pos: np.ndarray,
    vals: np.ndarray,
    seqids: Iterable[str] | None = None,
) -> dict[str, PopulationTrack]:
    """Group interned-index rows (native parser output).

    Fast path: GTrack files are normally chromosome-contiguous with
    non-decreasing positions inside each chromosome (converters write
    them that way), which two O(n) vectorized checks confirm — then
    grouping is just searchsorted slicing of the arrays as-is, no sort,
    no 3x permutation gather (~20x faster at 11M rows).  Otherwise ONE
    stable lexsort over (seq_idx, pos) — still independent of the
    number of seqids (a per-seqid mask scan is O(n_seqids * n_rows))."""
    tracks: dict[str, PopulationTrack] = {}
    wanted = set(seqids) if seqids is not None else None
    dseq = np.diff(seq_idx)
    if np.all(dseq >= 0) and bool(
        np.all((np.diff(pos) >= 0) | (dseq > 0))
    ):
        seq_s, pos_s, val_s = seq_idx, pos, vals
    else:
        # lexsort keys are last-key-major; stable, so file row order is
        # preserved within equal (seqid, pos) — the population-size
        # contract depends on it
        order = np.lexsort((pos, seq_idx))
        seq_s = seq_idx[order]
        pos_s = pos[order]
        val_s = vals[order]
    # match the haystack dtype: a mismatched needle dtype makes
    # searchsorted cast the FULL 11M-row array (seconds) for a 6-element
    # binary search
    bounds = np.searchsorted(
        seq_s, np.arange(len(names) + 1, dtype=seq_s.dtype)
    )
    for i, name in enumerate(names):
        if wanted is not None and name not in wanted:
            continue
        lo, hi = bounds[i], bounds[i + 1]
        if lo == hi:
            continue
        p = pos_s[lo:hi]
        v = val_s[lo:hi]
        size = _infer_population_size(p)
        if size and len(p) % size != 0:
            raise ValueError(
                f"{name}: row count {len(p)} not a multiple of inferred "
                f"population size {size}"
            )
        tracks[name] = PopulationTrack(name, p, v, size)
    return dict(sorted(tracks.items()))


def gtrack_points_header(genome: str) -> str:
    """Valued-points header (reference tools/VCFConvert.py:49-53)."""
    return (
        "##gtrack version: 1.0\n"
        "##track type: valued points\n"
        "##value type: number\n"
        "###seqid\tstart\tvalue\tgenomeid\n"
        f"####genome={genome}\n"
    )


def write_score_track(
    path: str | Path,
    results: dict[str, tuple[np.ndarray, np.ndarray]],
    wstep: int,
    columns: tuple[str, str] = ("score", "stddev"),
) -> None:
    """Write per-window results as the reference tools do: one tab row
    ``seqid  start  score  aux`` per *nonzero-score* window, start =
    slot * wstep (reference tools/FisherExactTestSNPTool.py:162-189).

    The write is atomic (temp file + rename): ``--resume`` trusts an
    existing part file completely, so a crash mid-write must leave
    either no file or a complete one — never a truncated track that
    would silently corrupt the resumed genome-wide result."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "w") as fh:
        fh.write(f"#seqid\tstart\t{columns[0]}\t{columns[1]}\n")
        for seqid, (scores, aux) in results.items():
            nz = np.nonzero(scores)[0]
            for i in nz:
                fh.write(
                    f"{seqid}\t{i * wstep}\t{float(scores[i])!r}"
                    f"\t{float(aux[i])!r}\n"
                )
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def read_score_track(
    path: str | Path,
) -> tuple[list[str], np.ndarray, np.ndarray, np.ndarray]:
    """Read a score track back: (seqids, starts, col2, col3).

    Mirrors the filter tools' ``preProcessPvalues``
    (reference tools/FilterFisherScores.py:118-131)."""
    seqids: list[str] = []
    starts: list[int] = []
    c2: list[float] = []
    c3: list[float] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            cols = line.split("\t")
            seqids.append(cols[0])
            starts.append(int(cols[1]))
            c2.append(float(cols[2]))
            c3.append(float(cols[3]) if len(cols) > 3 else 0.0)
    return (
        seqids,
        np.asarray(starts, dtype=np.int64),
        np.asarray(c2, dtype=np.float64),
        np.asarray(c3, dtype=np.float64),
    )


def write_segments_track(
    path: str | Path,
    segments: list[tuple[str, int, int]],
    sorted_elements: bool = False,
) -> None:
    """Write a GTrack segments file (region-calling output; reference
    tools/FilterFisherScores.py:75-80)."""
    with open(path, "w") as fh:
        fh.write(
            "##gtrack version: 1.0\n"
            "##track type: segments\n"
            "##uninterrupted data lines: true\n"
            f"##sorted elements: {'true' if sorted_elements else 'false'}\n"
            "##no overlapping elements: true\n"
            "###seqid\tstart\tend\n"
        )
        for seqid, start, end in segments:
            fh.write(f"{seqid}\t{start}\t{end}\n")
