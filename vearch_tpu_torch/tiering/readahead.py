"""madvise(MADV_WILLNEED) read-ahead for the NVMe mmap gather paths, a
copy of vearch_tpu/tiering/readahead.py (numpy and mmap only).

A cold slab fetch or rerank gather is a strided walk over an mmap: each
touched row faults its page synchronously, so a 256-row gather spread
over 256 distinct pages pays 256 serialized NVMe round-trips. Advising
the kernel about the row runs FIRST lets it batch those faults into a
few large asynchronous reads before the copy loop touches anything —
the classic `madvise` read-ahead the ROADMAP carried for the tiering
gather path.

Host-side only: this changes page-cache behaviour, never bytes moved to
the device — the warm-path H2D ledger stays exactly zero. Purely
advisory and best-effort: any platform that lacks `mmap.madvise`
(py<3.8, non-Linux) or rejects the advice silently degrades to the
plain faulting gather.
"""

from __future__ import annotations

import mmap as _mmap_mod

import numpy as np

#: rows whose gaps are below this many rows are coalesced into one
#: advised run — one big readahead beats many tiny ones, and NVMe
#: sequential bandwidth makes over-reading small gaps free
_GAP_ROWS = 32

#: cap on advised runs per gather: a pathological id spread should cost
#: a bounded number of madvise syscalls, not one per row
_MAX_RUNS = 64


def _coalesce(ids: np.ndarray, gap: int = _GAP_ROWS) -> list[tuple[int, int]]:
    """Sorted docids -> [(start_row, n_rows)] contiguous-ish runs."""
    if ids.size == 0:
        return []
    s = np.sort(np.asarray(ids, dtype=np.int64))
    # run boundaries where the gap to the previous id exceeds the merge
    # threshold; everything between boundaries is advised as one run
    breaks = np.nonzero(np.diff(s) > gap)[0]
    starts = np.concatenate(([0], breaks + 1))
    ends = np.concatenate((breaks, [s.size - 1]))
    return [(int(s[a]), int(s[b] - s[a] + 1)) for a, b in zip(starts, ends)]


def advise_rows(arr: np.ndarray, ids: np.ndarray) -> int:
    """Advise WILLNEED for the pages holding `arr[ids]` when `arr` is an
    np.memmap. Returns the number of advised runs (0 = no-op: in-memory
    array, unsupported platform, or empty id set). Never raises."""
    mm = getattr(arr, "_mmap", None)
    if mm is None or not hasattr(mm, "madvise"):
        return 0
    try:
        row_bytes = int(arr.strides[0]) if arr.ndim > 1 else int(arr.itemsize)
        if row_bytes <= 0:
            return 0
        base = int(getattr(arr, "offset", 0))
        page = _mmap_mod.ALLOCATIONGRANULARITY
        runs = _coalesce(np.asarray(ids))
        if len(runs) > _MAX_RUNS:
            # one spanning advisement: bounded syscalls, and WILLNEED
            # over-reading is cheap relative to per-row faults
            lo = runs[0][0]
            hi = runs[-1][0] + runs[-1][1]
            runs = [(lo, hi - lo)]
        advised = 0
        for start_row, n_rows in runs:
            off = base + start_row * row_bytes
            length = n_rows * row_bytes
            # madvise must be page-aligned: round the start down and
            # extend the length to cover the tail row's page
            aligned = (off // page) * page
            length += off - aligned
            end = min(aligned + length, len(mm))
            if end <= aligned:
                continue
            mm.madvise(_mmap_mod.MADV_WILLNEED, aligned, end - aligned)
            advised += 1
        return advised
    except (OSError, ValueError, AttributeError):
        return 0
