"""Scalar index implementations.

Copy of vearch_tpu/scalar/indexes.py for the PyTorch port (the port
imports nothing of vearch_tpu); a re-design of the reference's scalar
index family (reference:
internal/engine/table/scalar_index.h:28 `ScalarIndex` ABC;
inverted_index.h:24 RocksDB (field,value,docid) keys with range scan;
bitmap_index.h:23 roaring bitmaps). RocksDB key scans become sorted numpy
arrays with `searchsorted` range slicing; roaring bitmaps become packed
numpy bool arrays — both produce the docid masks the search kernel consumes
directly.

All indexes are append-only over docids (updates soft-delete the old row,
so stale entries are masked by the deletion bitmap downstream — no index
maintenance on delete, same as the vector side).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from vearch_tpu_torch.scalar.filter import Condition, _eval_fixed


class InvertedScalarIndex:
    """Sorted (value, docid) pairs with lazy re-sort; range + term queries.

    The numpy analogue of the reference's RocksDB inverted index
    (reference: table/inverted_index.h:24): ordered key scan ->
    searchsorted slice over a value-sorted array.
    """

    def __init__(self, dtype: np.dtype):
        import threading

        self.dtype = dtype
        self._values = np.zeros(0, dtype=dtype)
        self._docids = np.zeros(0, dtype=np.int64)
        self._pending_values: list[Any] = []
        self._pending_docids: list[int] = []
        self._sorted = True
        # lazy sorting mutates at QUERY time: concurrent searches /
        # upserts must not interleave with the re-sort
        self._sort_lock = threading.Lock()

    def add(self, value: Any, docid: int) -> None:
        with self._sort_lock:
            self._pending_values.append(value)
            self._pending_docids.append(docid)

    def _ensure_sorted(self) -> None:
        with self._sort_lock:
            if self._pending_values:
                v = np.asarray(self._pending_values, dtype=self.dtype)
                d = np.asarray(self._pending_docids, dtype=np.int64)
                self._values = np.concatenate([self._values, v])
                self._docids = np.concatenate([self._docids, d])
                self._pending_values.clear()
                self._pending_docids.clear()
                self._sorted = False
            if not self._sorted:
                order = np.argsort(self._values, kind="stable")
                self._values = self._values[order]
                self._docids = self._docids[order]
                self._sorted = True

    def query(self, cond: Condition, n: int) -> np.ndarray:
        self._ensure_sorted()
        op, v = cond.operator, cond.value
        vals, docs = self._values, self._docids
        if op in ("IN", "NOT IN"):
            wanted = v if isinstance(v, (list, tuple)) else [v]
            hits: list[np.ndarray] = []
            for w in wanted:
                lo = np.searchsorted(vals, w, side="left")
                hi = np.searchsorted(vals, w, side="right")
                hits.append(docs[lo:hi])
            ids = np.concatenate(hits) if hits else np.zeros(0, np.int64)
            mask = np.zeros(n, dtype=bool)
            mask[ids[ids < n]] = True
            return ~mask if op == "NOT IN" else mask
        if op == "<":
            sel = docs[: np.searchsorted(vals, v, side="left")]
        elif op == "<=":
            sel = docs[: np.searchsorted(vals, v, side="right")]
        elif op == ">":
            sel = docs[np.searchsorted(vals, v, side="right"):]
        elif op == ">=":
            sel = docs[np.searchsorted(vals, v, side="left"):]
        elif op == "=":
            lo = np.searchsorted(vals, v, side="left")
            hi = np.searchsorted(vals, v, side="right")
            sel = docs[lo:hi]
        else:  # != / <>
            lo = np.searchsorted(vals, v, side="left")
            hi = np.searchsorted(vals, v, side="right")
            sel = np.concatenate([docs[:lo], docs[hi:]])
        mask = np.zeros(n, dtype=bool)
        mask[sel[sel < n]] = True
        return mask


class CompositeScalarIndex:
    """Multi-column index over sorted composite keys (reference:
    table/composite_index.h:38 — multi-column RocksDB keys; the manager's
    composite strategy, scalar_index_manager.h:27).

    Rows sort lexicographically by the member fields' values, so — like
    an ordered RocksDB key scan — one lookup serves:
    - equality on any PREFIX of the member fields, and
    - optionally one range condition on the NEXT field after the prefix
    (classic composite-key semantics). Everything else falls back to the
    per-field path in the planner.
    """

    def __init__(self, fields: list[str]):
        import threading

        self.fields = list(fields)
        self._rows: list[tuple] = []  # (v1, ..., vk, docid)
        self._sorted = True
        # the lazy sort mutates _rows at QUERY time; list.sort detaches
        # the list mid-sort, so an unsynchronized concurrent search
        # would silently see an empty index and a concurrent add would
        # raise "list modified during sort"
        self._sort_lock = threading.Lock()

    def add(self, values: tuple, docid: int) -> None:
        with self._sort_lock:
            self._rows.append(tuple(values) + (docid,))
            self._sorted = False

    def _ensure_sorted(self) -> None:
        with self._sort_lock:
            if not self._sorted:
                self._rows.sort(key=lambda t: t[:-1])
                self._sorted = True

    def _prefix_bounds(self, lo: int, hi: int, col: int, value,
                       side_left: bool) -> int:
        """Binary search within rows[lo:hi] on column `col` (rows are
        sorted on that column inside an equal prefix)."""
        rows = self._rows
        while lo < hi:
            mid = (lo + hi) // 2
            v = rows[mid][col]
            if v < value or (not side_left and v == value):
                lo = mid + 1
            else:
                hi = mid
        return lo

    def query_prefix(self, eq_values: tuple, range_cond: "Condition | None",
                     n: int) -> np.ndarray:
        """Mask for (field1 = v1 AND ... AND fieldp = vp [AND
        field{p+1} <op> w]) with p = len(eq_values). A probe value whose
        type cannot be compared with the stored values matches nothing
        (the dict-index behavior this replaces), never crashes."""
        self._ensure_sorted()
        mask = np.zeros(n, dtype=bool)
        lo, hi = 0, len(self._rows)
        try:
            for col, v in enumerate(eq_values):
                lo = self._prefix_bounds(lo, hi, col, v, side_left=True)
                hi = self._prefix_bounds(lo, hi, col, v, side_left=False)
            if range_cond is not None and lo < hi:
                col = len(eq_values)
                op, w = range_cond.operator, range_cond.value
                if op == "<":
                    hi = self._prefix_bounds(lo, hi, col, w, side_left=True)
                elif op == "<=":
                    hi = self._prefix_bounds(lo, hi, col, w, side_left=False)
                elif op == ">":
                    lo = self._prefix_bounds(lo, hi, col, w, side_left=False)
                elif op == ">=":
                    lo = self._prefix_bounds(lo, hi, col, w, side_left=True)
                else:
                    raise ValueError(
                        f"composite range does not support {op!r}"
                    )
        except TypeError:
            return mask  # incomparable probe value: no matches
        if lo < hi:
            ids = np.fromiter(
                (t[-1] for t in self._rows[lo:hi]), dtype=np.int64,
                count=hi - lo,
            )
            mask[ids[ids < n]] = True
        return mask


class BitmapScalarIndex:
    """Per-distinct-value packed bitmap — for low-cardinality fields
    (reference: table/bitmap_index.h:23 roaring bitmaps)."""

    def __init__(self):
        self._bitmaps: dict[Any, np.ndarray] = {}
        self._size = 0

    def add(self, value: Any, docid: int) -> None:
        values = value if isinstance(value, (list, tuple)) else [value]
        need = docid + 1
        for v in values:
            bm = self._bitmaps.get(v)
            if bm is None or bm.shape[0] < need:
                grown = np.zeros(max(need, 1024, 2 * (bm.shape[0] if bm is not None else 0)), dtype=bool)
                if bm is not None:
                    grown[: bm.shape[0]] = bm
                self._bitmaps[v] = grown
                bm = grown
            bm[docid] = True
        self._size = max(self._size, need)

    def query(self, cond: Condition, n: int) -> np.ndarray:
        op, v = cond.operator, cond.value
        if op in ("<", "<=", ">", ">="):
            # range over the distinct values we know
            keys = [k for k in self._bitmaps if _eval_fixed(np.asarray([k]), cond)[0]]
        elif op in ("=", "IN"):
            keys = v if isinstance(v, (list, tuple)) else [v]
        elif op in ("!=", "<>", "NOT IN"):
            excl = set(v) if isinstance(v, (list, tuple)) else {v}
            keys = [k for k in self._bitmaps if k not in excl]
        else:
            raise ValueError(f"unsupported operator {op} on bitmap index")
        mask = np.zeros(n, dtype=bool)
        for k in keys:
            bm = self._bitmaps.get(k)
            if bm is not None:
                ln = min(n, bm.shape[0])
                mask[:ln] |= bm[:ln]
        return mask
