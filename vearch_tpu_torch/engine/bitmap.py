"""Deletion bitmap.

Copy of vearch_tpu/engine/bitmap.py for the PyTorch port; a re-design of
the reference's persistent BitmapManager
(reference: internal/engine/util/bitmap_manager.h:19). Deletions never
compact the device-resident vector buffers in the hot path — deleted docids
are masked out inside the top-k kernel instead, which keeps device arrays
append-only and static-shaped.

Host side is a numpy bool array (grows with the docid space); `mask(n)`
hands the search path a validity view. Persistence is a raw .npy file.
"""

from __future__ import annotations

import os

import numpy as np


class BitmapManager:
    def __init__(self, capacity: int = 1024):
        self._bits = np.zeros(max(1, capacity), dtype=bool)  # True = deleted
        self._deleted_count = 0
        self.version = 0  # bumped on every mutation (device-mask cache key)

    def _ensure(self, docid: int) -> None:
        if docid >= self._bits.shape[0]:
            new_cap = max(docid + 1, self._bits.shape[0] * 2)
            grown = np.zeros(new_cap, dtype=bool)
            grown[: self._bits.shape[0]] = self._bits
            self._bits = grown

    def set_deleted(self, docid: int) -> None:
        self._ensure(docid)
        if not self._bits[docid]:
            self._bits[docid] = True
            self._deleted_count += 1
            self.version += 1

    def unset(self, docid: int) -> None:
        self._ensure(docid)
        if self._bits[docid]:
            self._bits[docid] = False
            self._deleted_count -= 1
            self.version += 1

    def is_deleted(self, docid: int) -> bool:
        return docid < self._bits.shape[0] and bool(self._bits[docid])

    @property
    def deleted_count(self) -> int:
        return self._deleted_count

    def valid_mask(self, n: int) -> np.ndarray:
        """[n] bool, True = alive; n is the current docid high-water mark."""
        self._ensure(max(n - 1, 0))
        return ~self._bits[:n]

    def snapshot(self, n: int) -> np.ndarray:
        """Point-in-time copy of the first n bits (caller holds the
        engine write lock; the copy may be persisted lock-free)."""
        return self._bits[: max(n, 1)].copy()

    def dump(self, path: str) -> None:
        np.save(path, self._bits)

    def load(self, path: str) -> None:
        if os.path.exists(path):
            self._bits = np.load(path)
            self._deleted_count = int(self._bits.sum())
            self.version += 1
