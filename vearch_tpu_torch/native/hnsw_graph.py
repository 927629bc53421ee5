"""The host-side HNSW graph, the port of vearch_tpu/native/hnsw_graph.py.

The graph is the port's own copy of the reference's C++ source
(csrc/vearch_hnsw.cpp, byte-equal to the JAX package's
csrc/vearch_hnsw.cpp): an independent implementation of Malkov &
Yashunin 2016. It is a CPython extension module, built with g++ against
the running interpreter's headers into vearch_tpu_torch/_build/ at first
use (`ops/_cuda_build.HostExtension`); a failed build raises.

Thread model (as in the reference): one writer (the index's absorb
lock); the C++ side releases the GIL inside add/search, so `_rw` makes
add and search mutually exclusive — the link arrays are not safe to read
mid-insert.
"""

from __future__ import annotations

import threading

import numpy as np

from vearch_tpu_torch.ops._cuda_build import HostExtension

LIBRARY = HostExtension("vearch_hnsw.cpp", "vearch_hnsw")


class HnswGraph:
    """Owning handle over one native HNSW graph."""

    def __init__(self, dim: int, m: int = 16, ef_construction: int = 200,
                 ip: bool = False, seed: int = 0x5EED):
        self._mod = LIBRARY.load()
        self.dim = dim
        self.m = m
        self.ef_construction = ef_construction
        self.ip = ip
        self._h = self._mod.hnsw_new(dim, m, ef_construction, 1 if ip else 0,
                                     seed)
        self._rw = threading.Lock()

    @property
    def count(self) -> int:
        return int(self._mod.hnsw_count(self._h))

    def add(self, rows: np.ndarray) -> int:
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        if rows.ndim != 2 or rows.shape[1] != self.dim:
            raise ValueError(
                f"rows must be [b, {self.dim}], got {rows.shape}")
        with self._rw:
            return int(self._mod.hnsw_add(self._h, rows, rows.shape[0]))

    def search(
        self,
        queries: np.ndarray,
        k: int,
        ef: int,
        valid_mask: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Returns (scores [B, k] similarity-oriented, ids [B, k] int64;
        -inf / -1 padding). `valid_mask` is a bool array over node ids."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(
                f"queries must be [B, {self.dim}], got {q.shape}")
        b = q.shape[0]
        v = None
        if valid_mask is not None:
            v = np.ascontiguousarray(valid_mask, dtype=np.uint8)
        with self._rw:
            if v is not None and v.shape[0] < (n := self.count):
                # nodes added since the caller sized the mask are invalid
                # for this request; pad under the lock so len >= n holds
                v = np.pad(v, (0, n - v.shape[0]))
            out_s, out_i = self._mod.hnsw_search(self._h, q, b, k, ef, v)
        return (
            np.frombuffer(out_s, dtype=np.float32).reshape(b, k).copy(),
            np.frombuffer(out_i, dtype=np.int64).reshape(b, k).copy(),
        )

    def save(self, path: str) -> None:
        with self._rw:
            self._mod.hnsw_save(self._h, path)

    @classmethod
    def load(cls, path: str, dim: int, m: int = 16,
             ef_construction: int = 200, ip: bool = False) -> "HnswGraph":
        g = cls.__new__(cls)
        g._mod = LIBRARY.load()
        g.dim = dim
        g.m = m
        g.ef_construction = ef_construction
        g.ip = ip
        g._h = g._mod.hnsw_load(dim, m, ef_construction, 1 if ip else 0, path)
        g._rw = threading.Lock()
        return g

    def __del__(self):
        # at interpreter exit the module's functions may already be gone
        free = getattr(getattr(self, "_mod", None), "hnsw_free", None)
        if free is not None and getattr(self, "_h", None) is not None:
            free(self._h)
