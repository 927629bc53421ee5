"""Disk-resident raw vector store (mmap-backed), the port of
vearch_tpu/engine/disk_vector.py.

Rows live docid-ordered in one flat mmap'd file, `raw.f32` (the name
whatever the dtype), beside a `meta.json` barrier, byte for byte the
reference's files:
- append = write through the mapping (the OS page cache absorbs it);
- growth = ftruncate + remap, no copy (the file is the buffer);
- reads (rerank gathers, training samples) fault pages on demand, so
  host RSS stays bounded by the page cache, not the dataset;
- `flush_disk()` msyncs and records the durable row count in meta.json;
  rows past that count are garbage after a crash.

A bfloat16 store keeps the bf16 bits in a uint16 memmap: rows round to
bf16 with torch (`.to(torch.bfloat16)`, round to nearest even, as the
reference's ml_dtypes cast does) and widen back to f32 through a
`torch.bfloat16` view, so each package opens the other's files.
`host_view()` always reads as float32.

The full-precision file is the rerank and training tier; the scan tier
is the DISKANN index's int8 mmap and HBM bucket cache (index/disk.py).
`device_buffer()` raises: mirroring a beyond-RAM store into device
memory is always a bug upstream. Rerank gathers go through a host-RAM
row cache (tiering/HostRowCache); `row_cache_mb=0` disables it.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from vearch_tpu_torch.device import resolve_device
from vearch_tpu_torch.engine.raw_vector import RawVectorStore
from vearch_tpu_torch.tiering import HostRowCache, readahead

_DTYPES = {"float32": (np.dtype(np.float32), torch.float32),
           "bfloat16": (np.dtype(np.uint16), torch.bfloat16)}


def f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 rows -> their bf16 bits as uint16 (round to nearest even)."""
    t = torch.from_numpy(np.array(x, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bits -> f32 (exact)."""
    a = np.array(bits, dtype=np.uint16, copy=True)
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
        .float().numpy()


class Bf16Rows:
    """Rows of a bf16 file (a uint16 memmap of the bits) that read as
    float32: indexing widens the rows it selects, `np.asarray` the lot."""

    def __init__(self, bits: np.ndarray):
        self.bits = bits

    @property
    def shape(self) -> tuple[int, ...]:
        return self.bits.shape

    def __len__(self) -> int:
        return self.bits.shape[0]

    def __getitem__(self, key) -> np.ndarray:
        return bf16_bits_to_f32(self.bits[key])

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        out = bf16_bits_to_f32(self.bits)
        return out if dtype is None else out.astype(dtype, copy=False)


class DiskRawVectorStore(RawVectorStore):
    durable_on_disk = True

    def __init__(
        self,
        dimension: int,
        directory: str,
        init_capacity: int = 4096,
        store_dtype: str = "float32",
        row_cache_mb: int = 64,
        device=None,
    ):
        # the base __init__ is not called: the host buffer is a memmap
        self.dimension = dimension
        self.device = resolve_device(device)
        if str(store_dtype) not in _DTYPES:
            raise ValueError(f"unknown store_dtype {store_dtype!r} for a "
                             f"disk store; supported: {sorted(_DTYPES)}")
        self.dtype_name = str(store_dtype)
        self._file_dtype, self.store_dtype = _DTYPES[self.dtype_name]
        self._itemsize = self._file_dtype.itemsize
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._raw_path = os.path.join(directory, "raw.f32")
        self._meta_path = os.path.join(directory, "meta.json")
        self._n = 0
        durable_cap = init_capacity
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                meta = json.load(f)
            if meta["dimension"] != dimension:
                raise ValueError(
                    f"disk store at {directory} has dimension "
                    f"{meta['dimension']}, schema says {dimension}")
            if meta.get("dtype", "float32") != self.dtype_name:
                raise ValueError(
                    f"disk store at {directory} was written as "
                    f"{meta.get('dtype')}, schema says {self.dtype_name}")
            self._n = int(meta["n"])
            durable_cap = max(durable_cap, self._n)
        self._host = self._map(max(durable_cap, 1))
        self.row_cache = (
            HostRowCache(dimension, int(row_cache_mb) << 20)
            if row_cache_mb else None
        )

    def _map(self, capacity: int) -> np.memmap:
        rowbytes = self.dimension * self._itemsize
        want = capacity * rowbytes
        have = (os.path.getsize(self._raw_path)
                if os.path.exists(self._raw_path) else 0)
        if have < want:
            with open(self._raw_path, "ab") as f:
                f.truncate(want)
        cap = max(want, have) // rowbytes
        return np.memmap(self._raw_path, dtype=self._file_dtype, mode="r+",
                         shape=(cap, self.dimension))

    def _encode(self, rows: np.ndarray) -> np.ndarray:
        """f32 rows as the file stores them."""
        if self.dtype_name == "bfloat16":
            return f32_to_bf16_bits(rows)
        return np.asarray(rows, dtype=np.float32)

    def _rows(self, raw: np.ndarray) -> np.ndarray:
        """Rows as the file stores them -> f32."""
        if self.dtype_name == "bfloat16":
            return bf16_bits_to_f32(raw)
        return np.asarray(raw, dtype=np.float32)

    def add(self, vectors: np.ndarray) -> int:
        b = vectors.shape[0]
        assert vectors.shape[1] == self.dimension
        if self._n + b > self._host.shape[0]:
            new_cap = max(self._host.shape[0] * 2, self._n + b, 1024)
            self._host.flush()
            self._host = self._map(new_cap)
        start = self._n
        self._host[start: start + b] = self._encode(vectors)
        self._n += b
        return start

    def host_view(self):
        """[n, d] rows that read as float32: the memmap itself for an f32
        store, a widening `Bf16Rows` view for a bf16 one."""
        view = self._host[: self._n]
        return Bf16Rows(view) if self.dtype_name == "bfloat16" else view

    def get(self, docid: int) -> np.ndarray:
        """Single stored row as float32 (partial-update inheritance)."""
        return self.get_rows(np.asarray([docid]))[0]

    def get_rows(self, docids: np.ndarray) -> np.ndarray:
        """Gather [len(docids), d] f32 rows (the rerank path). Hot rows
        come from the host-RAM row cache; misses fault pages in from the
        mmap (rows are append-only and immutable, so cached copies never
        go stale; the load paths clear the cache before rewriting)."""

        def _gather(ids: np.ndarray) -> np.ndarray:
            ids = np.asarray(ids, dtype=np.int64)
            # kernel read-ahead for the strided page faults the gather is
            # about to take (page cache only, zero H2D)
            readahead.advise_rows(self._host, ids)
            return self._rows(self._host[ids])

        if self.row_cache is None:
            return _gather(docids)
        return self.row_cache.get_rows(docids, _gather)

    def device_buffer(self):
        raise RuntimeError(
            "DiskRawVectorStore cannot be mirrored into HBM; use a "
            "disk-aware index type (DISKANN) for this field"
        )

    def flush_disk(self, n: int | None = None) -> None:
        """msync + record the durable row count (the dump barrier). `n`
        pins the recorded count to a snapshot-consistent value: an upsert
        between the snapshot and the flush must not advance the durable
        count past the table dump it pairs with."""
        self._host.flush()
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"n": self._n if n is None else int(n),
                       "dimension": self.dimension,
                       "dtype": self.dtype_name}, f)
        os.replace(tmp, self._meta_path)

    def memory_usage_bytes(self) -> int:
        return 0  # rows live in the page cache, not anonymous memory

    # -- persistence ---------------------------------------------------------

    def dump(self, path: str) -> None:
        """A dump to a foreign directory (backup staging) as f32 .npy;
        an in-place dump flushes through flush_disk()."""
        np.save(path, np.asarray(self.host_view(), dtype=np.float32))

    def _copy_in(self, data: np.ndarray, at: int) -> None:
        step = max(1, (64 << 20) // (self.dimension * 4))
        for lo in range(0, data.shape[0], step):
            hi = min(lo + step, data.shape[0])
            self._host[at + lo: at + hi] = self._encode(data[lo:hi])

    def load(self, path: str) -> None:
        """Restore. With an npy present (foreign-dir backup), copy it into
        the mmap; without one (in-place dump), roll the live count back to
        the durable barrier in meta.json, so table and store counts revert
        together (docid == row id)."""
        if self.row_cache is not None:
            self.row_cache.clear()
        if not os.path.exists(path):
            if os.path.exists(self._meta_path):
                with open(self._meta_path) as f:
                    self._n = int(json.load(f)["n"])
            return
        data = np.load(path, mmap_mode="r")
        self._n = 0
        if self._host.shape[0] < data.shape[0]:
            self._host = self._map(data.shape[0])
        # streamed in chunks: the source may exceed RAM
        self._copy_in(data, 0)
        self._n = data.shape[0]
        self.flush_disk()

    def load_parts(self, paths: list[str]) -> None:
        """Segmented restore: stream each segment slice into the mmap in
        row order (foreign-dir backups of a disk store; in-place dumps
        carry no vector segments and roll back through load())."""
        if not paths:
            return
        if self.row_cache is not None:
            self.row_cache.clear()
        self._n = 0
        total = 0
        for p in paths:
            data = np.load(p, mmap_mode="r")
            if self._host.shape[0] < total + data.shape[0]:
                self._host = self._map(
                    max(total + data.shape[0], self._host.shape[0] * 2))
            self._copy_in(data, total)
            total += data.shape[0]
        self._n = total
        self.flush_disk()
