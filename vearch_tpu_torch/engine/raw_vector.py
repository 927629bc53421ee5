"""Raw vector column store with a device-resident mirror, the port of
vearch_tpu/engine/raw_vector.py.

- host side: an append-only numpy f32 buffer with capacity doubling (the
  durable source of truth);
- device side: a [capacity, d] tensor in `store_dtype`, refreshed
  lazily. Appends land in a host dirty tail; the next search copies the
  tail into the device tensor in place (the reference rebuilds the array
  functionally; in place saves a second copy of the buffer). A capacity
  change re-uploads the whole buffer;
- the squared-norm column is derived on the host from the rows as stored
  (bf16-rounded when `store_dtype` is bfloat16), so it is bit-identical
  to the reference's column.

Persistence streams the host rows, never device state: they are f32 for
every `store_dtype` (a bf16 store rounds only on upload), so a dump is a
plain f32 .npy that loads with `allow_pickle=False`, and a load drops
the device copy, which the next `device_buffer()` uploads once.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from vearch_tpu_torch.device import resolve_device
from vearch_tpu_torch.ops import perf_model
from vearch_tpu_torch.ops.distance import host_sqnorms

STORE_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


class RawVectorStore:
    def __init__(
        self,
        dimension: int,
        store_dtype: str = "float32",
        init_capacity: int = 4096,
        device=None,
    ):
        self.dimension = dimension
        self.device = resolve_device(device)
        if str(store_dtype) not in STORE_DTYPES:
            raise ValueError(f"unknown store_dtype {store_dtype!r}; "
                             f"supported: {sorted(STORE_DTYPES)}")
        self.store_dtype = STORE_DTYPES[str(store_dtype)]
        self._host = np.zeros((init_capacity, dimension), dtype=np.float32)
        self._n = 0
        self._device: torch.Tensor | None = None  # [capacity, d]
        self._device_sqnorm: torch.Tensor | None = None  # [capacity] f32
        self._device_rows = 0  # rows already mirrored to the device
        # the batch scheduler's thread and direct searches may flush at
        # once
        self._flush_lock = threading.Lock()

    @property
    def count(self) -> int:
        return self._n

    @property
    def capacity(self) -> int:
        """Rows the buffers hold before the next doubling (the length of
        the device buffer and of the probe scans' validity masks)."""
        return self._host.shape[0]

    def add(self, vectors: np.ndarray) -> int:
        """Append [b, d] rows; returns the first assigned row id (the
        engine keeps row id == docid)."""
        b = vectors.shape[0]
        assert vectors.shape[1] == self.dimension
        if self._n + b > self._host.shape[0]:
            new_cap = max(self._host.shape[0] * 2, self._n + b, 1024)
            grown = np.zeros((new_cap, self.dimension), dtype=np.float32)
            grown[: self._n] = self._host[: self._n]
            self._host = grown
        start = self._n
        self._host[start : start + b] = vectors
        self._n += b
        return start

    def host_view(self) -> np.ndarray:
        """[n, d] float32 host rows (training / absorb path)."""
        return self._host[: self._n]

    def get(self, docid: int) -> np.ndarray:
        return self._host[docid]

    def _stored(self, rows: np.ndarray) -> tuple[torch.Tensor, np.ndarray]:
        """Host rows cast to store_dtype, and their sqnorm column."""
        t = torch.from_numpy(np.ascontiguousarray(rows)).to(self.store_dtype)
        return t, host_sqnorms(t.float().numpy())

    def device_buffer(self) -> tuple[torch.Tensor, torch.Tensor, int]:
        """Returns (base [capacity, d], base_sqnorm [capacity], n_rows),
        flushing any dirty tail first. Rows >= n_rows are padding and must
        be masked by the caller."""
        with self._flush_lock:
            n = self._n
            cap = self._host.shape[0]
            if self._device is None or self._device.shape[0] != cap:
                t, sq = self._stored(self._host)
                self._device = t.to(self.device, copy=True)
                self._device_sqnorm = torch.from_numpy(sq).to(self.device)
                perf_model.note_h2d_bytes(
                    t.numel() * t.element_size() + sq.nbytes)
                self._device_rows = n
            elif self._device_rows < n:
                lo = self._device_rows
                t, sq = self._stored(self._host[lo:n])
                # the rows only, as the reference counts a tail
                perf_model.note_h2d_bytes(t.numel() * t.element_size())
                self._device[lo:n] = t.to(self.device)
                self._device_sqnorm[lo:n] = torch.from_numpy(sq).to(
                    self.device)
                self._device_rows = n
            return self._device, self._device_sqnorm, n

    # -- persistence ---------------------------------------------------------

    def dump(self, path: str) -> None:
        np.save(path, self.host_view())

    def _invalidate_device(self) -> None:
        with self._flush_lock:
            self._device = None
            self._device_sqnorm = None
            self._device_rows = 0

    def load(self, path: str) -> None:
        if os.path.exists(path):
            data = np.load(path)
            self._host = np.asarray(data, dtype=np.float32).copy()
            self._n = data.shape[0]
            self._invalidate_device()

    def load_parts(self, paths: list[str]) -> None:
        """Restore from per-segment row slices in order (the segmented
        dump format; Engine.load concatenates the manifest's segments)."""
        if not paths:
            return
        parts = [np.load(p, mmap_mode="r") for p in paths]
        n = sum(p.shape[0] for p in parts)
        host = np.zeros((max(n, 1024), self.dimension), dtype=np.float32)
        off = 0
        chunk = 1 << 18  # stream from the mmap; never double peak RAM
        for p in parts:
            for lo in range(0, p.shape[0], chunk):
                hi = min(lo + chunk, p.shape[0])
                host[off + lo: off + hi] = p[lo:hi]
            off += p.shape[0]
        self._host = host
        self._n = n
        self._invalidate_device()
