"""Docid-ordered compressed device mirror, the port of
vearch_tpu/index/int8_mirror.py.

Append-only host arrays (codes, per-row scale, squared norm) with a
lazily flushed device copy: a capacity change re-uploads everything,
otherwise only the rows appended since the last flush are copied, in
place. Capacity stays a multiple of 512 — the block-max scan reduces
each 512-row block to its maximum. `storage` picks the row payload:
"int8" (per-row scaled int8, d bytes a row), "int4" (per-row scaled
int4, two values a byte, d/2 bytes a row: half the resident bytes of
int8's payload) or "bits" (packed sign planes, ceil(d/8) bytes a row:
IVFRABITQ's stage-0 tier, ops/binary_scan.pack_sign_rows).
`flush_sharded(mesh)` places the same rows row-sharded over a mesh.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from vearch_tpu_torch.device import resolve_device
from vearch_tpu_torch.ops import perf_model
from vearch_tpu_torch.ops.binary_scan import pack_sign_rows
from vearch_tpu_torch.parallel.mesh import ShardedRowCache


def quantize_rows(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization; returns (q8, scale, vsq)."""
    scale = np.maximum(np.abs(rows).max(axis=1) / 127.0, 1e-12).astype(
        np.float32
    )
    q8 = np.clip(np.rint(rows / scale[:, None]), -127, 127).astype(np.int8)
    deq = q8.astype(np.float32) * scale[:, None]
    vsq = np.sum(deq * deq, axis=1).astype(np.float32)
    return q8, scale, vsq


def quantize_rows_int4(
    rows: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-row symmetric int4 quantization, nibble-packed.

    Layout contract (ops/ivf.py unpack_int4): dims [0, d/2) in the low
    nibble, dims [d/2, d) in the high nibble, a concat, not an
    interleave. Returns (packed [n, d/2] uint8, scale, vsq of the
    dequantized rows)."""
    d = rows.shape[1]
    if d % 2 != 0:
        raise ValueError("int4 storage needs an even dimension")
    scale = np.maximum(np.abs(rows).max(axis=1) / 7.0, 1e-12).astype(
        np.float32
    )
    q4 = np.clip(np.rint(rows / scale[:, None]), -7, 7).astype(np.int8)
    deq = q4.astype(np.float32) * scale[:, None]
    vsq = np.sum(deq * deq, axis=1).astype(np.float32)
    lo = q4[:, : d // 2] & 0xF
    hi = q4[:, d // 2:] & 0xF
    packed = (lo | (hi << 4)).astype(np.uint8)
    return packed, scale, vsq


class Int8Mirror:
    def __init__(self, dimension: int, storage: str = "int8", device=None):
        self.storage = str(storage).lower()
        if self.storage == "int8":
            self._row_width, self._row_dtype = dimension, np.int8
        elif self.storage == "int4":
            if dimension % 2 != 0:
                raise ValueError(
                    "int4 mirror storage needs an even dimension")
            self._row_width, self._row_dtype = dimension // 2, np.uint8
        elif self.storage == "bits":  # byte-padded packed sign planes
            self._row_width, self._row_dtype = -(-dimension // 8), np.uint8
        else:
            raise ValueError(f"unknown mirror storage {storage!r}")
        self.dimension = dimension
        self.device = resolve_device(device)
        self._h8 = np.zeros((0, self._row_width), dtype=self._row_dtype)
        self._h_scale = np.zeros(0, dtype=np.float32)
        self._h_vsq = np.zeros(0, dtype=np.float32)
        self._n = 0
        self._d8: torch.Tensor | None = None
        self._d_scale: torch.Tensor | None = None
        self._d_vsq: torch.Tensor | None = None
        self._d_rows = 0
        # a concurrent append may replace the host arrays (capacity
        # growth) while a flush reads them
        self._flush_lock = threading.Lock()

    @property
    def count(self) -> int:
        return self._n

    def device_bytes(self) -> int:
        """Bytes of the flushed mirror: row payload plus per-row scale and
        |v|^2, at the 512-aligned capacity."""
        cap = self._h8.shape[0]
        return cap * self._row_width + 2 * cap * 4

    def append_quantized(
        self, q8: np.ndarray, scale: np.ndarray, vsq: np.ndarray,
        start: int | None = None,
    ) -> None:
        """Write rows at [start, start+b) (default: append at count)."""
        with self._flush_lock:
            start = self._n if start is None else start
            need = start + q8.shape[0]
            if self._h8.shape[0] < need:
                cap = max(need, self._h8.shape[0] * 2, 1024)
                cap = -(-cap // 512) * 512
                g8 = np.zeros((cap, self._row_width), dtype=self._row_dtype)
                gs = np.zeros(cap, dtype=np.float32)
                gv = np.zeros(cap, dtype=np.float32)
                g8[: self._n] = self._h8[: self._n]
                gs[: self._n] = self._h_scale[: self._n]
                gv[: self._n] = self._h_vsq[: self._n]
                self._h8, self._h_scale, self._h_vsq = g8, gs, gv
            sl = slice(start, need)
            self._h8[sl] = q8
            self._h_scale[sl] = scale
            self._h_vsq[sl] = vsq
            self._n = max(self._n, need)
            # rows below the mirrored high-water mark were overwritten
            # (re-absorb after load_state): re-upload from `start`
            if start < self._d_rows:
                self._d_rows = start
            if self._sh_cache is not None:
                self._sh_cache.lower_rows(start)

    def append(self, rows: np.ndarray, start: int | None = None) -> None:
        quant = {"int8": quantize_rows, "int4": quantize_rows_int4,
                 "bits": pack_sign_rows}[self.storage]
        self.append_quantized(*quant(rows), start=start)

    _sh_cache = None

    def flush_sharded(self, mesh) -> tuple:
        """The mirror row-sharded over the mesh's "data" axis (MeshArrays
        of the row payload, scale and |v|^2), each shard 512-aligned for
        the block-max scan; growth within the placed capacity
        tail-appends only the new rows (parallel/mesh.ShardedRowCache)."""
        if self._sh_cache is None:
            self._sh_cache = ShardedRowCache(align=512)

        def build(cap):
            h8 = np.zeros((cap, self._row_width), dtype=self._row_dtype)
            hs = np.zeros(cap, dtype=np.float32)
            hv = np.zeros(cap, dtype=np.float32)
            n = self._n
            h8[:n] = self._h8[:n]
            hs[:n] = self._h_scale[:n]
            hv[:n] = self._h_vsq[:n]
            return h8, hs, hv

        def append(lo, hi):
            return (np.ascontiguousarray(self._h8[lo:hi]),
                    np.ascontiguousarray(self._h_scale[lo:hi]),
                    np.ascontiguousarray(self._h_vsq[lo:hi]))

        with self._flush_lock:
            arrays, _ = self._sh_cache.get(mesh, self._n, build, append)
        return arrays

    def flush(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Device views [cap, width] row payload / [cap] f32 / [cap] f32;
        rows >= count are padding."""
        with self._flush_lock:
            n = self._n
            cap = self._h8.shape[0]
            if self._d8 is None or self._d8.shape[0] != cap:
                self._d8 = torch.from_numpy(self._h8).to(
                    self.device, copy=True)
                self._d_scale = torch.from_numpy(self._h_scale).to(
                    self.device, copy=True)
                self._d_vsq = torch.from_numpy(self._h_vsq).to(
                    self.device, copy=True)
                perf_model.note_h2d_bytes(self._h8.nbytes
                                          + self._h_scale.nbytes
                                          + self._h_vsq.nbytes)
                self._d_rows = n
            elif self._d_rows < n:
                sl = slice(self._d_rows, n)
                perf_model.note_h2d_bytes(self._h8[sl].nbytes
                                          + self._h_scale[sl].nbytes
                                          + self._h_vsq[sl].nbytes)
                self._d8[sl] = torch.from_numpy(self._h8[sl]).to(self.device)
                self._d_scale[sl] = torch.from_numpy(
                    self._h_scale[sl]).to(self.device)
                self._d_vsq[sl] = torch.from_numpy(
                    self._h_vsq[sl]).to(self.device)
                self._d_rows = n
            return self._d8, self._d_scale, self._d_vsq
