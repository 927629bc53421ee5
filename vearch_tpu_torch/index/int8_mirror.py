"""Docid-ordered compressed device mirror, the port of
vearch_tpu/index/int8_mirror.py.

Append-only host arrays (codes, per-row scale, squared norm) with a
lazily flushed device copy: a capacity change re-uploads everything,
otherwise only the rows appended since the last flush are copied, in
place. Capacity stays a multiple of 512 — the block-max scan reduces
each 512-row block to its maximum. `storage` picks the row payload:
"int8" (per-row scaled int8, d bytes a row) or "bits" (packed sign
planes, ceil(d/8) bytes a row: IVFRABITQ's stage-0 tier,
ops/binary_scan.pack_sign_rows). The reference's "int4" is not ported
yet (ROADMAP queue 1 item 3).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from vearch_tpu_torch.device import resolve_device
from vearch_tpu_torch.ops.binary_scan import pack_sign_rows


def quantize_rows(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization; returns (q8, scale, vsq)."""
    scale = np.maximum(np.abs(rows).max(axis=1) / 127.0, 1e-12).astype(
        np.float32
    )
    q8 = np.clip(np.rint(rows / scale[:, None]), -127, 127).astype(np.int8)
    deq = q8.astype(np.float32) * scale[:, None]
    vsq = np.sum(deq * deq, axis=1).astype(np.float32)
    return q8, scale, vsq


class Int8Mirror:
    def __init__(self, dimension: int, storage: str = "int8", device=None):
        self.storage = str(storage).lower()
        if self.storage == "int4":
            raise NotImplementedError(
                "int4 mirror storage is not ported yet (ROADMAP queue 1 "
                "item 3)")
        if self.storage == "int8":
            self._row_width, self._row_dtype = dimension, np.int8
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

    def append(self, rows: np.ndarray, start: int | None = None) -> None:
        quant = pack_sign_rows if self.storage == "bits" else quantize_rows
        self.append_quantized(*quant(rows), start=start)

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
                self._d_rows = n
            elif self._d_rows < n:
                sl = slice(self._d_rows, n)
                self._d8[sl] = torch.from_numpy(self._h8[sl]).to(self.device)
                self._d_scale[sl] = torch.from_numpy(
                    self._h_scale[sl]).to(self.device)
                self._d_vsq[sl] = torch.from_numpy(
                    self._h_vsq[sl]).to(self.device)
                self._d_rows = n
            return self._d8, self._d_scale, self._d_vsq
