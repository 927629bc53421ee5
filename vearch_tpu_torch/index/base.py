"""Pluggable vector index framework, the port of vearch_tpu/index/base.py.

Contract (as in the reference):
- `add` is append-only with docid == row id; updates and deletes are the
  engine's soft-delete bitmap, indexes never mutate rows in place;
- `search` takes a validity mask (deletions + scalar filter) and applies
  it inside the scan, so k valid results survive;
- `train`/`absorb` keep host-side state swaps atomic.

Device-footprint models (`device_footprint_bytes`, the sampler's model
side) count the tensors the port keeps on the card, which is where they
differ from the reference's (each override says how).
"""

from __future__ import annotations

import abc
import threading
from typing import Any

import numpy as np

from vearch_tpu_torch.engine.raw_vector import RawVectorStore
from vearch_tpu_torch.engine.types import IndexParams, MetricType
from vearch_tpu_torch.ops import perf_model


class VectorIndex(abc.ABC):
    """Base class for all vector index types."""

    #: whether train() must run before the index can serve (IVF family)
    needs_training: bool = False

    def __init__(self, params: IndexParams, store: RawVectorStore):
        self.params = params
        self.store = store
        self.device = store.device
        self.metric: MetricType = params.metric_type
        self.trained = not self.needs_training
        self.indexed_count = 0  # rows absorbed into the index structure
        self._absorb_lock = threading.Lock()

    @property
    def input_dim(self) -> int:
        """Wire-format vector length (binary indexes pack 8 bits a byte,
        as faiss binary vectors are d/8 uint8)."""
        return self.store.dimension

    def decode_input(self, batch: np.ndarray) -> np.ndarray:
        """Decode wire-format vectors [b, input_dim] into the stored
        representation [b, dimension] (identity for float indexes)."""
        return np.asarray(batch, dtype=np.float32)

    @abc.abstractmethod
    def search(
        self,
        queries: np.ndarray,
        k: int,
        valid_mask,
        params: dict | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batch search. queries [B, d] f32; valid_mask: host [n] bool,
        a device bool tensor, or None.

        Returns (scores [B, k] similarity-oriented (higher=better),
        docids [B, k]; -1 and -inf pad missing results), on the host."""

    def train(self, sample: np.ndarray) -> None:
        """Train quantizers on a sample (no-op for non-trained indexes)."""
        self.trained = True

    def absorb(self, upto: int) -> None:
        """Absorb raw-vector rows [indexed_count, upto) into the index
        structure. Indexes that search the raw store just advance."""
        self.indexed_count = upto

    def _raw_store_device_bytes(self) -> int:
        """The raw store's device buffer and |v|^2 column at its
        capacity; nothing for a disk store, whose rows never enter the
        card (the reference's model counts them there too)."""
        if getattr(self.store, "durable_on_disk", False):
            return 0
        return perf_model.raw_store_footprint_bytes(
            self.store.capacity, self.store.dimension,
            self.store.store_dtype.itemsize)

    def device_footprint_bytes(self) -> int:
        """Modelled resident device bytes of this index's state. The
        default covers indexes that search the raw store directly; index
        types with more device state (mirrors, bucket tensors) add it."""
        return self._raw_store_device_bytes()

    def device_footprint_per_device_bytes(self) -> int:
        """Modelled resident bytes on each device: the port serves one
        device, so all of it."""
        return self.device_footprint_bytes()

    def mesh_info(self) -> dict[str, Any] | None:
        """Mesh placement summary; None, as the port serves one device
        (mesh serving is ROADMAP queue 1 item 10)."""
        return None

    def cell_populations(self) -> list[int] | None:
        """Per-cell member counts, None for index types without a coarse
        partitioning."""
        return None

    def reconstruction_error(self, sample: int = 256,
                             seed: int = 0) -> float | None:
        """Mean relative reconstruction error |x - dequant(quant(x))| / |x|
        over `sample` stored rows (the codes scored at serve time, not a
        fresh encode). None when the index stores rows exactly or is
        untrained. Host numpy only: no device work."""
        return None

    def tiering_info(self) -> dict[str, Any] | None:
        """Tiered-storage summary (per-tier hit/miss/pin counters,
        residency bytes), None when this index serves entirely from
        device memory."""
        return None

    def close(self) -> None:
        """Release background resources (prefetch workers). Idempotent;
        a no-op for in-memory indexes."""

    def dump_state(self) -> dict[str, Any]:
        """Arrays a dump persists for this index (`Engine.dump` writes
        them to index_<field>.npz); none for an index that re-absorbs
        from the raw rows."""
        return {}

    def load_state(self, state: dict[str, Any]) -> None:
        pass
