"""FLAT (exact brute-force) index, the port of vearch_tpu/index/flat.py:
one f32 product over the device-resident raw buffer plus masked top-k,
or, on a disk store, the same product streamed over the mmap in chunks
(`_store_paths.disk_brute_force`). Also the engine's search path below
the training threshold."""

from __future__ import annotations

import numpy as np
import torch

from vearch_tpu_torch.index._store_paths import disk_brute_force, is_disk_store
from vearch_tpu_torch.index.base import VectorIndex
from vearch_tpu_torch.index.registry import register_index
from vearch_tpu_torch.ops import ivf as ivf_ops
from vearch_tpu_torch.ops.distance import brute_force_search, to_device_mask


@register_index("FLAT")
class FlatIndex(VectorIndex):
    needs_training = False

    def search(
        self,
        queries: np.ndarray,
        k: int,
        valid_mask,
        params: dict | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        if is_disk_store(self.store):
            # beyond-RAM store: stream the mmap through the device in
            # fixed-shape chunks instead of mirroring it
            return disk_brute_force(
                self.store, np.asarray(queries, np.float32), k,
                valid_mask, self.metric,
            )
        base, base_sqnorm, n = self.store.device_buffer()
        mask = to_device_mask(valid_mask, n, base.shape[0], self.device)
        ivf_ops.note_dispatch("flat_scan")
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32))
        scores, ids = brute_force_search(
            q.to(self.device).to(base.dtype), base, mask, k, self.metric,
            base_sqnorm,
        )
        return scores.cpu().numpy(), ids.cpu().numpy()
