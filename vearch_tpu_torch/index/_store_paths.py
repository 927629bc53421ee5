"""Store-aware search primitives shared by the index types, the port of
vearch_tpu/index/_store_paths.py.

Two storage regimes exist: device-mirrored memory stores and mmap'd disk
stores (engine/disk_vector.py). Index hot paths branch here:

- `rerank_against_store`: exact rerank of candidate ids — against the
  device-resident raw buffer for memory stores, or through a host mmap
  gather and one [B, r, d] upload for disk stores;
- `disk_brute_force`: an exact scan that streams a disk store through
  the device in fixed-shape chunks (FLAT, and the search below the
  training threshold, on a beyond-RAM store).
"""

from __future__ import annotations

import numpy as np
import torch

from vearch_tpu_torch.engine.types import MetricType
from vearch_tpu_torch.ops import ivf as ivf_ops
from vearch_tpu_torch.ops.distance import brute_force_search

_CHUNK = 262_144  # rows per device chunk of the streaming scan


def is_disk_store(store) -> bool:
    return bool(getattr(store, "durable_on_disk", False))


def rerank_against_store(
    store,
    q: np.ndarray,          # [B, d] f32 (normalized upstream if cosine)
    cand_i: torch.Tensor,   # [B, r] int32 on the store's device
    k: int,
    metric: MetricType,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact rerank of candidate ids against the raw rows."""
    k = min(k, int(cand_i.shape[1]))
    qt = torch.from_numpy(np.ascontiguousarray(q, np.float32))
    if is_disk_store(store):
        ci = cand_i.cpu().numpy()
        safe = np.maximum(ci, 0).astype(np.int64)
        vecs = np.asarray(store.get_rows(safe.ravel()), dtype=np.float32
                          ).reshape(ci.shape[0], ci.shape[1], -1)
        return ivf_ops.exact_rerank_gathered(
            qt.to(store.device), cand_i, torch.from_numpy(vecs).to(
                store.device), k, metric)
    base, base_sqnorm, _ = store.device_buffer()
    return ivf_ops.exact_rerank(
        qt.to(store.device).to(base.dtype), cand_i, base, base_sqnorm,
        k, metric,
    )


def disk_brute_force(
    store,
    queries: np.ndarray,    # [B, d] f32
    k: int,
    valid_mask,
    metric: MetricType,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact scan of a disk store: stream fixed-shape chunks through the
    device and fold the per-chunk top-k on the host. Exact, as FLAT."""
    n = store.count
    k_eff = min(k, max(n, 1))
    host = store.host_view()
    if isinstance(valid_mask, torch.Tensor):
        valid_mask = valid_mask.cpu().numpy()
    q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(
        store.device)
    # chunk = next power of two >= n, capped: small tables pay O(n), not
    # a full 262k-row pad
    chunk = 128
    while chunk < min(n, _CHUNK):
        chunk *= 2
    rows = np.zeros((chunk, store.dimension), dtype=np.float32)
    all_s: list[np.ndarray] = []
    all_i: list[np.ndarray] = []
    for lo in range(0, max(n, 1), chunk):
        hi = min(lo + chunk, n)
        rows[:] = 0.0
        rows[: hi - lo] = host[lo:hi]
        mask = np.zeros(chunk, dtype=bool)
        if valid_mask is None:
            mask[: hi - lo] = True
        else:
            mask[: hi - lo] = np.asarray(valid_mask[lo:hi], dtype=bool)
        s, i = brute_force_search(
            q, torch.from_numpy(rows).to(store.device),
            torch.from_numpy(mask).to(store.device), k_eff, metric)
        s, i = s.cpu().numpy(), i.cpu().numpy()
        all_s.append(s)
        all_i.append(np.where(i >= 0, i + lo, -1))
    s_cat = np.concatenate(all_s, axis=1)
    i_cat = np.concatenate(all_i, axis=1)
    order = np.argsort(-s_cat, axis=1, kind="stable")[:, :k]
    top_s = np.take_along_axis(s_cat, order, axis=1)
    top_i = np.take_along_axis(i_cat, order, axis=1)
    if top_s.shape[1] < k:
        pad = k - top_s.shape[1]
        top_s = np.pad(top_s, ((0, 0), (0, pad)),
                       constant_values=float("-inf"))
        top_i = np.pad(top_i, ((0, 0), (0, pad)), constant_values=-1)
    return top_s, top_i
