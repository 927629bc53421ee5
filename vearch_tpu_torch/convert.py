"""State carried across from vearch_tpu.

`index_state_from_reference` takes what a vearch_tpu index's
`dump_state()` returns and gives the dict the port's `load_state` takes:
- IVFPQ and SCANN: numpy `centroids`, `codebooks`, `indexed_count`,
  and for IVFPQ with `opq: true` the rotation `opq_R` [d, d];
- IVFFLAT, BINARYIVF and IVFRABITQ: `centroids`, `indexed_count`;
- DISKANN and DISKANN_STATIC: `centroids`, `indexed_count` (the durable
  row count of the scan-tier files; the port rebuilds its bucket lists
  from `assign.i32` up to that count and absorbs the rest);
- HNSW in graph mode: `graph_blob` (the native graph as it saves
  itself, which the port's copy of the graph loads) and `indexed_count`;
  in scan mode the reference keeps no state ({}).
Loading re-absorbs the raw rows through the port's own assign/encode/
quantize path (DISKANN: only the rows its files do not hold), so both
packages then serve the same trained index. No mirror is carried: an
int8 or int4 mirror is rebuilt from the codes by that absorb.
"""

from __future__ import annotations

from typing import Any

import numpy as np


def index_state_from_reference(state: dict[str, Any]) -> dict[str, Any]:
    """Validate and normalise a reference index state dict."""
    if not state:
        return {}
    if "graph_blob" in state:
        return {"graph_blob": np.ascontiguousarray(state["graph_blob"],
                                                   dtype=np.uint8),
                "indexed_count": np.int64(state["indexed_count"])}
    cents = np.ascontiguousarray(state["centroids"], dtype=np.float32)
    if cents.ndim != 2:
        raise ValueError(f"centroids must be [nlist, d], got {cents.shape}")
    out: dict[str, Any] = {
        "centroids": cents,
        "indexed_count": np.int64(state.get("indexed_count", 0)),
    }
    if "codebooks" in state:
        cb = np.ascontiguousarray(state["codebooks"], dtype=np.float32)
        if cb.ndim != 3 or cb.shape[0] * cb.shape[2] != cents.shape[1]:
            raise ValueError(
                f"codebooks {cb.shape} do not split dimension "
                f"{cents.shape[1]}")
        out["codebooks"] = cb
    if "opq_R" in state:
        rot = np.ascontiguousarray(state["opq_R"], dtype=np.float32)
        d = cents.shape[1]
        if rot.shape != (d, d) or "codebooks" not in out:
            raise ValueError(
                f"opq_R {rot.shape} needs codebooks and shape ({d}, {d})")
        out["opq_R"] = rot
    return out
