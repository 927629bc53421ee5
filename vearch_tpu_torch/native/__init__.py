"""Host-side native code of the port: the HNSW graph (hnsw_graph.py) and
the cluster plane's host loops.

The host loops are the port's copy of the reference's C++ source
(csrc/vearch_native.cpp, byte-equal to the JAX package's): a CPython
extension module built with g++ into vearch_tpu_torch/_build/ at first
use (`ops/_cuda_build.HostExtension`). A failed build raises; there is
no numpy fallback.

API (numpy in/out, the reference's):
    murmur3_batch(keys: list[str]) -> np.uint32[n]
    merge_topk(scores f32[B, M], ids i64[B, M], k, descending=True)
        -> (f32[B, k], i64[B, k])
    read_fvecs(path, max_n=-1) -> np.float32[n, d]
"""

from __future__ import annotations

import numpy as np

from vearch_tpu_torch.ops._cuda_build import HostExtension

LIBRARY = HostExtension("vearch_native.cpp", "vearch_native")


def murmur3_batch(keys: list) -> np.ndarray:
    """murmur3-32 (seed 0) of each key's UTF-8 bytes: the router's slot."""
    raw = LIBRARY.load().murmur3_batch([str(k) for k in keys], 0)
    return np.frombuffer(raw, dtype="<u4")


def merge_topk(
    scores: np.ndarray, ids: np.ndarray, k: int, descending: bool = True
) -> tuple[np.ndarray, np.ndarray]:
    scores = np.ascontiguousarray(scores, dtype=np.float32)
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    b, m = scores.shape
    k = min(k, m)
    out_s, out_i = LIBRARY.load().merge_topk(
        scores.tobytes(), ids.tobytes(), b, m, k, descending)
    return (
        np.frombuffer(out_s, dtype=np.float32).reshape(b, k).copy(),
        np.frombuffer(out_i, dtype=np.int64).reshape(b, k).copy(),
    )


def read_fvecs(path: str, max_n: int = -1) -> np.ndarray:
    raw, n, d = LIBRARY.load().read_fvecs(path, max_n)
    return np.frombuffer(raw, dtype=np.float32).reshape(n, d).copy()
