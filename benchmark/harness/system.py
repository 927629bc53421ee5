"""The system under test: one engine of vearch_tpu_torch, as a partition
server holds it (`cluster/ps.py` serves `Engine.search`), built from a
configuration's file and the rows the harness made from the seed.

This is the only module of the harness that imports the program, and it
does so inside its functions: the harness's other parts, and the
reference, never load it.
"""

from __future__ import annotations

import time
from itertools import chain

import numpy as np

INGEST_BATCH = 100_000  # docs an Engine.upsert call takes
FIELD = "emb"


def key_of(row: int) -> str:
    """The document key of row `row` (its decimal number)."""
    return str(int(row))


class System:
    """An Engine with the configuration's index over `data`'s rows, the
    deletes applied. `timings` holds the seconds of each set-up step."""

    def __init__(self, config: dict, data, device):
        import torch

        from vearch_tpu_torch.engine.engine import Engine
        from vearch_tpu_torch.engine.types import (
            DataType, FieldSchema, IndexParams, MetricType, TableSchema,
        )
        from vearch_tpu_torch.obs import flight_recorder

        self.torch = torch
        self.device = torch.device(device)
        self.recorder = flight_recorder.install()
        idx = config["index"]
        params = dict(idx["params"])
        # build when the harness asks, not on a background thread
        # mid-ingest
        params["training_threshold"] = 2 * data.n
        schema = TableSchema(config["name"], [FieldSchema(
            FIELD, DataType.VECTOR, dimension=data.dim,
            index=IndexParams(idx["type"], MetricType(idx["metric"]),
                              params))])
        self.engine = Engine(schema, device=self.device)
        self.timings: dict[str, float] = {}
        t0 = time.monotonic()
        rows = data.rows
        for lo in range(0, data.n, INGEST_BATCH):
            hi = min(lo + INGEST_BATCH, data.n)
            self.engine.upsert([{"_id": key_of(j), FIELD: rows[j]}
                                for j in range(lo, hi)])
        self.timings["ingest_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        self.engine.build_index()
        self.sync()
        self.timings["build_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        gone = self.engine.delete([key_of(j) for j in data.deleted])
        if gone != len(data.deleted):
            raise RuntimeError(f"deleted {gone} of {len(data.deleted)} docs")
        self.timings["delete_s"] = time.monotonic() - t0

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    @property
    def index(self):
        return self.engine.indexes[FIELD]

    def request(self, vectors: np.ndarray, traffic: dict,
                trace: dict | None = None):
        """The traffic's search request for the query rows `vectors`."""
        from vearch_tpu_torch.engine.engine import SearchRequest

        return SearchRequest(
            vectors={FIELD: vectors}, k=int(traffic["k"]),
            include_fields=[], raw_results=bool(traffic["raw_results"]),
            index_params=dict(traffic["index_params"]), trace=trace)

    def search(self, req):
        return self.engine.search(req)

    def warm(self, sizes, traffic: dict, queries: np.ndarray,
             repeats: int = 2) -> float:
        """Serve `repeats` requests of each row count in `sizes` as the
        traffic sends them, so every kernel is built and every shape
        first launched before the window; returns the seconds taken."""
        t0 = time.monotonic()
        for b in sizes:
            vecs = queries[np.arange(b) % len(queries)]
            for _ in range(repeats):
                self.search(self.request(vecs, traffic))
        self.sync()
        return time.monotonic() - t0

    def facts(self) -> dict:
        """The index's cell sizes: the longest and the mean, which set the
        probe regime's padded bucket width and so its work."""
        pops = self.index.cell_populations()
        if not pops:
            return {}
        return {"cells": len(pops), "longest_cell": int(max(pops)),
                "mean_cell": float(np.mean(pops))}

    def dispatch_rows(self, b: int) -> int:
        """The rows a dispatch of `b` query rows runs at: the engine's
        padded shape bucket where it pads (Engine.shape_buckets)."""
        if not self.engine.shape_buckets:
            return b
        from vearch_tpu_torch.ops.perf_model import bucket_rows

        return bucket_rows(b)

    def max_rows(self) -> int:
        """Rows the engine's scheduler packs into one dispatch at most."""
        return int(self.engine.micro_batch_max_rows)

    def compile_events(self) -> int:
        """Serving-path compile events the flight recorder has seen
        outside the warm-up scope (a new kernel build or program shape)."""
        return self.recorder.total()

    def close(self) -> None:
        """Stop the engine's threads and free its device memory (again a
        no-op)."""
        if self.engine is None:
            return
        self.engine.close()
        self.engine = None
        import gc

        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()


def keep(result, flat_array: bool = False) -> tuple:
    """What the harness keeps of one request's answers: (hits a query
    [queries] int64, the hits' keys flat, their scores flat f64). Nothing
    of it is a Python object a hit, so a window's millions of hits add no
    work to the garbage collector's full collections, which would stall
    the system: with `flat_array` the keys are a numpy str array and the
    tuple holds no tracked object at all (for the open loop's many small
    requests); else one flat list (cheaper to make for a batch of 1024)."""
    if hasattr(result, "keys") and hasattr(result, "scores"):
        keys = result.keys
        scores = np.asarray(result.scores, dtype=np.float64)
    else:
        keys = [[it.key for it in r.items] for r in result]
        scores = np.asarray([it.score for r in result for it in r.items],
                            dtype=np.float64)
    lens = np.fromiter(map(len, keys), dtype=np.int64, count=len(keys))
    flat = list(chain.from_iterable(keys))
    return lens, np.asarray(flat, dtype=str) if flat_array else flat, scores


def columns(result) -> tuple:
    """`keep`'s tuple of anything Engine.search returned (a kept tuple
    passes through)."""
    return result if isinstance(result, tuple) else keep(result)
