#!/usr/bin/env python
"""Quickstart of the PyTorch port: standalone cluster, a space, some
vectors, one profiled search with its phase breakdown printed.

Runs entirely in-process (master + 2 PS + router threads) — no
deployment needed. The partition servers' engines run on `--device`,
the card by default:

    python examples/python/quickstart_torch.py               # on the card
    python examples/python/quickstart_torch.py --device cpu  # on the CPU

The profiled search at the end is the profile=true explain surface
(docs/OBSERVABILITY.md): per-partition phase timings and the device
dispatches the query actually launched, next to the perf model's
prediction for the matched serving path.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

from vearch_tpu_torch.cluster.standalone import StandaloneCluster  # noqa: E402
from vearch_tpu_torch.sdk.client import VearchClient  # noqa: E402

D = 32
N = 200


def main(device: str | None = None) -> int:
    rng = np.random.default_rng(7)
    with tempfile.TemporaryDirectory() as data_dir:
        cluster = StandaloneCluster(data_dir=data_dir, n_ps=2,
                                    ps_kwargs={"device": device})
        cluster.start()
        try:
            client = VearchClient(cluster.router_addr)
            client.create_database("quickstart")
            client.create_space("quickstart", {
                "name": "articles",
                "partition_num": 2,
                "fields": [
                    {"name": "topic", "data_type": "integer"},
                    {"name": "embedding", "data_type": "vector",
                     "dimension": D,
                     "index": {"index_type": "FLAT",
                               "metric_type": "L2", "params": {}}},
                ],
            })

            vecs = rng.standard_normal((N, D)).astype(np.float32)
            extra = rng.standard_normal((20, D)).astype(np.float32)
            client.upsert("quickstart", "articles", [
                {"_id": f"doc-{i}", "topic": i % 5, "embedding": vecs[i]}
                for i in range(N)
            ])
            print(f"indexed {N} docs across 2 partitions")

            # plain search: per-query hit lists
            hits = client.search(
                "quickstart", "articles",
                [{"field": "embedding", "feature": vecs[42]}], limit=3)
            print("top hit:", hits[0][0]["_id"],
                  f"(score {hits[0][0]['_score']:.4f})")
            assert hits[0][0]["_id"] == "doc-42"

            # profiled search: documents + the explain breakdown
            out = client.search(
                "quickstart", "articles",
                [{"field": "embedding", "feature": vecs[42]}],
                limit=3, profile=True)
            prof = out["profile"]
            print(f"\nprofile ({prof['partition_count']} partitions, "
                  f"router merge {prof['merge_ms']} ms):")
            for pid, part in sorted(prof["partitions"].items()):
                print(f"  partition {pid}: rpc {part['rpc_ms']} ms, "
                      f"{part['doc_count']} docs")
                for phase, ms in sorted(part["phases"].items()):
                    print(f"    {phase:<14} {ms:8.3f} ms")
                disp = part["dispatches"]
                print(f"    dispatches    {disp['tags']} "
                      f"(path={disp['path']}, "
                      f"predicted={disp['predicted']})")
                assert disp["tags"] == disp["predicted"]

            # profiled write: the same explain surface for mutations —
            # raft propose wait, WAL append+fsync, commit wait, apply
            out = client.upsert("quickstart", "articles", [
                {"_id": f"doc-{N + i}", "topic": i % 5,
                 "embedding": extra[i]}
                for i in range(20)
            ], profile=True)
            wprof = out["profile"]
            print(f"\nwrite profile ({wprof['partition_count']} "
                  f"partitions, router merge {wprof['merge_ms']} ms):")
            for pid, part in sorted(wprof["partitions"].items()):
                print(f"  partition {pid}: rpc {part['rpc_ms']} ms, "
                      f"{part['doc_count']} docs")
                for phase in ("propose_wait", "wal_append",
                              "commit_wait", "apply", "total"):
                    print(f"    {phase:<14} "
                          f"{part['phases'][phase]:8.3f} ms")

            # background index build, watched through GET /ps/jobs
            from vearch_tpu_torch.cluster import rpc

            print("\nbackground index build:")
            for ps in cluster.ps_nodes:
                for pid in list(ps.engines):
                    rpc.call(ps.addr, "POST", "/ps/index/build",
                             {"partition_id": pid, "background": True})
            for ps in cluster.ps_nodes:
                while True:
                    jobs = rpc.call(ps.addr, "GET", "/ps/jobs")["jobs"]
                    if jobs and all(j["status"] != "running"
                                    for j in jobs):
                        break
                    time.sleep(0.05)
                for j in sorted(jobs, key=lambda j: j["partition_id"]):
                    print(f"  partition {j['partition_id']}: "
                          f"{j['op']} {j['status']} in "
                          f"{j['duration_seconds']}s "
                          f"(phases {sorted(j['phases_ms'])})")

            # slow-query log: an absurdly low threshold logs every
            # search with its phase breakdown (ops would use ~500ms)
            for ps in cluster.ps_nodes:
                pid = next(iter(ps.engines))
                rpc.call(ps.addr, "POST", "/ps/engine/config",
                         {"partition_id": pid,
                          "config": {"slow_log_ms": 0.001}})
            client.search(
                "quickstart", "articles",
                [{"field": "embedding", "feature": vecs[7]}], limit=3)
            print("\nslow-query log (threshold 0.001 ms):")
            logged = 0
            for ps in cluster.ps_nodes:
                log = rpc.call(ps.addr, "GET", "/debug/slowlog")
                for e in log["entries"]:
                    logged += 1
                    print(f"  partition {e['partition']}: {e['op']} "
                          f"{e['elapsed_ms']} ms "
                          f"(phases {sorted(e['phases'])})")
            assert logged >= 1

            print("\nquickstart OK")
            return 0
        finally:
            cluster.stop()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="vearch_tpu_torch quickstart")
    ap.add_argument("--device", default=None,
                    help="the partition servers' torch device (default: "
                         "the card; 'cpu' runs the plain versions)")
    sys.exit(main(ap.parse_args().device))
