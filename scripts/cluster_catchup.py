"""Re-replication and drain after a failover, on the CPU, for either
package's cluster: how a replica that starts empty catches a partition up
by raft log replay, append by append.

A StandaloneCluster of 3 partition servers serves a space of 2
partitions x 3 replicas; `--rows` random 128-d docs go in through the
router in `--batch`-doc upserts (one raft entry per partition each).
The server leading the first partition stops; after the failover a
fresh server joins, the master re-places the dropped replicas on it
(auto-recover) and the leaders catch it up by log replay; a second fresh
server joins and the first is drained onto it. Every append RPC that
carries entries is recorded (entries, seconds, outcome), with the
replica sets and per-peer lags once a second, and each RPC handler
failure the servers log.

    python scripts/cluster_catchup.py --package vearch_tpu_torch
    python scripts/cluster_catchup.py --package vearch_tpu --rows 150000

Only the package named is imported. The last line is a JSON summary.
"""

from __future__ import annotations

import argparse
import importlib
import json
import logging
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("vearch_tpu_torch", "vearch_tpu"),
                    default="vearch_tpu_torch")
    ap.add_argument("--rows", type=int, default=150_000)
    ap.add_argument("--batch", type=int, default=5_000)
    ap.add_argument("--watch-s", type=float, default=150.0)
    ap.add_argument("--drain-s", type=float, default=400.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.package == "vearch_tpu":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
    pkg = args.package
    standalone = importlib.import_module(f"{pkg}.cluster.standalone")
    psmod = importlib.import_module(f"{pkg}.cluster.ps")
    rpc = importlib.import_module(f"{pkg}.cluster.rpc")
    client = importlib.import_module(f"{pkg}.sdk.client")
    ps_kwargs = {"heartbeat_interval": 0.3}
    if pkg == "vearch_tpu_torch":
        ps_kwargs["device"] = "cpu"

    appends, failures = [], []
    clock = {"t0": time.monotonic()}  # reset at the failover
    real = psmod.PSServer._raft_send

    def send(self, peer, path, body):
        t0 = time.monotonic()
        outcome = "ok"
        try:
            return real(self, peer, path, body)
        except Exception as e:
            outcome = type(e).__name__
            raise
        finally:
            if path.endswith("/append") and body.get("entries"):
                appends.append({
                    "t": round(time.monotonic() - clock["t0"], 1),
                    "leader": self.node_id, "peer": peer,
                    "pid": body["pid"], "entries": len(body["entries"]),
                    "first": body["entries"][0]["index"],
                    "seconds": round(time.monotonic() - t0, 2),
                    "outcome": outcome})

    psmod.PSServer._raft_send = send

    class Failures(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if "panic in" in msg:
                failures.append(msg[:200])

    logging.getLogger("vearch.rpc").addHandler(Failures())
    rng = np.random.default_rng(args.seed)
    rows = rng.standard_normal((args.rows, 128)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        c = standalone.StandaloneCluster(data_dir=tmp, n_ps=3,
                                         ps_kwargs=ps_kwargs).start()
        try:
            cl = client.VearchClient(c.router_addr,
                                     master_addr=c.master.addr)
            cl.create_database("db")
            cl.create_space("db", {
                "name": "s", "partition_num": 2, "replica_num": 3,
                "fields": [{"name": "emb", "data_type": "vector",
                            "dimension": 128, "index": {
                                "index_type": "IVFPQ", "metric_type": "L2",
                                "params": {"ncentroids": 64,
                                           "nsubvector": 32,
                                           "training_threshold": 10 ** 9}}}]})
            t0 = time.monotonic()
            for i in range(0, args.rows, args.batch):
                cl.upsert("db", "s", [{"_id": f"d{j}", "emb": rows[j]}
                                      for j in range(i, min(i + args.batch,
                                                            args.rows))])
            ingest_s = time.monotonic() - t0
            parts = cl.get_space("db", "s")["partitions"]
            dead = parts[0]["leader"]
            next(p for p in c.ps_nodes if p.node_id == dead).stop(
                flush=False)
            t_fail = clock["t0"] = time.monotonic()
            while any(p["leader"] in (dead, -1) for p in
                      cl.get_space("db", "s")["partitions"]):
                time.sleep(0.2)
            failover_s = time.monotonic() - t_fail

            def lags():
                out = {}
                for p in cl.get_space("db", "s")["partitions"]:
                    lead = next((s for s in c.ps_nodes
                                 if s.node_id == p["leader"]), None)
                    if lead is None or lead._stop.is_set():
                        continue
                    st = rpc.call(lead.addr, "GET",
                                  f"/ps/raft/state/{p['id']}")
                    out[p["id"]] = {"replicas": p["replicas"], "lag": {
                        k: v.get("lag")
                        for k, v in (st.get("peers") or {}).items()}}
                return out

            fresh_a = c.add_ps()
            t_join = time.monotonic()
            timeline, caught_up_s = [], None
            while time.monotonic() - t_join < args.watch_s:
                time.sleep(1.0)
                state = lags()
                timeline.append({"t": round(time.monotonic() - t_join, 1),
                                 **{str(k): v for k, v in state.items()}})
                print(json.dumps(timeline[-1]), flush=True)
                if caught_up_s is None and state and all(
                        fresh_a.node_id in v["replicas"]
                        and v["lag"].get(str(fresh_a.node_id)) == 0
                        for v in state.values()):
                    caught_up_s = time.monotonic() - t_join
            c.add_ps()  # the drain's target
            time.sleep(2.0)
            t0 = time.monotonic()
            job = cl.drain(fresh_a.node_id, apply=True)
            status = "no moves"
            while job.get("job_id") and \
                    time.monotonic() - t0 < args.drain_s:
                j = cl.elastic_job(job["job_id"])
                status = j["status"]
                if status != "running":
                    break
                time.sleep(0.5)
            drain_s = time.monotonic() - t0
        finally:
            c.stop()
    for a in appends:
        print("append " + json.dumps(a))
    churn = len({json.dumps({k: v["replicas"] for k, v in e.items()
                             if k != "t"}, sort_keys=True)
                 for e in timeline})
    print(json.dumps({
        "package": pkg, "rows": args.rows, "batch": args.batch,
        "ingest_s": ingest_s, "failover_s": failover_s,
        "rereplicated_caught_up_s": caught_up_s,
        "replica_sets_seen": churn,
        "max_entries_an_append": max((a["entries"] for a in appends),
                                     default=0),
        "max_append_s": max((a["seconds"] for a in appends), default=0.0),
        "failed_appends": sum(a["outcome"] != "ok" for a in appends),
        "handler_failures": len(failures),
        "drain_status": status, "drain_s": drain_s}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
