"""The elastic jobs (split, migrate, drain, plan / rebalance) on a port
cluster, on the CPU: the four cases of tests/test_elastic.py with every
partition server a port PSServer(device="cpu"), and one mixed case.

- Split under concurrent writers and searchers: the doc count equals the
  seeds plus the acked writes, no doc lost and none duplicated; a
  replicated partition's children keep the replica factor and every
  replica serves its child's docs.
- Migrate a replica to a freshly joined PS, then drain the source: every
  doc survives both hops.
- /cluster/plan and a rebalance without `apply` mutate nothing.
- Every engine a split or a migration created sits on its PS's device.
- Mixed: a reference cluster splits an IVFPQ partition and stops; a port
  cluster reopened on its data dirs serves the children with the
  reference's ids, scores allclose at rtol 1e-5, atol 1e-3 (the exact
  rerank's L2 over f32 rows, another summation order).

Clusters poll with deadlines and are stopped in `finally`.
"""

import os
import threading
import time
import urllib.request

import numpy as np

from vearch_tpu.cluster.master import MasterServer as RefMaster
from vearch_tpu.cluster.ps import PSServer as RefPS
from vearch_tpu.cluster.router import RouterServer as RefRouter
from vearch_tpu_torch.cluster import rpc
from vearch_tpu_torch.cluster.master import MasterServer as PortMaster
from vearch_tpu_torch.cluster.ps import PSServer as PortPS
from vearch_tpu_torch.cluster.router import RouterServer as PortRouter
from vearch_tpu_torch.cluster.standalone import StandaloneCluster
from vearch_tpu_torch.sdk.client import VearchClient

D = 8
PS_KW = {"device": "cpu", "heartbeat_interval": 0.3}
RTOL, ATOL = 1e-5, 1e-3


def _mk_space(cl, partition_num=1, replica_num=1, index=None):
    cl.create_database("db")
    cl.create_space("db", {
        "name": "s", "partition_num": partition_num,
        "replica_num": replica_num,
        "fields": [{"name": "v", "data_type": "vector",
                    "dimension": (index or {}).get("dimension", D),
                    "index": (index or {}).get("index") or {
                        "index_type": "FLAT", "metric_type": "L2",
                        "params": {}}}],
    })


def _all_ids(cl, expect_at_most):
    docs = cl.query("db", "s", limit=expect_at_most + 50, fields=[])
    return [d["_id"] for d in docs]


def _on_ps_device(c):
    for ps in c.ps_nodes:
        for eng in ps.engines.values():
            assert eng.device == ps.device == eng.vector_stores["v"].device


def _split_under_traffic(c, cl, vecs, seed_ids):
    """Split the space's one partition while two writers and a searcher
    run; returns (done job, acked ids, parent id, space before)."""
    space0 = cl.get_space("db", "s")
    parent = space0["partitions"][0]["id"]
    acked: list[str] = []
    errors: list[Exception] = []
    stop = threading.Event()

    def writer(tid: int):
        i = 0
        try:
            while not stop.is_set():
                ids = [f"w{tid}_{i + j}" for j in range(10)]
                cl.upsert("db", "s", [
                    {"_id": k, "v": vecs[(300 + i + j) % 1200].tolist()}
                    for j, k in enumerate(ids)])
                acked.extend(ids)
                i += 10
        except Exception as e:
            errors.append(e)

    def searcher():
        try:
            while not stop.is_set():
                out = cl.search("db", "s",
                                [{"field": "v", "feature": vecs[0]}], limit=3)
                assert len(out) == 1 and out[0]
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(t,), daemon=True)
               for t in range(2)]
    threads += [threading.Thread(target=searcher, daemon=True)]
    for t in threads:
        t.start()
    try:
        job = cl.split_partition("db", "s", parent, timeout_s=120.0)
        done = cl.wait_elastic_job(job["job_id"], timeout_s=120.0)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not errors, [repr(e) for e in errors[:3]]
    assert done["status"] == "done" and done["op"] == "split"
    return done, acked, parent, space0


def test_online_split_under_concurrent_traffic(tmp_path, rng):
    c = StandaloneCluster(data_dir=str(tmp_path / "c"), n_ps=2,
                          ps_kwargs=PS_KW)
    c.start()
    try:
        cl = VearchClient(c.router_addr, master_addr=c.master_addr)
        _mk_space(cl)
        vecs = rng.standard_normal((1200, D)).astype(np.float32)
        seed_ids = [f"seed{i}" for i in range(300)]
        cl.upsert("db", "s", [{"_id": k, "v": vecs[i].tolist()}
                              for i, k in enumerate(seed_ids)])
        _, acked, parent, space0 = _split_under_traffic(c, cl, vecs,
                                                        seed_ids)
        space1 = cl.get_space("db", "s")
        child_ids = [p["id"] for p in space1["partitions"]]
        assert len(child_ids) == 2 and parent not in child_ids
        assert space1.get("map_version", 0) > space0.get("map_version", 0)
        expected = sorted(set(seed_ids) | set(acked))
        assert len(expected) == len(seed_ids) + len(acked)
        assert sorted(_all_ids(cl, len(expected))) == expected
        probe = acked[-20:]
        found = cl.query("db", "s", document_ids=probe, fields=[])
        assert sorted(d["_id"] for d in found) == sorted(probe)
        # the children are the PS's engines, on its device
        _on_ps_device(c)
        assert {pid for ps in c.ps_nodes for pid in ps.engines} == \
            set(child_ids)
        for _ in range(50):
            if rpc.call(c.master_addr, "GET",
                        "/cluster/health")["splits_running"] == 0:
                break
            time.sleep(0.1)
        else:
            raise AssertionError("splits_running never drained")
        text = urllib.request.urlopen(
            f"http://{c.master_addr}/metrics").read().decode()
        assert 'vearch_partition_splits_total{status="done"} 1' in text
    finally:
        c.stop()


def test_online_split_replicated_partition_under_traffic(tmp_path, rng):
    c = StandaloneCluster(data_dir=str(tmp_path / "c"), n_ps=2,
                          ps_kwargs=PS_KW)
    c.start()
    try:
        cl = VearchClient(c.router_addr, master_addr=c.master_addr)
        _mk_space(cl, replica_num=2)
        vecs = rng.standard_normal((1200, D)).astype(np.float32)
        seed_ids = [f"seed{i}" for i in range(300)]
        cl.upsert("db", "s", [{"_id": k, "v": vecs[i].tolist()}
                              for i, k in enumerate(seed_ids)])
        _, acked, parent, _ = _split_under_traffic(c, cl, vecs, seed_ids)
        children = cl.get_space("db", "s")["partitions"]
        assert len(children) == 2
        assert parent not in [p["id"] for p in children]
        for p in children:
            assert len(set(p["replicas"])) == 2, p
        expected = sorted(set(seed_ids) | set(acked))
        assert len(expected) == len(seed_ids) + len(acked)
        assert sorted(_all_ids(cl, len(expected))) == expected
        addr_of = {ps.node_id: ps.addr for ps in c.ps_nodes}

        def replica_sets():
            return [[{d["_id"] for d in rpc.call(
                addr_of[node], "POST", "/ps/doc/query",
                {"partition_id": p["id"], "limit": len(expected) + 50,
                 "fields": []})["documents"]} for node in p["replicas"]]
                for p in children]

        deadline = time.monotonic() + 60
        while True:
            per_child = replica_sets()
            converged = all(all(s == sets[0] for s in sets[1:])
                            for sets in per_child) and sorted(
                set().union(*(s[0] for s in per_child))) == expected
            if converged or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        for p, sets in zip(children, per_child):
            assert all(s == sets[0] for s in sets[1:]), p["id"]
        a, b = per_child[0][0], per_child[1][0]
        assert not (a & b) and sorted(a | b) == expected
        _on_ps_device(c)
    finally:
        c.stop()


def test_migrate_to_fresh_ps_then_drain_source(tmp_path, rng):
    c = StandaloneCluster(data_dir=str(tmp_path / "c"), n_ps=1,
                          ps_kwargs=PS_KW)
    c.start()
    try:
        cl = VearchClient(c.router_addr, master_addr=c.master_addr)
        _mk_space(cl, partition_num=2)
        vecs = rng.standard_normal((200, D)).astype(np.float32)
        cl.upsert("db", "s", [{"_id": f"d{i}", "v": vecs[i].tolist()}
                              for i in range(200)])
        src = c.ps_nodes[0].node_id
        fresh = c.add_ps()
        for _ in range(500):
            servers = rpc.call(c.master_addr, "GET", "/servers")["servers"]
            if any(s["node_id"] == fresh.node_id for s in servers):
                break
            time.sleep(0.1)
        else:
            raise AssertionError("fresh PS never registered")
        errors: list[Exception] = []
        stop = threading.Event()

        def searcher():
            try:
                while not stop.is_set():
                    out = cl.search("db", "s",
                                    [{"field": "v", "feature": vecs[0]}],
                                    limit=3)
                    assert len(out) == 1 and out[0]
            except Exception as e:
                errors.append(e)

        t = threading.Thread(target=searcher, daemon=True)
        t.start()
        try:
            pid = cl.get_space("db", "s")["partitions"][0]["id"]
            job = cl.migrate_partition(pid, to_node=fresh.node_id,
                                       timeout_s=120.0)
            done = cl.wait_elastic_job(job["job_id"], timeout_s=120.0)
            assert done["status"] == "done" and done["op"] == "migrate"
            part = next(p for p in cl.get_space("db", "s")["partitions"]
                        if p["id"] == pid)
            assert part["replicas"] == [fresh.node_id]
            assert part["leader"] == fresh.node_id
            assert pid in fresh.engines
            out = cl.drain(src, apply=True)
            assert out.get("job_id"), out
            cl.wait_elastic_job(out["job_id"], timeout_s=120.0)
        finally:
            stop.set()
            t.join(timeout=60)
        assert not errors, [repr(e) for e in errors[:3]]
        servers = rpc.call(c.master_addr, "GET", "/servers")["servers"]
        drained = next(s for s in servers if s["node_id"] == src)
        assert drained["partition_ids"] == [], "source PS not empty"
        assert sorted(_all_ids(cl, 200)) == sorted(f"d{i}" for i in range(200))
        _on_ps_device(c)
        jobs = cl.elastic_jobs()
        assert {j["op"] for j in jobs} >= {"migrate", "drain"}
        assert all(j["status"] == "done" for j in jobs)
        text = urllib.request.urlopen(
            f"http://{c.master_addr}/metrics").read().decode()
        assert 'vearch_replica_migrations_total{status="done"} 2' in text
    finally:
        c.stop()


def test_plan_and_rebalance_endpoints(tmp_path, rng):
    c = StandaloneCluster(data_dir=str(tmp_path / "c"), n_ps=1,
                          ps_kwargs=PS_KW)
    c.start()
    try:
        cl = VearchClient(c.router_addr, master_addr=c.master_addr)
        _mk_space(cl)
        plan = cl.cluster_plan()
        for key in ("imbalance", "node_loads", "moves", "splits"):
            assert key in plan
        assert cl.rebalance(apply=False)["applied"] is False
        before = cl.get_space("db", "s")
        assert "job_id" not in cl.rebalance(apply=True)
        assert cl.get_space("db", "s") == before
    finally:
        c.stop()


# -- a split the reference ran, served by the port -------------------------------

DM, NM = 32, 1200
IVFPQ = {"dimension": DM, "index": {
    "index_type": "IVFPQ", "metric_type": "L2",
    "params": {"ncentroids": 8, "nsubvector": 8, "mesh_serving": "off"}}}


class _Cluster:
    def __init__(self, tmp, port, persist):
        self.master = (PortMaster if port else RefMaster)(
            heartbeat_ttl=1.5, persist_path=persist)
        self.master.start()
        kw = dict(heartbeat_interval=0.3, raft_tick=0.3,
                  flush_interval=3600.0)
        self.ps = []
        for i in range(2):
            d = os.path.join(tmp, f"ps{i}")
            self.ps.append(PortPS(data_dir=d, master_addr=self.master.addr,
                                  device="cpu", **kw) if port else
                           RefPS(data_dir=d, master_addr=self.master.addr,
                                 **kw))
            self.ps[-1].start()
        self.router = (PortRouter if port else RefRouter)(
            master_addr=self.master.addr)
        self.router.start()
        self.client = VearchClient(self.router.addr,
                                   master_addr=self.master.addr)

    def stop(self, flush=False):
        self.router.stop()
        for ps in self.ps:
            try:
                ps.stop(flush=flush)
            except Exception:
                pass
        self.master.stop()


def _search(cl, q):
    out = cl.search("db", "s", [{"field": "v", "feature": q}], limit=10,
                    cache=False)
    return ([[h["_id"] for h in row] for row in out],
            np.asarray([[h["_score"] for h in row] for row in out]))


def test_port_serves_a_split_the_reference_ran(tmp_path):
    rng = np.random.default_rng(41)
    x = rng.standard_normal((NM, DM)).astype(np.float32)
    q = (x[rng.choice(NM, 8, replace=False)]
         + 0.3 * rng.standard_normal((8, DM))).astype(np.float32)
    tmp = str(tmp_path)
    meta = os.path.join(tmp, "meta.json")
    ref = _Cluster(tmp, port=False, persist=meta)
    try:
        cl = ref.client
        _mk_space(cl, index=IVFPQ)
        for i in range(0, NM, 400):
            cl.upsert("db", "s", [{"_id": f"d{j}", "v": x[j]}
                                  for j in range(i, i + 400)])
        parent = cl.get_space("db", "s")["partitions"][0]["id"]
        job = cl.split_partition("db", "s", parent, timeout_s=120.0)
        assert cl.wait_elastic_job(job["job_id"],
                                   timeout_s=120.0)["status"] == "done"
        rpc.call(ref.router.addr, "POST", "/index/forcemerge",
                 {"db_name": "db", "space_name": "s"}, timeout=120.0)
        children = sorted(p["id"] for p in cl.get_space(
            "db", "s")["partitions"])
        assert len(children) == 2 and parent not in children
        want = _search(cl, q)
        counts = {pid: e.doc_count for ps in ref.ps
                  for pid, e in ps.engines.items()}
        assert sum(counts.values()) == NM
    finally:
        ref.stop(flush=True)
    port = _Cluster(tmp, port=True, persist=meta)
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if sorted(pid for ps in port.ps for pid in ps.engines) == \
                    children:
                try:
                    if len(_search(port.client, q[:1])[0][0]) == 10:
                        break
                except rpc.RpcError:
                    pass
            time.sleep(0.2)
        assert {pid: e.doc_count for ps in port.ps
                for pid, e in ps.engines.items()} == counts
        for ps in port.ps:
            for eng in ps.engines.values():
                assert eng.device.type == "cpu"
                assert eng.indexes["v"].trained
        got = _search(port.client, q)
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)
    finally:
        port.stop()
