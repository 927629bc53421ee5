"""The port's partition servers under raft, and the reference's data
dirs opened by the port, on the CPU.

- Reopen a trained index: a reference cluster builds IVFPQ with its
  master's persist_path set, then stops; a port cluster started on the
  same data dirs reopens those partitions (the PS's restart reopen) and
  returns the reference cluster's ids, scores allclose at rtol 1e-5,
  atol 1e-3 (the exact rerank's L2 over f32 rows).
- Raft on the port: 3 port partition servers hold one 3-replica IVFPQ
  partition, every replica building its own index; after the leader
  stops, the promoted leader returns the same ids.
- A follower caught up by a raft snapshot, and a partition restored from
  a local-objectstore backup, each serve the ids of the partition they
  came from.
- A replica catching up by log replay: the reference's leader sends the
  whole log in one append (up to 512 entries, whatever their size); the
  port's sends it in batches of at most raft.APPEND_MAX_BYTES logged
  bytes (or one entry), and the replica ends with every doc in both.

Every port partition server runs on device="cpu". Clusters poll with
deadlines and are stopped in `finally`.
"""

import json
import os
import time

import numpy as np
import pytest

from vearch_tpu.cluster.master import MasterServer as RefMaster
from vearch_tpu.cluster.ps import PSServer as RefPS
from vearch_tpu.cluster.router import RouterServer as RefRouter
from vearch_tpu.cluster.wal import Wal as RefWal
import vearch_tpu_torch.cluster.ps as port_ps
import vearch_tpu_torch.cluster.raft as port_raft
from vearch_tpu_torch.cluster import rpc
from vearch_tpu_torch.cluster.master import MasterServer as PortMaster
from vearch_tpu_torch.cluster.router import RouterServer as PortRouter
from vearch_tpu_torch.cluster.wal import Wal as PortWal
from vearch_tpu_torch.sdk.client import VearchClient

D = 32
N = 1500
RTOL, ATOL = 1e-5, 1e-3


def _space(replicas: int, partitions: int = 1) -> dict:
    return {
        "name": "s", "partition_num": partitions, "replica_num": replicas,
        "fields": [
            {"name": "v", "data_type": "vector", "dimension": D,
             "index": {"index_type": "IVFPQ", "metric_type": "L2",
                       "params": {"ncentroids": 16, "nsubvector": 8,
                                  "mesh_serving": "off"}}},
            {"name": "cat", "data_type": "integer"},
        ],
    }


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = (x[rng.choice(N, 16, replace=False)]
         + 0.3 * rng.standard_normal((16, D))).astype(np.float32)
    docs = [{"_id": f"d{i}", "v": x[i], "cat": int(i % 4)} for i in range(N)]
    return x, q, docs


def wait_for(cond, timeout=30.0, msg=""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if cond():
                return
        except rpc.RpcError:
            pass
        time.sleep(0.1)
    raise AssertionError(f"timeout: {msg}")


class _Cluster:
    def __init__(self, tmp, n_ps, port=True, ttl=1.5, persist=None):
        master_cls = PortMaster if port else RefMaster
        self.master = master_cls(heartbeat_ttl=ttl, persist_path=persist)
        self.master.start()
        self.tmp = tmp
        self.port = port
        self.ps = [self.start_ps(os.path.join(tmp, f"ps{i}"))
                   for i in range(n_ps)]
        self.router = (PortRouter if port else RefRouter)(
            master_addr=self.master.addr)
        self.router.start()
        self.client = VearchClient(self.router.addr)

    def start_ps(self, data_dir):
        if self.port:
            ps = port_ps.PSServer(data_dir=data_dir,
                                  master_addr=self.master.addr,
                                  heartbeat_interval=0.3, raft_tick=0.3,
                                  flush_interval=3600.0, device="cpu")
        else:
            ps = RefPS(data_dir=data_dir, master_addr=self.master.addr,
                       heartbeat_interval=0.3, raft_tick=0.3,
                       flush_interval=3600.0)
        ps.start()
        return ps

    def stop(self, flush=False):
        self.router.stop()
        for ps in self.ps:
            try:
                ps.stop(flush=flush)
            except Exception:
                pass
        self.master.stop()

    def holders(self, pid):
        return [ps for ps in self.ps if pid in ps.engines]


def _ids_scores(out):
    return ([[h["_id"] for h in row] for row in out],
            np.asarray([[h["_score"] for h in row] for row in out]))


def _search(cl, q, **kw):
    return _ids_scores(cl.search("db", "s", [{"field": "v", "feature": q}],
                                 limit=10, cache=False, **kw))


def _ps_search(ps, pid, q):
    out = rpc.call(ps.addr, "POST", "/ps/doc/search",
                   {"partition_id": pid, "vectors": {"v": q}, "k": 10})
    return _ids_scores(out["results"])


def _build_every_replica(c, pid):
    for ps in c.holders(pid):
        out = rpc.call(ps.addr, "POST", "/ps/index/build",
                       {"partition_id": pid}, timeout=120.0)
        assert out["status"] == 3  # IndexStatus.INDEXED


def test_port_reopens_reference_trained_partitions(tmp_path, data):
    _x, q, docs = data
    tmp = str(tmp_path)
    meta = os.path.join(tmp, "meta.json")
    ref = _Cluster(tmp, 2, port=False, persist=meta)
    try:
        ref.client.create_database("db")
        ref.client.create_space("db", _space(1, partitions=2))
        for i in range(0, N, 500):
            ref.client.upsert("db", "s", docs[i:i + 500])
        rpc.call(ref.router.addr, "POST", "/index/forcemerge",
                 {"db_name": "db", "space_name": "s"}, timeout=120.0)
        want = _search(ref.client, q)
        counts = {pid: e.doc_count for ps in ref.ps
                  for pid, e in ps.engines.items()}
    finally:
        ref.stop(flush=True)
    port = _Cluster(tmp, 2, port=True, persist=meta)
    try:
        wait_for(lambda: sum(len(ps.engines) for ps in port.ps) == 2
                 and len(port.client.search(
                     "db", "s", [{"field": "v", "feature": q[:1]}],
                     limit=1, cache=False)[0]) == 1,
                 msg="port cluster did not reopen the reference partitions")
        assert {pid: e.doc_count for ps in port.ps
                for pid, e in ps.engines.items()} == counts
        for ps in port.ps:
            for eng in ps.engines.values():
                assert int(eng.status) == 3 and eng.indexes["v"].trained
        got = _search(port.client, q)
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)
    finally:
        port.stop()


def test_leader_failover_keeps_ids(tmp_path, data):
    _x, q, docs = data
    c = _Cluster(str(tmp_path), 3, ttl=1.2)
    try:
        c.client.create_database("db")
        c.client.create_space("db", _space(3))
        for i in range(0, N, 500):
            c.client.upsert("db", "s", docs[i:i + 500])
        part = c.client.get_space("db", "s")["partitions"][0]
        pid, leader = part["id"], part["leader"]
        assert len(c.holders(pid)) == 3
        _build_every_replica(c, pid)
        before = _search(c.client, q)
        assert all(len(r) == 10 for r in before[0])
        dead = next(ps for ps in c.ps if ps.node_id == leader)
        dead.stop(flush=False)
        wait_for(lambda: c.client.get_space("db", "s")["partitions"][0]
                 ["leader"] not in (leader, -1),
                 msg="no new leader after the leader stopped")
        wait_for(lambda: len(_search(c.client, q[:1])[0][0]) == 10,
                 msg="the promoted leader does not serve")
        after = _search(c.client, q)
        assert after[0] == before[0]
        np.testing.assert_allclose(after[1], before[1], rtol=RTOL, atol=ATOL)
    finally:
        c.stop()


def test_snapshot_caught_up_follower_serves_leader_ids(tmp_path, data,
                                                       monkeypatch):
    _x, q, docs = data
    monkeypatch.setattr(port_ps, "WAL_KEEP_ENTRIES", 5)
    c = _Cluster(str(tmp_path), 2, ttl=3600.0)
    try:
        c.client.create_database("db")
        c.client.create_space("db", _space(2))
        part = c.client.get_space("db", "s")["partitions"][0]
        pid, leader = part["id"], part["leader"]
        lead = next(ps for ps in c.ps if ps.node_id == leader)
        follower = next(ps for ps in c.holders(pid) if ps is not lead)
        c.client.upsert("db", "s", docs[:300])
        fdir = follower.data_dir
        follower.stop(flush=False)
        c.ps.remove(follower)
        rpc.call(c.master.addr, "POST", "/partitions/change_member",
                 {"partition_id": pid, "node_id": follower.node_id,
                  "method": "remove"})
        # one log entry per call pushes the log past WAL_KEEP_ENTRIES
        for i in range(300, N, 100):
            c.client.upsert("db", "s", docs[i:i + 100])
        lead.flush_partition(pid)
        assert lead.raft_nodes[pid].wal.first_index > 5
        installs = []
        real = port_ps.PSServer._install_snapshot

        def spy(self, p, blob, idx):
            installs.append(p)
            return real(self, p, blob, idx)

        monkeypatch.setattr(port_ps.PSServer, "_install_snapshot", spy)
        back = c.start_ps(fdir)
        c.ps.append(back)
        rpc.call(c.master.addr, "POST", "/partitions/change_member",
                 {"partition_id": pid, "node_id": back.node_id,
                  "method": "add"})
        wait_for(lambda: pid in back.engines
                 and back.engines[pid].doc_count == N,
                 msg="snapshot catch-up failed")
        assert installs == [pid]
        _build_every_replica(c, pid)
        want = _ps_search(lead, pid, q)
        got = _ps_search(back, pid, q)
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)
    finally:
        c.stop()


def test_backup_restore_serves_the_backed_up_ids(tmp_path, data):
    _x, q, docs = data
    store_root = str(tmp_path / "objectstore")
    c = _Cluster(str(tmp_path / "c"), 2, ttl=3600.0)
    try:
        c.client.create_database("db")
        c.client.create_space("db", _space(1, partitions=2))
        for i in range(0, N, 500):
            c.client.upsert("db", "s", docs[i:i + 500])
        rpc.call(c.router.addr, "POST", "/index/forcemerge",
                 {"db_name": "db", "space_name": "s"}, timeout=120.0)
        want = _search(c.client, q)
        out = rpc.call(c.master.addr, "POST", "/backup/dbs/db/spaces/s",
                       {"command": "create", "store_root": store_root},
                       timeout=120.0)
        assert out["version"] == 1
        c.client.delete("db", "s", document_ids=[
            k for row in want[0] for k in row])
        assert _search(c.client, q)[0] != want[0]
        out = rpc.call(c.master.addr, "POST", "/backup/dbs/db/spaces/s",
                       {"command": "restore", "store_root": store_root,
                        "version": 1}, timeout=120.0)
        assert sum(p["doc_count"] for p in out["partitions"]) == N
        got = _search(c.client, q)
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)
    finally:
        c.stop()


def _logged(entry) -> int:
    return len(json.dumps(entry).encode())


def test_wal_bounds_a_batch_by_logged_bytes(tmp_path):
    """entries_from without max_bytes is the reference's batch (by count
    only); with it, the longest prefix within max_bytes, at least one
    entry, kept true across a reopen and both truncations."""
    rng = np.random.default_rng(3)
    entries = [{"index": i + 1, "term": 1, "op": {"type": "upsert", "docs": [
        {"_id": f"d{i}_{j}", "v": rng.standard_normal(D).tolist()}
        for j in range(1 + i % 4)]}} for i in range(12)]
    sizes = [_logged(e) for e in entries]
    ref, port = RefWal(str(tmp_path / "ref")), PortWal(str(tmp_path / "port"))
    ref.append(entries)
    port.append(entries)
    assert ref.entries_from(1) == port.entries_from(1) == entries

    def expect(start, budget, end=None):
        out, total = [], 0
        for e, size in zip(entries[start - 1:end], sizes[start - 1:end]):
            total += size
            if out and total > budget:
                break
            out.append(e)
        return out

    for budget in (1, sizes[0], sizes[0] + sizes[1], 3 * max(sizes)):
        assert port.entries_from(1, max_bytes=budget) == expect(1, budget)
        assert port.entries_from(5, max_bytes=budget) == expect(5, budget)
    port.close()
    port = PortWal(str(tmp_path / "port"))  # sizes read back from the file
    budget = sizes[0] + sizes[1] + sizes[2]
    assert port.entries_from(1, max_bytes=budget) == expect(1, budget)
    port.truncate_prefix(4)
    assert port.entries_from(4, max_bytes=budget) == expect(4, budget)
    port.truncate_suffix(9)
    assert port.entries_from(7, max_bytes=10 ** 9) == expect(7, 10 ** 9, 8)
    port.reset(20)
    assert port.entries_from(20, max_bytes=budget) == []
    port.close()
    ref.close()


@pytest.mark.parametrize("port", [True, False], ids=["port", "reference"])
def test_replica_catches_up_a_log_by_bounded_appends(tmp_path, data, port,
                                                     monkeypatch):
    _x, _q, docs = data
    ps_cls = port_ps.PSServer if port else RefPS
    appends = []
    real = ps_cls._raft_send

    def spy(self, peer, path, body):
        if path.endswith("/append") and body.get("entries"):
            appends.append((peer, [_logged(e) for e in body["entries"]]))
        return real(self, peer, path, body)

    monkeypatch.setattr(ps_cls, "_raft_send", spy)
    c = _Cluster(str(tmp_path), 1, port=port, ttl=3600.0)
    try:
        c.client.create_database("db")
        c.client.create_space("db", _space(1))
        pid = c.client.get_space("db", "s")["partitions"][0]["id"]
        for i in range(0, N, 150):  # one log entry per call
            c.client.upsert("db", "s", docs[i:i + 150])
        lead = c.ps[0]
        sizes = [_logged(e) for e in lead.raft_nodes[pid].wal.entries_from(1)]
        assert len(sizes) == N // 150
        cap = int(2.5 * max(sizes))  # two entries a batch
        monkeypatch.setattr(port_raft, "APPEND_MAX_BYTES", cap)
        fresh = c.start_ps(os.path.join(str(tmp_path), "fresh"))
        c.ps.append(fresh)
        wait_for(lambda: any(
            s["node_id"] == fresh.node_id for s in rpc.call(
                c.master.addr, "GET", "/servers")["servers"]),
            msg="fresh PS never registered")
        rpc.call(c.master.addr, "POST", "/partitions/change_member",
                 {"partition_id": pid, "node_id": fresh.node_id,
                  "method": "add"})
        wait_for(lambda: pid in fresh.engines
                 and fresh.engines[pid].doc_count == N,
                 msg="log-replay catch-up failed")
        batches = [b for peer, b in appends if peer == fresh.node_id]
        assert sum(len(b) for b in batches) == len(sizes)
        if port:
            assert len(batches) >= len(sizes) // 2
            assert all(len(b) == 1 or sum(b) <= cap for b in batches)
        else:  # the reference: the whole log in one append
            assert [len(b) for b in batches] == [len(sizes)]
    finally:
        c.stop()
