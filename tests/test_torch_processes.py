"""Cluster roles as separate processes, port against reference.

tests/test_raft_process.py's two scenarios (SIGKILL of a real
`--role ps` process, then failover or a WAL restart), run once with the
port's partition servers (`python -m vearch_tpu_torch --role ps --device
cpu`, an in-process port master and router) and once with the
reference's (`python -m vearch_tpu --role ps` under JAX_PLATFORMS=cpu,
its in-process master and router). Each side asserts what the reference
test asserts, and the two sides' final top hits and recovered doc sets
must be equal. A partition server restarted on its data dir refuses a
partition create until it has reopened its partitions, where the
reference's loses them. Then cloud/smoke_torch.py, the port's cluster profile
(3 masters, 2 routers, 3 partition servers as subprocesses), must print
its all-green line.

Every child's stderr goes to a log under tmp_path (printed on a
failure), every wait has a timeout and every child is killed in a
`finally`.
"""

import importlib.util
import os
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 8
DEADLINE_S = 30.0  # the reference test's failover and replay deadlines


def _smoke_module():
    spec = importlib.util.spec_from_file_location(
        "vearch_smoke_torch", os.path.join(REPO, "cloud", "smoke_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _smoke_module()


def _package(kind: str) -> dict:
    """The in-process roles, SDK and PS launch of one package."""
    if kind == "port":
        from vearch_tpu_torch.cluster import rpc
        from vearch_tpu_torch.cluster.master import MasterServer
        from vearch_tpu_torch.cluster.router import RouterServer
        from vearch_tpu_torch.sdk.client import VearchClient

        return {"module": "vearch_tpu_torch", "ps_args": ["--device", "cpu"],
                "env": {}, "rpc": rpc, "master": MasterServer,
                "router": RouterServer, "client": VearchClient}
    from vearch_tpu.cluster import rpc
    from vearch_tpu.cluster.master import MasterServer
    from vearch_tpu.cluster.router import RouterServer
    from vearch_tpu.sdk.client import VearchClient

    return {"module": "vearch_tpu", "ps_args": [],
            "env": {"JAX_PLATFORMS": "cpu"}, "rpc": rpc,
            "master": MasterServer, "router": RouterServer,
            "client": VearchClient}


class _Cluster:
    """An in-process master and router of one package, and its PS
    processes (`roles`), stopped and killed on exit."""

    def __init__(self, kind, tmp_path, **master_kw):
        self.pkg = _package(kind)
        self.tmp_path = tmp_path
        self.roles = smoke.Roles(str(tmp_path / "logs"),
                                 module=self.pkg["module"],
                                 env=self.pkg["env"])
        self.master = self.pkg["master"](**master_kw)
        self.router = None

    def __enter__(self):
        self.master.start()
        self.router = self.pkg["router"](master_addr=self.master.addr)
        self.router.start()
        return self

    def spawn_ps(self, name: str) -> int:
        """Start (or restart) PS `name` on its own data dir; its node id
        from the banner `ps node N: http://host:port`."""
        self.roles.spawn(name, [
            "--role", "ps", "--data-dir", str(self.tmp_path / name),
            "--master-addr", self.master.addr, *self.pkg["ps_args"]])
        banner = self.roles.banners[name]
        assert banner.startswith("ps node "), banner
        return int(banner.split()[2].rstrip(":"))

    def client(self):
        return self.pkg["client"](self.router.addr)

    def __exit__(self, exc_type, *exc):
        try:
            if self.router is not None:
                self.router.stop()
            self.roles.close()
            self.master.stop()
        finally:
            if exc_type is not None:
                print(self.roles.tails())


def _space(replicas: int) -> dict:
    return {"name": "s", "partition_num": 1, "replica_num": replicas,
            "fields": [{"name": "v", "data_type": "vector", "dimension": D,
                        "index": {"index_type": "FLAT", "metric_type": "L2",
                                  "params": {}}}]}


def _kill9_leader(kind, tmp_path) -> dict:
    """SIGKILL the leader PS process after 60 acked writes; writes resume
    against the promoted follower and every acked write survives."""
    vecs = np.random.default_rng(1234).standard_normal((60, D)).astype(
        np.float32)
    with _Cluster(kind, tmp_path, heartbeat_ttl=2.0,
                  recover_delay=3600.0) as c:
        rpc = c.pkg["rpc"]
        nids = {c.spawn_ps("ps0"): "ps0", c.spawn_ps("ps1"): "ps1"}
        cl = c.client()
        cl.create_database("db")
        cl.create_space("db", _space(2))
        leader = cl.get_space("db", "s")["partitions"][0]["leader"]
        acked = []
        for i in range(60):
            cl.upsert("db", "s", [{"_id": f"d{i}", "v": vecs[i]}])
            acked.append(f"d{i}")
        c.roles.kill(nids[leader])
        deadline = time.monotonic() + DEADLINE_S
        post_ok = False
        while time.monotonic() < deadline:
            try:
                cl.upsert("db", "s", [{"_id": "post", "v": vecs[0]}])
                post_ok = True
                break
            except rpc.RpcError:
                time.sleep(0.4)
        assert post_ok, "writes did not resume after kill -9 failover"
        got = {d["_id"] for d in cl.query("db", "s", document_ids=acked,
                                          limit=len(acked))}
        missing = set(acked) - got
        assert not missing, f"ACKED WRITES LOST after kill -9: " \
                            f"{sorted(missing)[:10]}"
        hits = cl.search("db", "s", [{"field": "v", "feature": vecs[33]}],
                         limit=1)
        assert hits[0][0]["_id"] == "d33"
        return {"docs": sorted(got), "top": hits[0][0]["_id"]}


def _kill9_restart(kind, tmp_path) -> dict:
    """SIGKILL a single-replica PS, restart it on the same data dir: the
    WAL replays every acked write."""
    vecs = np.random.default_rng(1234).standard_normal((40, D)).astype(
        np.float32)
    ids = [f"d{i}" for i in range(40)]
    with _Cluster(kind, tmp_path, heartbeat_ttl=2.0) as c:
        rpc = c.pkg["rpc"]
        nid = c.spawn_ps("ps0")
        cl = c.client()
        cl.create_database("db")
        cl.create_space("db", _space(1))
        cl.upsert("db", "s", [{"_id": ids[i], "v": vecs[i]}
                              for i in range(40)])
        c.roles.kill("ps0")
        assert c.spawn_ps("ps0") == nid  # the node id is on its disk
        deadline = time.monotonic() + DEADLINE_S
        docs = []
        while time.monotonic() < deadline:
            try:
                docs = cl.query("db", "s", document_ids=ids, limit=40)
                if len(docs) == 40:
                    break
            except rpc.RpcError:
                pass
            time.sleep(0.4)
        assert len(docs) == 40, f"WAL replay recovered {len(docs)}/40"
        hits = cl.search("db", "s", [{"field": "v", "feature": vecs[21]}],
                         limit=1)
        assert hits[0][0]["_id"] == "d21"
        return {"docs": sorted(d["_id"] for d in docs),
                "top": hits[0][0]["_id"]}


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    """Each (scenario, package) run once, on first use; the other
    package's case then compares against the cached outcome."""
    done: dict = {}

    def get(scenario, kind):
        if (scenario, kind) not in done:
            done[scenario, kind] = scenario(
                kind, tmp_path_factory.mktemp(f"{scenario.__name__}_{kind}"))
        return done[scenario, kind]

    return get


@pytest.mark.parametrize("kind", ["port", "reference"])
def test_kill9_leader_loses_no_acked_write(kind, outcomes):
    got = outcomes(_kill9_leader, kind)
    assert got["top"] == "d33"
    assert got["docs"] == sorted([f"d{i}" for i in range(60)])
    other = outcomes(_kill9_leader,
                     "reference" if kind == "port" else "port")
    assert got == other


@pytest.mark.parametrize("kind", ["port", "reference"])
def test_kill9_restart_recovers_from_wal(kind, outcomes):
    got = outcomes(_kill9_restart, kind)
    assert got["top"] == "d21"
    assert got["docs"] == sorted(f"d{i}" for i in range(40))
    other = outcomes(_kill9_restart,
                     "reference" if kind == "port" else "port")
    assert got == other


def _ps_server(kind):
    if kind == "port":
        from vearch_tpu_torch.cluster.ps import PSServer
        from vearch_tpu_torch.cluster.rpc import RpcError

        return (lambda d: PSServer(data_dir=d, device="cpu")), RpcError
    from vearch_tpu.cluster.ps import PSServer
    from vearch_tpu.cluster.rpc import RpcError

    return (lambda d: PSServer(data_dir=d)), RpcError


@pytest.mark.parametrize("kind", ["port", "reference"])
def test_partition_create_waits_for_the_reopen(kind, tmp_path):
    """A partition server restarted on its data dir gets a create for a
    partition on its disk before start() has reopened it: the master
    re-adds a returning replica as soon as the server registers, and on
    the card the reopen takes seconds. The port refuses (503) until the
    reopen, and the reopened partition holds every acked doc; the
    reference accepts, dumps an empty engine over the partition, and the
    reopened partition has lost them (the port's stated departure,
    tests/test_torch_cluster.py STATED_EDITS["cluster/ps.py"])."""
    make, rpc_error = _ps_server(kind)
    data_dir = str(tmp_path / "ps")
    body = {"partition": {"id": 7, "space_id": 1, "db_name": "db",
                          "space_name": "s", "slot": 0, "replicas": [1],
                          "leader": 1},
            "schema": {"name": "s", "fields": _space(1)["fields"]}}
    vecs = np.random.default_rng(3).standard_normal((40, D)).astype(
        np.float32)
    ps = make(data_dir)
    ps.node_id = 1  # no master: the node id a registration would give
    ps.start()
    try:
        ps._h_create_partition(body, None)
        ps._h_upsert({"partition_id": 7, "documents": [
            {"_id": f"d{i}", "v": vecs[i].tolist()} for i in range(40)]},
            None)
        assert ps.engines[7].doc_count == 40
    finally:
        ps.stop()
    ps = make(data_dir)
    ps.node_id = 1
    try:
        if kind == "port":
            with pytest.raises(rpc_error) as err:
                ps._h_create_partition(body, None)
            assert err.value.code == 503
        else:
            ps._h_create_partition(body, None)
        ps.start()
        assert ps.engines[7].doc_count == (40 if kind == "port" else 0)
        with pytest.raises(rpc_error) as err:
            ps._h_create_partition(body, None)
        assert err.value.code == 409
    finally:
        ps.stop()


def test_cloud_smoke_torch_is_all_green():
    """The port's cluster profile: 3 masters, 2 routers, 3 partition
    servers as subprocesses, master-leader and PS kill -9, an S3 backup
    round trip (cloud/smoke_torch.py --device cpu)."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "cloud", "smoke_torch.py"),
         "--device", "cpu"],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "CLUSTER SMOKE: ALL GREEN" in out.stdout, out.stdout + out.stderr
