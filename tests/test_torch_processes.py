"""Cluster roles as separate processes, port against reference.

tests/test_raft_process.py's two scenarios (SIGKILL of a real
`--role ps` process, then failover or a WAL restart), run once with the
port's partition servers (`python -m vearch_tpu_torch --role ps --device
cpu`, an in-process port master and router) and once with the
reference's (`python -m vearch_tpu --role ps` under JAX_PLATFORMS=cpu,
its in-process master and router). Each side asserts what the reference
test asserts, and the two sides' final top hits and recovered doc sets
must be equal. The master's lease TTL spans three of the children's
heartbeat periods (at one, a live server's lease lapses on a loaded
host). A partition server restarted on its data dir refuses a
partition create until it has reopened its partitions, where the
reference's loses them. A replica re-added to its group after its lease
lapsed is not promoted past the writes the leader acked alone (the
reference promotes it and loses them), and is promoted once it caught
up. Then cloud/smoke_torch.py, the port's cluster profile
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
# a `--role ps` process heartbeats every 2 s (PSServer's default, in both
# packages), and each heartbeat renews its lease. The master's lease TTL
# spans three of them, so only a server that stopped heartbeating is
# failed over: at one period (the reference test's 2.0 s) a live server's
# lease lapses whenever one heartbeat is late, as on a loaded host
HEARTBEAT_S = 2.0
LEASE_TTL_S = 3 * HEARTBEAT_S


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
    with _Cluster(kind, tmp_path, heartbeat_ttl=LEASE_TTL_S,
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
        # the writes resume on the master's failover: wait until it names
        # the partition's new leader (one lease TTL after the kill)
        while cl.get_space("db", "s")["partitions"][0]["leader"] == leader:
            assert time.monotonic() < deadline, \
                "no new leader after kill -9 failover"
            time.sleep(0.2)
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


@pytest.mark.parametrize("kind", ["port", "reference"])
def test_lease_ttl_spans_the_heartbeat(kind):
    """LEASE_TTL_S follows the partition servers' heartbeat: it is three
    of each package's PSServer heartbeat periods."""
    import inspect

    ps = _inproc(kind)["ps"]
    beat = inspect.signature(ps).parameters["heartbeat_interval"].default
    assert beat == HEARTBEAT_S and LEASE_TTL_S == 3 * beat


def _kill9_restart(kind, tmp_path) -> dict:
    """SIGKILL a single-replica PS, restart it on the same data dir: the
    WAL replays every acked write."""
    vecs = np.random.default_rng(1234).standard_normal((40, D)).astype(
        np.float32)
    ids = [f"d{i}" for i in range(40)]
    with _Cluster(kind, tmp_path, heartbeat_ttl=LEASE_TTL_S) as c:
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


def _inproc(kind):
    """One package's master, PS, router, client and RpcError classes, and
    the PS keyword arguments (the port's servers on the CPU)."""
    pkg = _package(kind)
    if kind == "port":
        from vearch_tpu_torch.cluster.ps import PSServer

        return dict(pkg, ps=PSServer, ps_kw={"device": "cpu"})
    from vearch_tpu.cluster.ps import PSServer

    return dict(pkg, ps=PSServer, ps_kw={})


def _on_own_thread(fn, *args) -> None:
    """Run one pass of the master on a thread of its own, as its reaper
    and recover loops do: a new thread holds no pooled keep-alive
    connection, so a stopped server is unreachable to it, as a killed
    one is."""
    import threading

    errors = []

    def run():
        try:
            fn(*args)
        except BaseException as e:  # re-raised on the test's thread
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(DEADLINE_S)
    assert not t.is_alive(), f"{fn} hung"
    if errors:
        raise errors[0]


def _recover_pass(master) -> None:
    """One pass of the master's recover loop."""
    with master._reconfig_lock:
        master._auto_recover_once()


def _readd_then_failover(kind, tmp_path, mode: str) -> dict:
    """A follower F drops out of a 2-replica group (its lease lapsed: a
    heartbeat late on a loaded host) while the leader L acks writes
    alone; F returns and the master re-adds it; then L is lost and fails
    over. `mode`: "caught_up", F replayed L's log before L was lost;
    "deaf", F heard nothing from L after the re-add (its appends lost);
    "dead", L was gone before the re-add (killed right after its last
    ack, its lease not yet lapsed). The master's lease reaper and recover
    loop are driven by hand (`_failover_node`, `_auto_recover_once`), as
    they run when a lease lapses and on the next pass. What the master
    decreed, and which acked docs F's engine holds."""
    pkg = _inproc(kind)
    rpc_error = pkg["rpc"].RpcError
    vecs = np.random.default_rng(7).standard_normal((20, D)).astype(
        np.float32)
    ids = [f"d{i}" for i in range(20)]
    master = pkg["master"](heartbeat_ttl=3600.0, recover_delay=3600.0,
                           auto_recover=False)
    master.start()
    servers, stopped, router = [], [], None
    try:
        for i in range(2):
            ps = pkg["ps"](data_dir=str(tmp_path / f"ps{i}"),
                           master_addr=master.addr, heartbeat_interval=0.3,
                           **pkg["ps_kw"])
            ps.start()
            servers.append(ps)
        router = pkg["router"](master_addr=master.addr)
        router.start()
        cl = pkg["client"](router.addr)
        cl.create_database("db")
        cl.create_space("db", _space(2))
        part = cl.get_space("db", "s")["partitions"][0]
        pid = part["id"]
        lead = next(ps for ps in servers if ps.node_id == part["leader"])
        fol = next(ps for ps in servers if ps is not lead)

        def partition():
            return next(p for sp in master.store.prefix("/space/").values()
                        for p in sp["partitions"] if p["id"] == pid)

        for i in range(10):
            cl.upsert("db", "s", [{"_id": ids[i], "v": vecs[i]}])
        _on_own_thread(master._failover_node, fol.node_id)
        out = {"dropped": partition()["replicas"] == [lead.node_id]}
        for i in range(10, 20):  # acked by L alone
            cl.upsert("db", "s", [{"_id": ids[i], "v": vecs[i]}])
        node = fol.raft_nodes[pid]
        if mode == "deaf":
            def unreachable(_body):
                raise rpc_error(503, "F hears nothing from L")

            node.handle_append = unreachable
            node.handle_install_snapshot = unreachable
        elif mode == "dead":
            lead.stop()
            stopped.append(lead)
        _on_own_thread(_recover_pass, master)  # F returns: re-added
        out["readded"] = sorted(partition()["replicas"]) == sorted(
            ps.node_id for ps in servers)
        if mode == "caught_up":
            deadline = time.monotonic() + DEADLINE_S
            while node.state()["last_index"] < \
                    lead.raft_nodes[pid].state()["last_index"]:
                assert time.monotonic() < deadline, "F did not catch up"
                time.sleep(0.05)
        _on_own_thread(master._failover_node, lead.node_id)  # L is lost
        out["promoted"] = partition()["leader"] == fol.node_id
        held = fol._h_query({"partition_id": pid, "document_ids": ids},
                            None)["documents"]
        out["held"] = sorted(d["_id"] for d in held)
        return out
    finally:
        if router is not None:
            router.stop()
        for ps in servers:
            if ps not in stopped:
                ps.stop()
        master.stop()


FIRST_TEN = sorted(f"d{i}" for i in range(10))
ALL_TWENTY = sorted(f"d{i}" for i in range(20))


@pytest.mark.parametrize("kind", ["port", "reference"])
@pytest.mark.parametrize("mode", ["deaf", "dead"])
def test_readded_replica_is_not_promoted_past_acked_writes(mode, kind,
                                                           tmp_path):
    """The kill -9 case's failure under load: the follower's lease lapsed
    (the master's TTL is one heartbeat period there), so the master
    dropped it while the leader acked writes alone, re-added the
    returning follower, and the leader died before the follower caught
    up ("deaf") or before the re-add ("dead"). The reference promotes the
    follower, and the writes the leader acked alone are gone from the new
    leader. The port widens a membership only once the leader runs it and
    raises the promotion watermark to the leader's log then, so it
    refuses (the partition waits for the leader's durable log): its
    stated departure, tests/test_torch_cluster.py
    STATED_EDITS["cluster/master.py"]."""
    got = _readd_then_failover(kind, tmp_path, mode)
    assert got["dropped"]
    assert got["held"] == FIRST_TEN
    if kind == "reference":
        assert got["readded"] and got["promoted"]
    else:
        assert got["readded"] is (mode == "deaf")
        assert not got["promoted"]


@pytest.mark.parametrize("kind", ["port", "reference"])
def test_readded_replica_caught_up_is_promoted(kind, tmp_path):
    """Once the re-added follower has replayed the leader's log, the
    watermark holds it back no more: both packages promote it, and it
    holds every acked doc."""
    got = _readd_then_failover(kind, tmp_path, "caught_up")
    assert got == {"dropped": True, "readded": True, "promoted": True,
                   "held": ALL_TWENTY}


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
