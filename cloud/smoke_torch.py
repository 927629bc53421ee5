#!/usr/bin/env python
"""Cluster-profile smoke suite of the PyTorch port: cloud/smoke.py's
topology and steps, with every role a real subprocess of
`python -m vearch_tpu_torch` — 3 metadata-raft masters, 2 routers, 3
partition servers — plus an in-process S3 endpoint. It asserts:

  1. replicated writes + search through BOTH routers;
  2. master leader kill -9 -> API keeps serving via the survivors;
  3. S3 backup -> delete-all -> restore round-trip;
  3b. gRPC search through a router (where grpcio and protobuf exist);
  3c. a live field addition and an online field index;
  4. PS kill -9 -> replicated partition keeps serving reads.

    python cloud/smoke_torch.py --device cpu   # partition servers on the CPU
    python cloud/smoke_torch.py                # partition servers on the card

Without `--device` each partition server runs its engines on the card,
and with no GPU visible it raises at start, as the launcher's does.
Exit 0 = all green. Each child's stderr goes to `<name>.log` under the
data dir; on a failure the tail of every log is printed.

`Roles`, `start_topology` and `MockS3` are what chip_smoke.py's
process phase drives the same topology with.
"""

from __future__ import annotations

import argparse
import collections
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlparse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

from vearch_tpu_torch.cluster import rpc  # noqa: E402
from vearch_tpu_torch.cluster.rpc import RpcError  # noqa: E402
from vearch_tpu_torch.sdk.client import VearchClient  # noqa: E402

D = 8
BANNER_S = 180.0  # deadline for a child's banner (a PS on the card
#                   imports torch and opens its CUDA context first)
LOG_TAIL = 40  # lines of each child's log printed on a failure


class MockS3:
    """Tiny S3-compatible server: PUT/GET object + ListObjectsV2,
    asserting SigV4-shaped auth headers on every request. The port's own
    copy of tests/test_objectstore_s3.py's class (stdlib only)."""

    def __init__(self):
        self.objects: dict[str, bytes] = {}
        self.auth_seen: list[str] = []
        outer = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _check_auth(self):
                auth = self.headers.get("Authorization", "")
                outer.auth_seen.append(auth)
                assert auth.startswith("AWS4-HMAC-SHA256 Credential="), auth
                assert "Signature=" in auth and "SignedHeaders=" in auth
                assert self.headers.get("x-amz-content-sha256")
                assert self.headers.get("x-amz-date")

            def do_PUT(self):
                self._check_auth()
                key = unquote(urlparse(self.path).path).lstrip("/")
                n = int(self.headers.get("Content-Length") or 0)
                outer.objects[key] = self.rfile.read(n)
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_HEAD(self):
                self._check_auth()
                key = unquote(urlparse(self.path).path).lstrip("/")
                self.send_response(200 if key in outer.objects else 404)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_DELETE(self):
                self._check_auth()
                key = unquote(urlparse(self.path).path).lstrip("/")
                existed = outer.objects.pop(key, None) is not None
                self.send_response(204 if existed else 404)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_GET(self):
                self._check_auth()
                parsed = urlparse(self.path)
                key = unquote(parsed.path).lstrip("/")
                qs = parse_qs(parsed.query)
                if "list-type" in qs:
                    from xml.sax.saxutils import escape

                    bucket = key.rstrip("/")
                    prefix = qs.get("prefix", [""])[0]
                    keys = sorted(
                        k[len(bucket) + 1:] for k in outer.objects
                        if k.startswith(f"{bucket}/{prefix}")
                    )
                    body = (
                        "<?xml version='1.0'?><ListBucketResult>"
                        + "".join(f"<Key>{escape(k)}</Key>" for k in keys)
                        + "</ListBucketResult>"
                    ).encode()
                    self.send_response(200)
                elif key in outer.objects:
                    body = outer.objects[key]
                    self.send_response(200)
                else:
                    body = b"<Error><Code>NoSuchKey</Code></Error>"
                    self.send_response(404)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.addr = f"127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def free_ports(n: int) -> list[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


class Roles:
    """The role processes of one cluster, each `python -m <module>
    <args>` started from the checkout (`module`: vearch_tpu_torch, or the
    reference package where a test runs both). A child's stderr
    goes to `<log_dir>/<name>.log` (appended to, so a restart keeps the
    first run's lines); its stdout is read for the banner line and then
    drained by a thread, so a full pipe never stalls it."""

    def __init__(self, log_dir: str, module: str = "vearch_tpu_torch",
                 env: dict | None = None):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.module = module
        self.env = dict(os.environ, PYTHONPATH=REPO, **(env or {}))
        self.procs: dict[str, subprocess.Popen] = {}
        self.addrs: dict[str, str] = {}
        self.banners: dict[str, str] = {}
        self.args: dict[str, list[str]] = {}
        self.banner_s: dict[str, float] = {}
        self.stdout: dict[str, collections.deque] = {}

    def spawn(self, name: str, args: list[str]) -> subprocess.Popen:
        """Start a child; returns once it printed its banner (its address
        is then `addrs[name]`), or raises if it exited or stayed silent
        for BANNER_S. `banner_s[name]` is the seconds from the spawn to
        the banner (a partition server prints it after it registered and
        recovered its partitions from disk)."""
        t0 = time.monotonic()
        self.args[name] = args
        with open(os.path.join(self.log_dir, f"{name}.log"), "ab") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", self.module, *args],
                stdout=subprocess.PIPE, stderr=log, text=True, cwd=REPO,
                env=self.env)
        self.procs[name] = proc
        lines = self.stdout[name] = collections.deque(maxlen=LOG_TAIL)
        banner: list[str] = []
        first = threading.Event()

        def drain():
            for line in proc.stdout:
                lines.append(line.rstrip("\n"))
                if not banner:
                    banner.append(lines[-1])
                first.set()
            first.set()  # EOF: the child exited

        threading.Thread(target=drain, daemon=True,
                         name=f"drain-{name}").start()
        if not first.wait(BANNER_S) or not banner:
            raise RuntimeError(f"{name} printed no banner "
                               f"(exit code {proc.poll()})")
        self.banners[name] = banner[0]
        self.banner_s[name] = time.monotonic() - t0
        self.addrs[name] = banner[0].rsplit("http://", 1)[-1].split()[0]
        return proc

    def restart(self, name: str) -> subprocess.Popen:
        """Start `name` again with the arguments of its first start."""
        return self.spawn(name, self.args[name])

    def kill(self, name: str) -> None:
        """SIGKILL: no flush, no cleanup, nothing graceful."""
        proc = self.procs[name]
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)

    def close(self) -> None:
        for name in list(self.procs):
            self.kill(name)

    def tails(self) -> str:
        out = []
        for name, proc in self.procs.items():
            path = os.path.join(self.log_dir, f"{name}.log")
            try:
                with open(path, errors="replace") as f:
                    log = f.read().splitlines()[-LOG_TAIL:]
            except OSError as e:
                log = [repr(e)]
            out.append(f"--- {name} (exit code {proc.poll()}) stderr, "
                       f"last {len(log)} lines:")
            out.extend(log)
            out.append(f"--- {name} stdout:")
            out.extend(self.stdout.get(name, ()))
        return "\n".join(out)


def wait_http(addr: str, deadline: float = 60.0) -> None:
    t0 = time.time()
    while time.time() - t0 < deadline:
        try:
            rpc.call(addr, "GET", "/", timeout=2.0)
            return
        except RpcError:
            time.sleep(0.3)
    raise SystemExit(f"FAIL: {addr} did not come up")


def spawn_together(roles: Roles, specs: dict[str, list[str]]) -> None:
    """Start every child of `specs` (name -> launcher arguments) at once
    and wait for all their banners (a partition server on the card takes
    seconds to import torch and open its context)."""
    threads = [threading.Thread(target=roles.spawn, args=(name, args),
                                name=f"spawn-{name}")
               for name, args in specs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(BANNER_S + 10)
    for name in specs:
        if name not in roles.addrs:
            raise SystemExit(f"FAIL: {name} never printed its banner")


def start_topology(roles: Roles, data_dir: str, ps_args: list[str],
                   grpc_ports: list[int] | None = None) -> str:
    """3 masters (metadata raft over `--peers`), then 3 partition servers
    (each with `ps_args`) and 2 routers together, all registered and
    live. Returns the masters' address list."""
    mports = free_ports(3)
    peers = ",".join(f"{i + 1}=127.0.0.1:{p}" for i, p in enumerate(mports))
    master_list = ",".join(f"127.0.0.1:{p}" for p in mports)
    spawn_together(roles, {
        f"master{i + 1}": ["--role", "master", "--port", str(p),
                           "--data-dir", f"{data_dir}/m{i + 1}",
                           "--node-id", str(i + 1), "--peers", peers]
        for i, p in enumerate(mports)})
    for addr in master_list.split(","):
        wait_http(addr)
    spawn_together(roles, {
        **{f"ps{i + 1}": ["--role", "ps",
                          "--data-dir", f"{data_dir}/ps{i + 1}",
                          "--master-addr", master_list, *ps_args]
           for i in range(3)},
        # only when servable: a router crashes at startup if asked for
        # gRPC without grpcio/protobuf in the image
        **{f"router{i + 1}": ["--role", "router", "--master-addr", master_list,
                              *(["--grpc-port", str(grpc_ports[i])]
                                if grpc_ports else [])]
           for i in range(2)}})
    t0 = time.time()
    while not all(VearchClient(roles.addrs[f"router{i + 1}"]).is_live()
                  for i in range(2)):
        if time.time() - t0 > 60:
            raise SystemExit("FAIL: routers never went live")
        time.sleep(0.5)
    t0 = time.time()
    while len(rpc.call(master_list, "GET", "/servers")["servers"]) < 3:
        if time.time() - t0 > 60:
            raise SystemExit("FAIL: <3 PS registered")
        time.sleep(0.5)
    return master_list


def meta_leader(roles: Roles, master_list: str) -> str | None:
    """The name of the live master that holds the metadata lead."""
    for i, addr in enumerate(master_list.split(",")):
        name = f"master{i + 1}"
        if roles.procs[name].poll() is not None:
            continue
        try:
            if rpc.call(addr, "GET", "/", timeout=2.0).get("meta_leader"):
                return name
        except RpcError:
            pass
    return None


def placement(master_list: str, roles: Roles) -> str:
    """What a failed wait reports: the masters' partitions of every space
    (leader, replicas, term, promotion watermark) and each live partition
    server's raft state of the partitions it hosts."""
    lines = []
    try:
        for sp in rpc.call(master_list, "GET", "/dbs/db/spaces",
                           timeout=10.0)["spaces"]:
            for p in sp.get("partitions", []):
                lines.append(f"partition {p['id']}: " + ", ".join(
                    f"{k}={p.get(k)}" for k in ("leader", "replicas", "term",
                                                "promoted_log")))
    except RpcError as e:
        lines.append(f"no placement from the masters: {e}")
    for name, addr in sorted(roles.addrs.items()):
        if not name.startswith("ps") or roles.procs[name].poll() is not None:
            continue
        try:
            stats = rpc.call(addr, "GET", "/ps/stats", timeout=10.0)
        except RpcError as e:
            lines.append(f"{name}: {e}")
            continue
        for pid, part in sorted(stats["partitions"].items()):
            raft = part.get("raft") or {}
            lines.append(f"{name} partition {pid}: " + ", ".join(
                f"{k}={raft.get(k)}" for k in ("node_id", "is_leader", "term",
                                               "commit", "applied",
                                               "last_index")))
    return "; ".join(lines)


def grpc_missing() -> list[str]:
    """Which of grpcio and protobuf this machine lacks. With both, a
    router serves gRPC, with protoc's generated classes or, without
    protoc, those of the descriptor set beside cluster/grpc_server.py."""
    import importlib.util

    def importable(mod):
        try:
            return importlib.util.find_spec(mod) is not None
        except ModuleNotFoundError:  # its parent package is missing
            return False

    return [name for name, mod in (("grpcio", "grpc"),
                                   ("protobuf", "google.protobuf"))
            if not importable(mod)]


def main(data_dir: str, device: str | None = None) -> int:
    grpc_on = not grpc_missing()
    gports = free_ports(2) if grpc_on else None
    roles = Roles(os.path.join(data_dir, "logs"))
    s3 = MockS3()
    ok = False
    try:
        master_list = start_topology(
            roles, data_dir, ["--device", device] if device else [], gports)
        r1 = VearchClient(roles.addrs["router1"])
        r2 = VearchClient(roles.addrs["router2"])

        # 1. replicated space, writes via r1, reads via r2
        r1.create_database("db")
        r1.create_space("db", {
            "name": "s", "partition_num": 3, "replica_num": 2,
            "fields": [{"name": "v", "data_type": "vector", "dimension": D,
                        "index": {"index_type": "FLAT", "metric_type": "L2",
                                  "params": {}}}],
        })
        rng = np.random.default_rng(0)
        vecs = rng.standard_normal((120, D)).astype(np.float32)
        r1.upsert("db", "s", [{"_id": f"d{i}", "v": vecs[i]}
                              for i in range(120)])
        hits = r2.search("db", "s", [{"field": "v", "feature": vecs[7]}],
                         limit=1)
        assert hits[0][0]["_id"] == "d7", hits
        print("smoke 1 OK: replicated writes, cross-router reads",
              flush=True)

        # 2. kill -9 the master leader; the API must keep serving
        leader = meta_leader(roles, master_list) or "master1"
        roles.kill(leader)
        t0 = time.time()
        while True:
            try:
                r2.get_space("db", "s")
                break
            except RpcError:
                if time.time() - t0 > 60:
                    raise SystemExit(
                        "FAIL: API dead after master leader kill")
                time.sleep(0.5)
        hits = r1.search("db", "s", [{"field": "v", "feature": vecs[9]}],
                         limit=1)
        assert hits[0][0]["_id"] == "d9"
        # mutations need a NEW metadata leader elected among survivors
        t0 = time.time()
        while meta_leader(roles, master_list) is None:
            if time.time() - t0 > 60:
                raise SystemExit("FAIL: no new metadata leader elected")
            time.sleep(0.5)
        print(f"smoke 2 OK: {leader} killed, survivors re-elected + serve",
              flush=True)

        # 3. S3 backup -> wipe -> restore
        spec = {"type": "s3", "endpoint": s3.addr, "bucket": "bk",
                "access_key": "ak", "secret_key": "sk"}
        out = rpc.call(master_list, "POST", "/backup/dbs/db/spaces/s",
                       {"command": "create", "store": spec})
        assert out["version"] == 1, out
        r1.delete("db", "s", document_ids=[f"d{i}" for i in range(120)])
        assert r1.search("db", "s", [{"field": "v", "feature": vecs[7]}],
                         limit=1)[0] == []
        out = rpc.call(master_list, "POST", "/backup/dbs/db/spaces/s",
                       {"command": "restore", "store": spec, "version": 1})
        assert sum(p["doc_count"] for p in out["partitions"]) == 120
        hits = r2.search("db", "s", [{"field": "v", "feature": vecs[7]}],
                         limit=1)
        assert hits[0][0]["_id"] == "d7"
        print("smoke 3 OK: S3 backup/restore round-trip", flush=True)

        # 3b. gRPC front door; the service keeps the proto's name
        if not grpc_on:
            print("smoke 3b SKIP: grpcio/protobuf not installed", flush=True)
        else:
            import grpc as grpclib

            from vearch_tpu_torch.cluster.grpc_server import load_pb2

            pb2 = load_pb2()
            ch = grpclib.insecure_channel(f"127.0.0.1:{gports[0]}")
            se = ch.unary_unary(
                "/vearch_tpu.Router/Search",
                request_serializer=pb2.SearchRequest.SerializeToString,
                response_deserializer=pb2.SearchResponse.FromString,
            )
            resp = se(pb2.SearchRequest(
                db_name="db", space_name="s",
                vectors=[pb2.VectorQuery(field="v",
                                         feature=vecs[7].tolist())],
                limit=1), timeout=30)
            assert resp.results[0].items[0].id == "d7"
            ch.close()
            print("smoke 3b OK: gRPC search through router1", flush=True)
        # 3c. online schema evolution: add a scalar field, index it
        # live, filter on it — through the multi-master list
        rpc.call(master_list, "PUT", "/dbs/db/spaces/s",
                 {"fields": [{"name": "grade", "data_type": "integer"}]})
        t0 = time.time()
        while True:
            try:
                r1.upsert("db", "s", [{"_id": "g1", "grade": 7,
                                       "v": vecs[0].tolist()}])
                break
            except RpcError:
                # replicas can still be settling right after the
                # restore swapped partition state under them
                if time.time() - t0 > 30:
                    raise
                time.sleep(1.0)
        rpc.call(master_list, "POST", "/field_index",
                 {"db_name": "db", "space_name": "s", "field": "grade",
                  "index_type": "INVERTED", "background": False})
        docs = r1.query("db", "s", filters={
            "operator": "AND", "conditions": [
                {"operator": "=", "field": "grade", "value": 7}]},
            limit=10)
        assert [d["_id"] for d in docs] == ["g1"], docs
        print("smoke 3c OK: live field addition + online field index",
              flush=True)

        # 4. kill -9 one PS; replica_num=2 keeps every partition served
        roles.kill("ps1")
        t0 = time.time()
        last = None
        while True:
            try:
                hits = r1.search("db", "s",
                                 [{"field": "v", "feature": vecs[11]}],
                                 limit=1)
                if hits[0] and hits[0][0]["_id"] == "d11":
                    break
                last = hits
            except RpcError as e:
                last = e
            if time.time() - t0 > 90:
                raise SystemExit("FAIL: search dead after PS kill; last "
                                 f"answer {last!r}; "
                                 f"{placement(master_list, roles)}")
            time.sleep(0.5)
        print("smoke 4 OK: PS killed, replicas keep serving", flush=True)
        print("CLUSTER SMOKE: ALL GREEN", flush=True)
        ok = True
        return 0
    finally:
        roles.close()
        s3.stop()
        if not ok:
            print(roles.tails(), file=sys.stderr, flush=True)


if __name__ == "__main__":
    import tempfile

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="the partition servers' torch device (default: "
                         "the card; 'cpu' runs the plain versions)")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory(prefix="vearch_smoke_") as d:
        sys.exit(main(d, args.device))
