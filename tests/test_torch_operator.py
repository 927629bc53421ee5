"""The port's operator surface on the CPU: the router's gRPC front end,
the elasticity and backup CLIs, and the cluster doctor.

- Copies: `cluster/grpc_server.py` (tests/test_torch_cluster.py),
  `tools/backup_cli.py`, `tools/elastic_cli.py` and `obs/doctor.py` are
  the reference's files with `vearch_tpu.` rewritten to
  `vearch_tpu_torch.`, plus the edits each test names; the doctor's
  drift check reads the port's lint rule `tools/lint/rules_obs.py`,
  whose name patterns and drift functions are the reference's verbatim.
- gRPC: a port cluster and a reference cluster, each with its router's
  gRPC port open, take the same docs through gRPC; searches, queries and
  deletes answer with the same ids, scores allclose at rtol 1e-5, atol
  1e-5 (FLAT's exact f32 products in another summation order), and the
  port's gRPC answers equal its own HTTP answers exactly.
- CLIs: `python -m vearch_tpu_torch {plan,rebalance,split,jobs,migrate,
  drain}` and `python -m vearch_tpu_torch.tools.backup_cli` run as
  subprocesses against a port cluster; every doc survives.
- Doctor: the SLO-burn scenario of tests/test_accounting.py on a port
  cluster gives the reference's verdicts, check by check (`lint_clean`
  runs the port's lint over the port's tree), and exit code 1 from
  `python -m vearch_tpu_torch doctor` as from `doctor.run`.

Every port partition server runs on device="cpu".
"""

import inspect
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

from vearch_tpu.cluster.standalone import StandaloneCluster as RefCluster
from vearch_tpu.obs import doctor as ref_doctor
from vearch_tpu.tools.lint import rules_obs as ref_rules_obs
from vearch_tpu_torch.cluster import rpc
from vearch_tpu_torch.cluster.standalone import StandaloneCluster
from vearch_tpu_torch.obs import doctor
from vearch_tpu_torch.tools.lint import rules_obs
from vearch_tpu_torch.sdk.client import VearchClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 8
PS_KW = {"device": "cpu", "heartbeat_interval": 0.3}


def _read(*parts) -> str:
    with open(os.path.join(REPO, *parts), encoding="utf-8") as f:
        return f.read()


def _rewrite(src: str) -> str:
    src = re.sub(r"\bvearch_tpu\.", "vearch_tpu_torch.", src)
    return src.replace("from vearch_tpu import", "from vearch_tpu_torch import")


# -- copies ---------------------------------------------------------------------

def test_backup_cli_is_the_reference_copy():
    assert _read("vearch_tpu_torch", "tools", "backup_cli.py") == _rewrite(
        _read("vearch_tpu", "tools", "backup_cli.py"))


def test_elastic_cli_differs_only_in_its_usage_lines():
    ref = _rewrite(_read("vearch_tpu", "tools", "elastic_cli.py"))
    ref = ref.replace("    python -m vearch_tpu ",
                      "    python -m vearch_tpu_torch ")
    assert _read("vearch_tpu_torch", "tools", "elastic_cli.py") == ref


def test_doctor_differs_only_where_stated():
    """The copy differs only in its usage lines and in its drift check,
    which reads the shared docs/OBSERVABILITY.md and the port's own
    docs/OBSERVABILITY_TORCH.md as one through the port's lint rule;
    lint_clean runs the port's lint over the port's tree, both through
    the rewritten imports."""
    ref = _rewrite(_read("vearch_tpu", "obs", "doctor.py"))
    ref = ref.replace("python -m vearch_tpu doctor",
                      "python -m vearch_tpu_torch doctor")
    old = ("    failures = rules_obs.drift_failures(\n"
           "        *rules_obs.source_names(pkg_root), doc\n")
    assert ref.count(old) == 1
    ref = ref.replace(old, (
        "    failures = rules_obs.drift_failures_over(\n"
        "        *rules_obs.source_names(pkg_root), rules_obs.doc_paths()\n"))
    assert _read("vearch_tpu_torch", "obs", "doctor.py") == ref
    ok, detail = doctor._check_lint_clean()
    assert ok is True, detail
    assert detail.startswith("0 hard finding(s), ")


@pytest.mark.parametrize("name", ["_METRIC_RE", "_TAG_RE", "_SPAN_RES",
                                  "_normalize", "names_from_text",
                                  "source_names", "doc_names",
                                  "drift_failures"])
def test_obs_docs_helpers_are_the_references(name):
    mine, ref = getattr(rules_obs, name), getattr(ref_rules_obs, name)
    if callable(mine) and not hasattr(mine, "pattern"):
        assert inspect.getsource(mine) == inspect.getsource(ref)
    else:
        pats = mine if isinstance(mine, list) else [mine]
        refs = ref if isinstance(ref, list) else [ref]
        assert [(p.pattern, p.flags) for p in pats] == \
            [(p.pattern, p.flags) for p in refs]


def test_obs_docs_check_passes_on_the_port_tree():
    assert doctor._check_obs_docs() == (True, "docs match source")


# -- gRPC -----------------------------------------------------------------------

def _space(cl):
    cl.create_database("g")
    cl.create_space("g", {
        "name": "sp", "partition_num": 2, "replica_num": 1,
        "fields": [
            {"name": "color", "data_type": "string"},
            {"name": "emb", "data_type": "vector", "dimension": D,
             "index": {"index_type": "FLAT", "metric_type": "L2",
                       "params": {}}},
        ],
    })


def _stubs(grpc, channel, pb2):
    def stub(method, req, resp):
        return channel.unary_unary(
            f"/vearch_tpu.Router/{method}",
            request_serializer=req.SerializeToString,
            response_deserializer=resp.FromString)

    return {
        "upsert": stub("Upsert", pb2.UpsertRequest, pb2.UpsertResponse),
        "search": stub("Search", pb2.SearchRequest, pb2.SearchResponse),
        "query": stub("Query", pb2.QueryRequest, pb2.QueryResponse),
        "delete": stub("Delete", pb2.DeleteRequest, pb2.DeleteResponse),
    }


def _grpc_session(grpc, addr, pb2, vecs):
    """Upsert, search (plain, batched, filtered), query, delete and query
    again through one channel; returns the answers as plain data."""
    channel = grpc.insecure_channel(addr)
    try:
        s = _stubs(grpc, channel, pb2)
        up = s["upsert"](pb2.UpsertRequest(
            db_name="g", space_name="sp", documents=[
                pb2.Document(id=f"d{i}", fields_json=json.dumps({
                    "color": ["red", "blue"][i % 2],
                    "emb": vecs[i].tolist()})) for i in range(50)]))
        filt = {"operator": "AND", "conditions": [
            {"operator": "=", "field": "color", "value": "red"}]}
        searches = []
        for feature, limit, flt in (
                (vecs[7], 5, None), (np.concatenate([vecs[3], vecs[4]]), 3,
                                     None), (vecs[7], 5, filt)):
            resp = s["search"](pb2.SearchRequest(
                db_name="g", space_name="sp",
                vectors=[pb2.VectorQuery(field="emb",
                                         feature=feature.ravel().tolist())],
                limit=limit, fields=["color"],
                filters_json=json.dumps(flt) if flt else ""))
            searches.append([[(it.id, it.score,
                               json.loads(it.fields_json or "{}"))
                              for it in r.items] for r in resp.results])
        qr = s["query"](pb2.QueryRequest(db_name="g", space_name="sp",
                                         document_ids=["d3", "d9"]))
        dr = s["delete"](pb2.DeleteRequest(db_name="g", space_name="sp",
                                           document_ids=["d3"]))
        qr2 = s["query"](pb2.QueryRequest(db_name="g", space_name="sp",
                                          document_ids=["d3"]))
        return {"upserted": up.total, "searches": searches,
                "query": sorted((d.id, d.fields_json) for d in qr.documents),
                "deleted": dr.total, "after": len(qr2.documents)}
    finally:
        channel.close()


def test_grpc_front_end_matches_reference_and_http(tmp_path):
    grpc = pytest.importorskip("grpc")
    from vearch_tpu.cluster.grpc_server import load_pb2 as ref_pb2
    from vearch_tpu_torch.cluster.grpc_server import load_pb2

    vecs = np.random.default_rng(3).standard_normal((50, D)).astype(
        np.float32)
    answers = {}
    for name, cls, kw, pb2 in (
            ("port", StandaloneCluster, PS_KW, load_pb2()),
            ("ref", RefCluster, {"heartbeat_interval": 0.3}, ref_pb2())):
        c = cls(data_dir=str(tmp_path / name), n_ps=1, ps_kwargs=kw,
                router_kwargs={"grpc_port": 0})
        c.start()
        try:
            cl = VearchClient(c.router_addr)
            _space(cl)
            answers[name] = _grpc_session(grpc, c.router.grpc.addr, pb2,
                                          vecs)
            if name == "port":
                # the port's gRPC answers are its HTTP answers
                http = cl.search("g", "sp", [{"field": "emb",
                                              "feature": vecs[7].tolist()}],
                                 limit=5, fields=["color"])
                got = answers[name]["searches"][0][0]
                assert [d["_id"] for d in http[0]] == [g[0] for g in got]
                assert [d["_score"] for d in http[0]] == [g[1] for g in got]
        finally:
            c.stop()
    port, ref = answers["port"], answers["ref"]
    assert port["upserted"] == ref["upserted"] == 50
    assert port["query"] == ref["query"]
    assert (port["deleted"], port["after"]) == (ref["deleted"],
                                                ref["after"]) == (1, 0)
    for ps, rs in zip(port["searches"], ref["searches"]):
        assert [[(i, f) for i, _s, f in row] for row in ps] == \
            [[(i, f) for i, _s, f in row] for row in rs]
        np.testing.assert_allclose(
            [[s for _i, s, _f in row] for row in ps],
            [[s for _i, s, _f in row] for row in rs], rtol=1e-5, atol=1e-5)
    assert port["searches"][1][0][0][0] == "d3"
    assert port["searches"][1][1][0][0] == "d4"
    assert all(f["color"] == "red" for _i, _s, f in port["searches"][2][0])


def test_grpc_descriptor_set_is_protocs(tmp_path):
    """vearch_tpu_torch/cluster/vearch_proto.desc is what protoc writes
    for api/vearch.proto, and the classes built from it serialize each
    message as protoc's generated ones do."""
    import shutil

    from vearch_tpu_torch.cluster import grpc_server

    if shutil.which("protoc") is None:
        pytest.skip("no protoc on this machine to hold the file against")
    out = tmp_path / "vearch.desc"
    subprocess.run(["protoc", f"-I{os.path.join(REPO, 'api')}",
                    f"--descriptor_set_out={out}",
                    os.path.join(REPO, "api", "vearch.proto")], check=True,
                   capture_output=True, timeout=60)
    with open(os.path.join(REPO, "vearch_tpu_torch", "cluster",
                           "vearch_proto.desc"), "rb") as f:
        assert f.read() == out.read_bytes()
    built, generated = grpc_server.pb2_from_descriptor_set(), \
        grpc_server.load_pb2()
    for name in generated.DESCRIPTOR.message_types_by_name:
        assert name in built.DESCRIPTOR.message_types_by_name
    req = dict(db_name="g", space_name="sp", limit=3, trace=True,
               index_params_json='{"rerank": 16}')
    feats = [0.5, -1.25, 3.0]
    a = built.SearchRequest(vectors=[built.VectorQuery(
        field="emb", feature=feats, min_score=0.1)], **req)
    b = generated.SearchRequest(vectors=[generated.VectorQuery(
        field="emb", feature=feats, min_score=0.1)], **req)
    assert a.SerializeToString() == b.SerializeToString()
    back = generated.SearchRequest.FromString(a.SerializeToString())
    assert back.vectors[0].HasField("min_score") and back.limit == 3


def test_grpc_front_end_without_protoc(tmp_path, monkeypatch):
    """On a machine without protoc the router's message classes come from
    the descriptor set, and the gRPC session answers as with protoc's
    generated classes."""
    grpc = pytest.importorskip("grpc")
    import shutil

    from vearch_tpu_torch.cluster import grpc_server

    vecs = np.random.default_rng(5).standard_normal((50, D)).astype(
        np.float32)
    answers = {}
    for name in ("protoc", "descriptor_set"):
        if name == "descriptor_set":
            which = shutil.which
            monkeypatch.setattr(grpc_server, "_pb2_mod", None)
            # no generated module cached either
            monkeypatch.setattr(grpc_server, "_GEN_DIR", str(tmp_path / "gen"))
            monkeypatch.setattr(
                grpc_server.shutil, "which",
                lambda cmd: None if cmd == "protoc" else which(cmd))
        pb2 = grpc_server.load_pb2()
        c = StandaloneCluster(data_dir=str(tmp_path / name), n_ps=1,
                              ps_kwargs=PS_KW,
                              router_kwargs={"grpc_port": 0})
        c.start()
        try:
            _space(VearchClient(c.router_addr))
            answers[name] = _grpc_session(grpc, c.router.grpc.addr, pb2,
                                          vecs)
        finally:
            c.stop()
        # protoc's classes live in a generated file, the others in none
        assert (getattr(pb2, "__file__", None) is None) is (
            name == "descriptor_set")
    assert answers["protoc"] == answers["descriptor_set"]
    assert answers["descriptor_set"]["upserted"] == 50


def test_grpc_port_without_grpcio_raises(monkeypatch):
    """A router asked for a gRPC port raises when grpcio is missing, as
    the reference's does: it never serves HTTP alone instead."""
    from vearch_tpu_torch.cluster.router import RouterServer

    monkeypatch.setitem(sys.modules, "grpc", None)
    router = RouterServer(master_addr="127.0.0.1:9", grpc_port=0)
    try:
        with pytest.raises(ImportError):
            router.start()
    finally:
        router.server.stop()


# -- the CLIs -------------------------------------------------------------------

def _cli(*argv, timeout=180):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_elastic_and_backup_clis_on_a_port_cluster(tmp_path):
    c = StandaloneCluster(data_dir=str(tmp_path / "c"), n_ps=1,
                          ps_kwargs=PS_KW)
    c.start()
    try:
        cl = VearchClient(c.router_addr, master_addr=c.master_addr)
        cl.create_database("db")
        cl.create_space("db", {
            "name": "s", "partition_num": 1, "replica_num": 1,
            "fields": [{"name": "v", "data_type": "vector", "dimension": D,
                        "index": {"index_type": "FLAT",
                                  "metric_type": "L2", "params": {}}}]})
        vecs = np.random.default_rng(5).standard_normal((300, D))
        cl.upsert("db", "s", [{"_id": f"d{i}", "v": vecs[i].tolist()}
                              for i in range(300)])
        m = ["--master", c.master_addr]
        out = _cli("vearch_tpu_torch", "plan", *m)
        assert out.returncode == 0, out.stderr
        assert {"imbalance", "moves"} <= set(json.loads(out.stdout))
        out = _cli("vearch_tpu_torch", "rebalance", *m)
        assert out.returncode == 0 and \
            json.loads(out.stdout)["applied"] is False
        pid = cl.get_space("db", "s")["partitions"][0]["id"]
        out = _cli("vearch_tpu_torch", "split", *m, "--db", "db",
                   "--space", "s", "--partition", str(pid))
        assert out.returncode == 0, out.stderr
        job = json.loads(out.stdout)
        assert job["status"] == "done" and job["op"] == "split"
        out = _cli("vearch_tpu_torch", "jobs", *m, "--job", job["job_id"])
        assert out.returncode == 0 and \
            json.loads(out.stdout)["status"] == "done"
        children = [p["id"] for p in cl.get_space("db", "s")["partitions"]]
        assert len(children) == 2 and pid not in children
        fresh = c.add_ps()
        for _ in range(300):
            servers = rpc.call(c.master_addr, "GET", "/servers")["servers"]
            if any(s["node_id"] == fresh.node_id for s in servers):
                break
            time.sleep(0.1)
        out = _cli("vearch_tpu_torch", "migrate", *m, "--partition",
                   str(children[0]), "--to", str(fresh.node_id))
        assert out.returncode == 0, out.stderr
        src = c.ps_nodes[0].node_id
        out = _cli("vearch_tpu_torch", "drain", str(src), *m, "--apply")
        assert out.returncode == 0, out.stderr
        servers = rpc.call(c.master_addr, "GET", "/servers")["servers"]
        assert next(s for s in servers
                    if s["node_id"] == src)["partition_ids"] == []
        assert len(cl.query("db", "s", limit=400, fields=[])) == 300
        # the backup CLI: create, list, restore through the master
        store = str(tmp_path / "store")
        b = ["vearch_tpu_torch.tools.backup_cli", *m, "--db", "db",
             "--space", "s", "--store-root", store]
        out = _cli(*b, "create")
        assert out.returncode == 0, out.stderr
        out = _cli(*b, "list")
        assert out.returncode == 0, out.stderr
        assert json.loads(out.stdout)
        cl.delete("db", "s", document_ids=["d0", "d1"])
        out = _cli(*b, "restore", "--version", "1")
        assert out.returncode == 0, out.stderr
        assert len(cl.query("db", "s", limit=400, fields=[])) == 300
    finally:
        c.stop()


# -- the doctor -----------------------------------------------------------------

def _slo_burn(cluster_cls, ps_kwargs, tmp, rng_seed=7):
    """tests/test_accounting.py's scenario: a space whose SLO every
    request violates, 28 searches, then the doctor."""
    c = cluster_cls(data_dir=tmp, n_ps=1, ps_kwargs=ps_kwargs)
    c.start()
    rng = np.random.default_rng(rng_seed)
    cl = VearchClient(c.router_addr)
    cl.create_database("db")
    cl.create_space("db", {
        "name": "s", "partition_num": 1, "replica_num": 1,
        "slo": {"latency_ms": 0.001, "availability": 0.999},
        "fields": [{"name": "v", "data_type": "vector", "dimension": D,
                    "index": {"index_type": "FLAT", "metric_type": "L2",
                              "params": {}}}]})
    vecs = rng.standard_normal((40, D)).astype(np.float32)
    cl.upsert("db", "s", [{"_id": f"d{i}", "v": vecs[i]} for i in range(40)])

    def search():
        q = rng.standard_normal(D).astype(np.float32)
        rpc.call(c.router_addr, "POST", "/document/search", {
            "db_name": "db", "space_name": "s",
            "vectors": [{"field": "v", "feature": q.tolist()}],
            "limit": 3, "cache": False})

    for _ in range(3):
        search()
    rpc.call(c.ps_nodes[0].addr, "POST", "/debug/compiles/reset")
    for _ in range(25):
        search()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        h = rpc.call(c.master_addr, "GET", "/cluster/health")
        u = rpc.call(c.master_addr, "GET", "/cluster/usage")
        if "db/s" in (h.get("slo_fast_burn_spaces") or []) and \
                u["spaces"].get("db/s", {}).get("requests", 0) >= 25:
            break
        time.sleep(0.2)
    return c


def test_doctor_on_slo_burn_matches_reference(tmp_path):
    verdicts = {}
    for name, cls, kw, mod in (
            ("port", StandaloneCluster, PS_KW, doctor),
            ("ref", RefCluster, {"heartbeat_interval": 0.3}, ref_doctor)):
        c = _slo_burn(cls, kw, str(tmp_path / name))
        try:
            report, code = mod.run(c.master_addr)
            verdicts[name] = (code, {ch["name"]: (ch["ok"], ch.get("skipped", False))
                                     for ch in report["checks"]},
                              {v["name"] for v in report["violations"]})
            assert "db/s" in mod.format_report(report)
            if name == "port":
                out = _cli("vearch_tpu_torch", "doctor", "--master",
                           c.master_addr)
                assert out.returncode == 1, out.stderr
                assert "slo_burn" in out.stdout
        finally:
            c.stop()
    (pcode, pchecks, pviol), (rcode, rchecks, rviol) = \
        verdicts["port"], verdicts["ref"]
    assert pcode == rcode == 1
    # each package's lint over its own tree: clean, not skipped
    assert pchecks["lint_clean"] == (True, False)
    assert pchecks == rchecks
    assert "slo_burn" in pviol and "usage_conservation" not in pviol
    assert pviol == rviol
