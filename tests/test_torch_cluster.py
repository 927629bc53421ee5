"""The port's cluster plane (vearch_tpu_torch/cluster/, sdk/, utils/,
tools/lockcheck.py, native/) held against the reference's on the CPU.

- Source copies: every module of the cluster plane that touches no device
  is the reference's file with its imports rewritten (`vearch_tpu.` ->
  `vearch_tpu_torch.`); the tests hold each copy equal to the reference
  after the same rewrite, and the modules that change (ps.py, utils,
  standalone.py, __main__.py) equal to it after their stated edits.
  csrc/vearch_native.cpp is byte-equal, and the port's murmur3 slots are
  the reference's, so a doc lands in the same partition in both packages.
- Same docs, four clusters: a reference cluster, a port cluster, and two
  mixed ones (a reference master and router in front of port partition
  servers, and the reverse) serve the same seeded docs in a 2-partition
  FLAT L2 space. Search, a filtered search, get, query, delete and each
  partition's doc count must give the reference cluster's answer: ids
  equal, scores allclose at rtol 1e-5, atol 1e-3 (FLAT's products are
  exact in f32 in both packages; only the summation order differs).

Every port partition server runs on device="cpu".
"""

import os
import re

import numpy as np
import pytest

from vearch_tpu.cluster import hashing as ref_hashing
from vearch_tpu.cluster.master import MasterServer as RefMaster
from vearch_tpu.cluster.ps import PSServer as RefPS
from vearch_tpu.cluster.router import RouterServer as RefRouter
from vearch_tpu.sdk.client import VearchClient
from vearch_tpu_torch.cluster.master import MasterServer as PortMaster
from vearch_tpu_torch.cluster.ps import PSServer as PortPS
from vearch_tpu_torch.cluster.router import RouterServer as PortRouter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 32
N = 1200
RTOL, ATOL = 1e-5, 1e-3

# modules of the cluster plane that are whole-file copies of the
# reference's (paths under each package)
COPIES = [
    "utils/log.py",
    "tools/__init__.py",
    "tools/lockcheck.py",
    "sdk/__init__.py",
    "sdk/client.py",
    "sdk/objects.py",
    "cluster/__init__.py",
    "cluster/admission.py",
    "cluster/auth.py",
    "cluster/config.py",
    "cluster/elastic.py",
    "cluster/entities.py",
    "cluster/hashing.py",
    "cluster/master.py",
    "cluster/metastore.py",
    "cluster/metrics.py",
    "cluster/objectstore.py",
    "cluster/querycache.py",
    "cluster/raft.py",
    "cluster/router.py",
    "cluster/rpc.py",
    "cluster/tracing.py",
    "cluster/wal.py",
]


def _read(*parts) -> str:
    with open(os.path.join(REPO, *parts), encoding="utf-8") as f:
        return f.read()


# comment wording the copies change (the code is the reference's)
COMMENT_EDITS = {"acquire (reviewer-found lost-update race).":
                 "acquire (a lost-update race found earlier)."}


def rewrite_imports(src: str) -> str:
    """The edits a copy carries: imports of the reference package become
    imports of the port, and the COMMENT_EDITS."""
    src = re.sub(r"\bvearch_tpu\.", "vearch_tpu_torch.", src)
    for old, new in COMMENT_EDITS.items():
        src = src.replace(old, new)
    return src.replace("from vearch_tpu import", "from vearch_tpu_torch import")


def _replace(src: str, old: str, new: str) -> str:
    assert src.count(old) == 1, old
    return src.replace(old, new)


@pytest.mark.parametrize("path", COPIES)
def test_copy_equals_reference_after_import_rewrite(path):
    assert _read("vearch_tpu_torch", path) == rewrite_imports(
        _read("vearch_tpu", path))


def test_ps_differs_from_reference_only_by_its_device():
    """ps.py's departure: an explicit device, resolved once, reaches the
    four engine sites (create, restart reopen, snapshot install,
    backup restore); the JAX platform env is gone."""
    ref = rewrite_imports(_read("vearch_tpu", "cluster", "ps.py"))
    ref = _replace(ref, '''truncates the log behind it (reference: store_raft_job.go:97,40).
"""''', '''truncates the log behind it (reference: store_raft_job.go:97,40).

The port's copy of vearch_tpu/cluster/ps.py: the same server over the
port's Engine, with one departure. `PSServer(device=None)` resolves the
device every engine of the server runs on once, at construction (the
card unless the caller asks for the CPU; no GPU and no device raises),
and passes it to each Engine and Engine.open.
"""''')
    ref = _replace(ref, '''        admission_queue_limit: int = 0,
    ):
        from vearch_tpu_torch.utils import apply_jax_platform_env

        apply_jax_platform_env()  # before any engine touches jax
''', '''        admission_queue_limit: int = 0,
        device=None,
    ):
        from vearch_tpu_torch.device import resolve_device

        # every engine of this server runs here: the card unless the
        # caller asks for the CPU; resolved now, so a PS on a box with no
        # GPU raises at start, not at its first create_partition
        self.device = resolve_device(device)
''')
    assert ref.count("eng = Engine.open(pdir)\n") == 2
    ref = ref.replace("eng = Engine.open(pdir)\n",
                      "eng = Engine.open(pdir, device=self.device)\n")
    ref = _replace(ref, "eng = Engine(schema, data_dir=pdir)",
                   "eng = Engine(schema, data_dir=pdir, device=self.device)")
    ref = _replace(ref, "restored = Engine.open(data_dir)",
                   "restored = Engine.open(data_dir, device=self.device)")
    assert _read("vearch_tpu_torch", "cluster", "ps.py") == ref


def test_utils_and_standalone_differ_only_where_stated():
    ref = rewrite_imports(_read("vearch_tpu", "utils", "__init__.py"))
    port = _read("vearch_tpu_torch", "utils", "__init__.py")
    # the JAX-only helpers are dropped; everything else is the reference's
    assert "jax" not in port
    kept = ref[:ref.index("def apply_jax_platform_env")] + \
        ref[ref.index("def prune_job_registry"):]
    assert port.endswith(kept[kept.index("# Span epochs"):])
    ref = rewrite_imports(_read("vearch_tpu", "cluster", "standalone.py"))
    port = _read("vearch_tpu_torch", "cluster", "standalone.py")
    body = ref[ref.index("from __future__"):]
    assert port.endswith(body)


def test_sort_copy_equals_reference_below_its_docstring():
    """The router merges and validates sorts through the port's
    engine/sort.py (validate_sort, row_sort_key): its code must be the
    reference's."""
    ref = _read("vearch_tpu", "engine", "sort.py")
    port = _read("vearch_tpu_torch", "engine", "sort.py")
    start = "from __future__ import annotations"
    assert port[port.index(start):] == ref[ref.index(start):]


def test_native_source_is_byte_equal():
    with open(os.path.join(REPO, "csrc", "vearch_native.cpp"), "rb") as f:
        ref = f.read()
    with open(os.path.join(REPO, "vearch_tpu_torch", "csrc",
                           "vearch_native.cpp"), "rb") as f:
        assert f.read() == ref


def test_murmur3_batch_gives_the_reference_slots():
    from vearch_tpu_torch import native

    rng = np.random.default_rng(5)
    keys = [f"doc-{i}" for i in range(9000)]
    keys += ["", "é", "日本語キー", "emoji-\U0001F600", "tab\tkey"]
    keys += ["".join(chr(int(c)) for c in rng.integers(32, 0x3000, size=9))
             for _ in range(1000 - 5)]
    got = native.murmur3_batch(keys)
    assert got.dtype == np.uint32 and got.shape == (len(keys),)
    want = np.asarray([ref_hashing.key_slot(k) for k in keys],
                      dtype=np.uint32)
    np.testing.assert_array_equal(got, want)
    # the port's library is its own build, not the reference's .so
    assert native.LIBRARY.path.startswith(
        os.path.join(REPO, "vearch_tpu_torch", "_build") + os.sep)


def test_merge_topk_and_read_fvecs_match_reference(tmp_path):
    from vearch_tpu import native as ref_native
    from vearch_tpu_torch import native

    rng = np.random.default_rng(6)
    scores = rng.standard_normal((8, 50)).astype(np.float32)
    ids = rng.permutation(400)[:400].reshape(8, 50).astype(np.int64)
    for desc in (True, False):
        got = native.merge_topk(scores, ids, 7, desc)
        want = ref_native.merge_topk(scores, ids, 7, desc)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    rows = rng.standard_normal((13, 6)).astype(np.float32)
    path = str(tmp_path / "x.fvecs")
    with open(path, "wb") as f:
        for r in rows:
            f.write(np.int32(6).tobytes() + r.tobytes())
    np.testing.assert_array_equal(native.read_fvecs(path), rows)
    np.testing.assert_array_equal(native.read_fvecs(path, 4),
                                  ref_native.read_fvecs(path, 4))


# -- four clusters on the same docs -------------------------------------------

def _space(name: str) -> dict:
    return {
        "name": name, "partition_num": 2, "replica_num": 1,
        "fields": [
            {"name": "v", "data_type": "vector", "dimension": D,
             "index": {"index_type": "FLAT", "metric_type": "L2",
                       "params": {}}},
            {"name": "cat", "data_type": "integer",
             "scalar_index": "INVERTED"},
            {"name": "tag", "data_type": "string"},
        ],
    }


class _Cluster:
    """A master, two partition servers and a router, each from the
    package asked for; port servers run on the CPU."""

    def __init__(self, tmp, front: str, back: str):
        self.master = (RefMaster if front == "ref" else PortMaster)(
            heartbeat_ttl=3.0)
        self.ps = []
        self.router = None
        self.master.start()
        for i in range(2):
            kw = {"device": "cpu"} if back == "port" else {}
            ps = (RefPS if back == "ref" else PortPS)(
                data_dir=os.path.join(tmp, f"ps{i}"),
                master_addr=self.master.addr, heartbeat_interval=0.3,
                flush_interval=3600.0, **kw)
            ps.start()
            self.ps.append(ps)
        self.router = (RefRouter if front == "ref" else PortRouter)(
            master_addr=self.master.addr)
        self.router.start()
        self.client = VearchClient(self.router.addr)

    def stop(self):
        if self.router is not None:
            self.router.stop()
        for ps in self.ps:
            try:
                ps.stop(flush=False)
            except Exception:
                pass
        self.master.stop()


KINDS = {"ref": ("ref", "ref"), "port": ("port", "port"),
         "ref_front_port_ps": ("ref", "port"),
         "port_front_ref_ps": ("port", "ref")}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(42)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = (x[rng.choice(N, 16, replace=False)]
         + 0.3 * rng.standard_normal((16, D))).astype(np.float32)
    docs = [{"_id": f"d{i}", "v": x[i], "cat": int(i % 5),
             "tag": f"t{i % 3}"} for i in range(N)]
    return x, q, docs


@pytest.fixture(scope="module")
def clusters(tmp_path_factory, data):
    _x, _q, docs = data
    made = {}
    try:
        for kind, (front, back) in KINDS.items():
            c = _Cluster(str(tmp_path_factory.mktemp(kind)), front, back)
            made[kind] = c
            c.client.create_database("db")
            for name in ("s", "s_del"):
                c.client.create_space("db", _space(name))
                for i in range(0, N, 400):
                    c.client.upsert("db", name, docs[i:i + 400])
        yield made
    finally:
        for c in made.values():
            c.stop()


def _hits(out):
    ids = [[h["_id"] for h in row] for row in out]
    scores = [[h["_score"] for h in row] for row in out]
    return ids, scores


def _search(c, q, **kw):
    return _hits(c.client.search("db", kw.pop("space", "s"),
                                 [{"field": "v", "feature": q}], **kw))


def _assert_same(got, want):
    assert got[0] == want[0]
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


OTHERS = ["port", "ref_front_port_ps", "port_front_ref_ps"]


@pytest.mark.parametrize("kind", OTHERS)
def test_search_matches_reference_cluster(clusters, data, kind):
    _x, q, _docs = data
    want = _search(clusters["ref"], q, limit=10)
    assert all(len(r) == 10 for r in want[0])
    _assert_same(_search(clusters[kind], q, limit=10), want)


@pytest.mark.parametrize("kind", OTHERS)
def test_filtered_search_matches_reference_cluster(clusters, data, kind):
    _x, q, _docs = data
    flt = {"operator": "AND", "conditions": [
        {"field": "cat", "operator": "IN", "value": [1, 3]},
        {"field": "tag", "operator": "IN", "value": ["t0", "t2"]}]}
    want = _search(clusters["ref"], q, limit=10, filters=flt)
    got = _search(clusters[kind], q, limit=10, filters=flt)
    _assert_same(got, want)
    for row in got[0]:
        for key in row:
            i = int(key[1:])
            assert i % 5 in (1, 3) and i % 3 in (0, 2)


@pytest.mark.parametrize("kind", OTHERS)
def test_get_and_query_match_reference_cluster(clusters, kind):
    ids = ["d3", "d777", "nope", "d1199"]
    want = clusters["ref"].client.query("db", "s", document_ids=ids,
                                        vector_value=True)
    got = clusters[kind].client.query("db", "s", document_ids=ids,
                                      vector_value=True)
    assert [d["_id"] for d in got] == [d["_id"] for d in want]
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "v"} == \
            {k: v for k, v in w.items() if k != "v"}
        np.testing.assert_array_equal(np.asarray(g["v"], np.float32),
                                      np.asarray(w["v"], np.float32))
    flt = {"operator": "AND", "conditions": [
        {"field": "cat", "operator": "IN", "value": [2]}]}
    want = clusters["ref"].client.query("db", "s", filters=flt, limit=30,
                                        offset=5, fields=["cat", "tag"])
    got = clusters[kind].client.query("db", "s", filters=flt, limit=30,
                                      offset=5, fields=["cat", "tag"])
    assert got == want and len(got) == 30


@pytest.mark.parametrize("kind", OTHERS)
def test_delete_then_search_matches_reference_cluster(clusters, data, kind):
    x, q, _docs = data
    # the three nearest docs of the first four queries, the same set for
    # every cluster (the reference cluster deletes it once)
    d2 = ((q[:4, None, :] - x[None, :, :]) ** 2).sum(-1)
    gone = sorted({f"d{i}" for i in np.argsort(d2, axis=1)[:, :3].ravel()})
    results = {}
    for name in ("ref", kind):
        c = clusters[name].client
        if c.query("db", "s_del", document_ids=gone[:1]):
            assert c.delete("db", "s_del", document_ids=gone) == len(gone)
        results[name] = _search(clusters[name], q, limit=10, space="s_del",
                                cache=False)
    _assert_same(results[kind], results["ref"])
    assert not set(gone) & {k for row in results[kind][0] for k in row}


@pytest.mark.parametrize("kind", OTHERS)
def test_partition_doc_counts_match_reference_cluster(clusters, kind):
    def counts(c):
        parts = c.client.get_space("db", "s")["partitions"]
        out = {}
        for p in parts:
            for ps in c.ps:
                if p["id"] in ps.engines:
                    out[p["slot"]] = ps.engines[p["id"]].doc_count
        return out

    want = counts(clusters["ref"])
    assert sum(want.values()) == N and len(want) == 2
    assert counts(clusters[kind]) == want


# -- the device default -------------------------------------------------------

def test_ps_without_device_raises_without_gpu(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        PortPS(data_dir=str(tmp_path / "ps"))
    ps = PortPS(data_dir=str(tmp_path / "ps"), device="cpu")
    assert ps.device == torch.device("cpu")
    ps.server._httpd.server_close()  # never started: close its socket


def test_launcher_ps_without_device_raises_without_gpu(tmp_path):
    import subprocess
    import sys

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "vearch_tpu_torch", "--role", "ps",
         "--master-addr", "127.0.0.1:9", "--data-dir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA device" in out.stderr
    assert "Traceback" in out.stderr


@pytest.mark.parametrize("verb", ["doctor", "split", "rebalance"])
def test_launcher_operator_verbs_are_not_ported_yet(verb):
    from vearch_tpu_torch.__main__ import main

    with pytest.raises(NotImplementedError, match="item 9b"):
        main([verb])


def test_router_grpc_front_end_is_not_ported_yet():
    from vearch_tpu_torch.cluster.grpc_server import GrpcRouter

    with pytest.raises(NotImplementedError, match="item 9b"):
        GrpcRouter(None, host="127.0.0.1", port=0)
