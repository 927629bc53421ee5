"""The port's cluster plane (vearch_tpu_torch/cluster/, sdk/, utils/,
tools/lockcheck.py, native/) held against the reference's on the CPU.

- Source copies: every module of the cluster plane that touches no device
  is the reference's file with its imports rewritten (`vearch_tpu.` ->
  `vearch_tpu_torch.`); the tests hold each copy equal to the reference
  after the same rewrite, and the modules that change (ps.py, raft.py,
  wal.py, utils, standalone.py, __main__.py) equal to it after their
  stated edits.
  csrc/vearch_native.cpp is byte-equal, and the port's murmur3 slots are
  the reference's, so a doc lands in the same partition in both packages.
- Same docs, four clusters: a reference cluster, a port cluster, and two
  mixed ones (a reference master and router in front of port partition
  servers, and the reverse) serve the same seeded docs in a 2-partition
  FLAT L2 space. Search, a filtered search, get, query, delete and each
  partition's doc count must give the reference cluster's answer: ids
  equal, scores allclose at rtol 1e-5, atol 1e-3 (FLAT's products are
  exact in f32 in both packages; only the summation order differs).
- Lock order: concurrent upserts, searches and deletes through a port
  `StandaloneCluster` under VEARCH_LOCKCHECK=1 record no lockcheck
  violation, and every runtime acquisition edge is covered by the port
  lint's static lock-order graph, which has no cycle (the reference's
  anchor is tests/test_stress_concurrency.py).

Every port partition server runs on device="cpu".
"""

import os
import re
import threading

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


# raft.py's departure (and wal.py's part of it): an append RPC carries at
# most APPEND_MAX_BYTES of logged entries, where the reference sends up to
# 512 entries whatever their size (test_torch_cluster_raft.py shows why)
STATED_EDITS = {
    # master.py's departure: a replica added to a partition widens the
    # membership only once the leader runs it, and raises the promotion
    # watermark to the leader's log then, so a failover before the added
    # replica caught up cannot promote it past writes committed while it
    # was out of the group
    # (tests/test_torch_processes.py::test_readded_replica_is_not_promoted_past_acked_writes)
    "cluster/master.py": [
        ('''Route names mirror the reference so SDKs port over directly.
"""''', '''Route names mirror the reference so SDKs port over directly.

The port's copy of vearch_tpu/cluster/master.py, with one departure: a
replica added to a partition (a returning replica, an auto-recover
placement, a manual add) widens the membership only once the leader runs
it, and raises the partition's promotion watermark to the leader's log
at that point. The reference widens the membership it records even when
the leader never heard of it, and keeps the watermark of the last
promotion, so a failover before the added replica caught up could
promote it past writes committed while it was out of the group.
"""'''),
        ('''        at the previous reconfiguration, so each promotion also records
        that leader's (last_term, last_index) as `promoted_log` and a
        later promotion refuses any candidate behind it (see
        _reconfigure_partition). Below either threshold the partition
        stays unavailable (leaderless) rather than silently dropping
        acked data.''', '''        at the previous reconfiguration, so each promotion (and each
        widening, _add_replica) also records that leader's (last_term,
        last_index) as `promoted_log` and a later promotion refuses any
        candidate behind it (see _reconfigure_partition). Below either
        threshold the partition stays unavailable (leaderless) rather
        than silently dropping acked data.'''),
        ('''        p["replicas"] = members
        p["term"] = new_term
        ok = True
        for r in members:
            srv = servers.get(r)
            if srv is None:
                continue
            path = "/ps/raft/lead" if r == p["leader"] else "/ps/raft/members"
            try:
                rpc.call(srv.rpc_addr, "POST", path,
                         {"pid": p["id"], "term": new_term,
                          "members": members, "leader": p["leader"]})
            except RpcError:
                ok = ok and r != p["leader"]
''', '''        # the leader first: the widening stands only once the leader runs
        # it, and the leader's log then is the promotion watermark (same
        # contract as _reconfigure_partition): entries committed under the
        # narrower membership may live only there until the added replica
        # catches up, so a failover before then must not promote it
        decree = {"pid": p["id"], "term": new_term, "members": members,
                  "leader": p["leader"]}
        leader = servers.get(p["leader"])
        if leader is None:
            return False
        try:
            st = rpc.call(leader.rpc_addr, "POST", "/ps/raft/lead", decree)
        except RpcError:
            return False
        pos = [int(st["last_term"]), int(st["last_index"])]
        floor = p.get("promoted_log")
        if floor is None or pos > [int(floor[0]), int(floor[1])]:
            p["promoted_log"] = pos
        p["replicas"] = members
        p["term"] = new_term
        for r in members:
            srv = servers.get(r)
            if srv is None or r == p["leader"]:
                continue
            try:
                rpc.call(srv.rpc_addr, "POST", "/ps/raft/members", decree)
            except RpcError:
                pass
'''),
        ('''            self.store.put(f"{PREFIX_SERVER}{target.node_id}",
                           target.to_dict())
        return ok
''', '''            self.store.put(f"{PREFIX_SERVER}{target.node_id}",
                           target.to_dict())
        return True
'''),
    ],
    # ps.py's second and third departures (test_ps_differs_from_reference_
    # only_by_its_device applies these after the device edits): a
    # partition create waits until start() has reopened the partitions on
    # disk, so the master's re-add of a restarting replica cannot write an
    # empty engine over one of them (tests/test_torch_processes.py)
    "cluster/ps.py": [
        ("""        self._stop = threading.Event()
        # concurrency gate""", """        self._stop = threading.Event()
        # set once start() has reopened the partitions on disk
        self._recovered = threading.Event()
        # concurrency gate"""),
        ("""            self._recover_partitions()
        self.device_sampler.start()""", """            self._recover_partitions()
        self._recovered.set()
        self.device_sampler.start()"""),
        ("""    def _h_create_partition(self, body: dict, _parts) -> dict:
""", """    def _h_create_partition(self, body: dict, _parts) -> dict:
        if not self._recovered.is_set():
            # the partitions on this server's disk are not reopened yet:
            # a create now would dump an empty engine over one of them
            # (the master's re-add of a returning replica); the master
            # retries on its next pass
            raise RpcError(503, "partition server is still reopening its "
                                "partitions")
"""),
        # the third: a traced search's `stream_ms` ({device span: ms on
        # the CUDA stream}, which only the port records) is the profile's
        # own block, not a phase (docs/OBSERVABILITY.md)
        ("""        if k.endswith("_ms") and not k.startswith("dispatch_")
    }""", """        if k.endswith("_ms") and not k.startswith("dispatch_")
        and k != "stream_ms"
    }"""),
        ("""    if "mesh" in timing:
        out["mesh"] = timing["mesh"]
    return out""", """    if "mesh" in timing:
        out["mesh"] = timing["mesh"]
    if "stream_ms" in timing:
        out["stream_ms"] = timing["stream_ms"]
    return out"""),
        (" " * 31 + 'if k.endswith("_ms")},',
         " " * 31 + 'if k.endswith("_ms") and k != "stream_ms"},'),
    ],
    "cluster/raft.py": [
        ('''followers that fell behind the truncation horizon.
"""''', '''followers that fell behind the truncation horizon.

The port's copy of vearch_tpu/cluster/raft.py, with one departure: an
append carries at most APPEND_MAX_BYTES of logged entries (at least
one), where the reference sends up to 512 entries whatever their size.
A replica catching up a log of large writes otherwise gets it all in
one RPC that does not finish within the RPC timeout, and the leader
resends the same batch without end.
"""'''),
        ("SNAP_CHUNK = 4 << 20  # 4 MB per snapshot chunk (reference "
         "streams 10MB)\n",
         "SNAP_CHUNK = 4 << 20  # 4 MB per snapshot chunk (reference "
         "streams 10MB)\n"
         "# logged bytes per append RPC (at least one entry): a follower "
         "or learner\n"
         "# catching up from far behind gets the log in bounded batches, "
         "each well\n"
         "# inside the 30 s RPC timeout, as the snapshot stream is "
         "chunked\n"
         "APPEND_MAX_BYTES = 8 << 20\n"),
        ('''                entries = self.wal.entries_from(ni) if prev_term is not None \\
                    else []''', '''                entries = self.wal.entries_from(
                    ni, max_bytes=APPEND_MAX_BYTES) \\
                    if prev_term is not None else []'''),
    ],
    "cluster/wal.py": [
        ('''(tmp+rename atomic) records first_index / term / commit_index.
"""''', '''(tmp+rename atomic) records first_index / term / commit_index.

The port's copy of vearch_tpu/cluster/wal.py, with one departure for
raft.py's: the log keeps each entry's payload size, and `entries_from`
can bound a batch by those bytes.
"""'''),
        ('''        "_entries": "_lock",
''', '''        "_entries": "_lock",
        "_sizes": "_lock",
'''),
        ('''        self._entries: list[dict] = []
''', '''        self._entries: list[dict] = []
        # each entry's payload bytes as logged, in lockstep with
        # _entries: entries_from bounds a batch by them
        self._sizes: list[int] = []
'''),
        ('''                self._entries.append(json.loads(payload))
''', '''                self._entries.append(json.loads(payload))
                self._sizes.append(ln)
'''),
        ('''            self._entries.pop(0)
''', '''            self._entries.pop(0)
            self._sizes.pop(0)
'''),
        ('''    def entries_from(self, index: int, max_n: int = 512) -> list[dict]:
        with self._lock:
            i = max(0, index - self.first_index)
            return list(self._entries[i : i + max_n])
''', '''    def entries_from(self, index: int, max_n: int = 512,
                     max_bytes: int | None = None) -> list[dict]:
        """Up to max_n entries from `index`; with max_bytes, only as many
        as fit in that many logged payload bytes (at least one)."""
        with self._lock:
            i = max(0, index - self.first_index)
            out = self._entries[i : i + max_n]
            if max_bytes is not None:
                total = 0
                for j, size in enumerate(self._sizes[i : i + len(out)]):
                    total += size
                    if total > max_bytes and j > 0:
                        out = out[:j]
                        break
            return list(out)
'''),
        ('''            buf = bytearray()
            for e in entries:
''', '''            buf = bytearray()
            sizes = []
            for e in entries:
'''),
        ('''                buf += payload
''', '''                buf += payload
                sizes.append(len(payload))
'''),
        ('''            self._entries.extend(entries)
''', '''            self._entries.extend(entries)
            self._sizes.extend(sizes)
'''),
        ('''            self._entries = self._entries[:keep]
''', '''            self._entries = self._entries[:keep]
            self._sizes = self._sizes[:keep]
'''),
        ('''            self._entries = self._entries[drop:]
''', '''            self._entries = self._entries[drop:]
            self._sizes = self._sizes[drop:]
'''),
        ('''            self._entries = []
''', '''            self._entries = []
            self._sizes = []
'''),
    ],
}


@pytest.mark.parametrize("path", COPIES)
def test_copy_equals_reference_after_import_rewrite(path):
    """Each copy is the reference's file after the import rewrite and its
    STATED_EDITS (none for most)."""
    ref = rewrite_imports(_read("vearch_tpu", path))
    for old, new in STATED_EDITS.get(path, []):
        ref = _replace(ref, old, new)
    assert _read("vearch_tpu_torch", path) == ref


def test_ps_differs_from_reference_only_by_its_device():
    """ps.py's departures: an explicit device, resolved once, reaches the
    four engine sites (create, restart reopen, snapshot install,
    backup restore); the JAX platform env is gone; and STATED_EDITS'
    guard, which refuses a partition create until start() has reopened
    the partitions on disk."""
    ref = rewrite_imports(_read("vearch_tpu", "cluster", "ps.py"))
    ref = _replace(ref, '''truncates the log behind it (reference: store_raft_job.go:97,40).
"""''', '''truncates the log behind it (reference: store_raft_job.go:97,40).

The port's copy of vearch_tpu/cluster/ps.py: the same server over the
port's Engine, with two departures. `PSServer(device=None)` resolves the
device every engine of the server runs on once, at construction (the
card unless the caller asks for the CPU; no GPU and no device raises),
and passes it to each Engine and Engine.open. And a restarting server
refuses /ps/partition/create (503) until it has reopened the partitions
on its disk: the reference serves it from registration on, so the
master's re-add of the returning replica can write an empty engine over
a partition the server is still reopening, whose raft log then counts
as applied (seen on the card, where reopening takes seconds).
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
    for old, new in STATED_EDITS["cluster/ps.py"]:
        ref = _replace(ref, old, new)
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
def test_launcher_operator_verbs_are_not_ported_yet(verb, capsys):
    """The operator verbs are ported now (tests/test_torch_operator.py
    drives them against a port cluster): the launcher hands each to its
    own parser, as the reference's does."""
    from vearch_tpu_torch.__main__ import main

    with pytest.raises(SystemExit) as exc:
        main([verb, "--help"])
    assert exc.value.code == 0
    assert "usage:" in capsys.readouterr().out


# grpc_server.py's departure: without protoc, the message classes come
# from the descriptor set committed beside the module
# (tests/test_torch_operator.py holds it equal to protoc's)
GRPC_EDITS = [
    ('sha256 (same no-stale-binary discipline as vearch_tpu_torch/native)."""',
     '''sha256 (same no-stale-binary discipline as vearch_tpu_torch/native).

The port's departure: where protoc is missing, the message classes are
built from `vearch_proto.desc` beside this module, the descriptor set
protoc writes for api/vearch.proto (`protoc -Iapi
--descriptor_set_out=vearch_tpu_torch/cluster/vearch_proto.desc
api/vearch.proto`; tests/test_torch_operator.py holds it equal to
protoc's), so a router serves gRPC on a machine with grpcio and protobuf
but no protoc."""'''),
    ("import os\nimport subprocess\n",
     "import os\nimport shutil\nimport subprocess\n"),
    ('''    os.path.dirname(os.path.abspath(__file__)), ".proto_cache"
)
''', '''    os.path.dirname(os.path.abspath(__file__)), ".proto_cache"
)
_DESCRIPTOR_SET = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "vearch_proto.desc"
)
'''),
    ("        if stale:\n",
     '''        if stale and shutil.which("protoc") is None:
            _pb2_mod = pb2_from_descriptor_set()
            return _pb2_mod
        if stale:
'''),
    ("# RpcError HTTP codes -> canonical gRPC status codes\n",
     '''def pb2_from_descriptor_set(path: str = _DESCRIPTOR_SET):
    """A module holding api/vearch.proto's message classes, built from the
    descriptor set at `path` in a pool of its own (no protoc)."""
    import types

    from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

    with open(path, "rb") as f:
        fds = descriptor_pb2.FileDescriptorSet.FromString(f.read())
    pool = descriptor_pool.DescriptorPool()
    for fd in fds.file:
        pool.Add(fd)
    mod = types.ModuleType("vearch_pb2")
    mod.DESCRIPTOR = pool.FindFileByName("vearch.proto")
    for name, desc in mod.DESCRIPTOR.message_types_by_name.items():
        setattr(mod, name, message_factory.GetMessageClass(desc))
    return mod


# RpcError HTTP codes -> canonical gRPC status codes
'''),
]


def test_router_grpc_front_end_is_not_ported_yet():
    """The gRPC front end is ported now: the reference's module with its
    imports rewritten, the service keeping the proto's package name
    (`vearch_tpu.Router`, api/vearch.proto), so either package's clients
    reach either router (tests/test_torch_operator.py serves it), and
    GRPC_EDITS."""
    ref = rewrite_imports(_read("vearch_tpu", "cluster", "grpc_server.py"))
    ref = _replace(ref, '"vearch_tpu_torch.Router"', '"vearch_tpu.Router"')
    ref = _replace(ref, "discipline as vearch_tpu/native)",
                   "discipline as vearch_tpu_torch/native)")
    for old, new in GRPC_EDITS:
        ref = _replace(ref, old, new)
    assert _read("vearch_tpu_torch", "cluster", "grpc_server.py") == ref


# -- lock order ------------------------------------------------------------------


def test_cluster_stress_under_lockcheck_is_inside_the_static_graph(
        tmp_path, monkeypatch):
    """Writers, searchers and a deleter through a port StandaloneCluster
    with every cluster-plane lock a lockcheck DebugLock (the env is read
    when each lock is minted): no inversion, unguarded write or misuse,
    and no runtime edge outside `python -m vearch_tpu_torch.tools.lint
    --lock-graph`, whose graph has no cycle."""
    from vearch_tpu_torch.cluster.standalone import StandaloneCluster
    from vearch_tpu_torch.sdk.client import VearchClient as PortClient
    from vearch_tpu_torch.tools import lockcheck
    from vearch_tpu_torch.tools.lint import callgraph
    from vearch_tpu_torch.tools.lint.core import run_paths

    lockcheck.reset()
    monkeypatch.setenv("VEARCH_LOCKCHECK", "1")
    rng = np.random.default_rng(7)
    vecs = rng.standard_normal((400, D)).astype(np.float32)
    cluster = StandaloneCluster(
        data_dir=str(tmp_path), n_ps=2,
        ps_kwargs={"device": "cpu", "heartbeat_interval": 0.3,
                   "flush_interval": 3600.0})
    try:
        cluster.start()
        cl = PortClient(cluster.router_addr)
        cl.create_database("db")
        cl.create_space("db", dict(_space("s"), replica_num=2))
        cl.upsert("db", "s", [{"_id": f"seed{i}", "v": vecs[i],
                               "cat": i % 5, "tag": "t"}
                              for i in range(100)])
        errors: list[Exception] = []
        stop = threading.Event()

        def writer(tid):
            try:
                for b in range(4):
                    base = 100 + tid * 100 + b * 25
                    cl.upsert("db", "s", [
                        {"_id": f"w{tid}_{base + i}",
                         "v": vecs[(base + i) % 400], "cat": 1, "tag": "w"}
                        for i in range(25)])
            except Exception as e:
                errors.append(e)

        def searcher():
            try:
                while not stop.is_set():
                    out = cl.search("db", "s",
                                    [{"field": "v", "feature": vecs[:2]}],
                                    limit=3)
                    assert len(out) == 2
            except Exception as e:
                errors.append(e)

        def deleter():
            try:
                for i in range(0, 40, 4):
                    cl.delete("db", "s", document_ids=[
                        f"seed{j}" for j in range(i, i + 4)])
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=writer, args=(t,), daemon=True,
                                    name=f"stress-w{t}") for t in range(2)]
        threads += [threading.Thread(target=searcher, daemon=True,
                                     name=f"stress-s{i}") for i in range(2)]
        threads += [threading.Thread(target=deleter, daemon=True,
                                     name="stress-del")]
        for t in threads:
            t.start()
        for t in threads[:2] + threads[-1:]:
            t.join(timeout=180)
        stop.set()
        for t in threads[2:4]:
            t.join(timeout=60)
        assert not errors, errors
        out = cl.search("db", "s", [{"field": "v", "feature": vecs[:1]}],
                        limit=400)
        assert len(out[0]) == 100 - 40 + 2 * 100
        edges = lockcheck.acquisition_edges()
        assert edges, "no DebugLock edges recorded: lockcheck inert?"
        lockcheck.check()
    finally:
        cluster.stop()
        lockcheck.reset()
    run_paths([os.path.join(REPO, "vearch_tpu_torch")])
    graph = callgraph.LAST.lock_graph_artifact()
    assert graph["cycles"] == []
    uncovered = sorted((a, b) for (a, b) in edges
                       if not callgraph.edge_covered(graph, a, b))
    assert not uncovered, (
        "runtime acquisition edges missing from the static lock-order "
        f"graph: {uncovered}")
