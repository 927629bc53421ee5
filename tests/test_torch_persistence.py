"""The port's segmented dump/open against vearch_tpu's on the CPU.

- For the same upserts, updates (partial ones included) and deletes, the
  two packages write the same dump: schema.json, MANIFEST.json,
  engine.json, bitmap.npy, each segment's table.json and vectors_*.npy
  byte for byte, each segment's table.npz arrays equal, and
  index_emb.npz's arrays equal once the port holds the reference's
  trained state. A bf16 store dumps its rows as f32 on both sides.
- A dump either package wrote opens in the other and serves the ids the
  writer served (IVFPQ full scan, IVFFLAT probe, SCANN, HNSW graph mode;
  ties aside, as in tests/test_torch_index_family.py).
- A reopened port engine reads back what it wrote: status, `get`,
  `query`, updates and deletes, search ids.
- The cases of tests/test_segmented_persistence.py on the port: a
  second flush writes one new segment, a no-op flush none, small
  flushes compact, and a smaller state rewinds the tail.
- The legacy flat layout (no MANIFEST.json) opens in both packages.
"""

import io
import json
import os
import zipfile

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from vearch_tpu.engine import types as rt  # noqa: E402
from vearch_tpu.engine.engine import Engine as RefEngine  # noqa: E402
from vearch_tpu.engine.engine import SearchRequest as RefRequest  # noqa: E402
from vearch_tpu_torch.convert import index_state_from_reference  # noqa: E402
from vearch_tpu_torch.engine import types as pt  # noqa: E402
from vearch_tpu_torch.engine.engine import Engine, SearchRequest  # noqa: E402

D, N = 32, 2048
BASE = {"ncentroids": 16, "nsubvector": 8, "train_iters": 3,
        "training_threshold": 10 ** 9, "nprobe": 6, "mesh_serving": "off"}
TIE_RTOL, TIE_ATOL = 1e-6, 1e-4


def _schema(t, index_type="IVFPQ", metric="L2", extra=None,
            scalar_indexes=True):
    si = t.ScalarIndexType
    return t.TableSchema("p", [
        t.FieldSchema("emb", t.DataType.VECTOR, dimension=D,
                      index=t.IndexParams(index_type, t.MetricType(metric),
                                          dict(BASE, **(extra or {})))),
        t.FieldSchema("cat", t.DataType.INT,
                      scalar_index=si.INVERTED if scalar_indexes
                      else si.NONE),
        t.FieldSchema("tag", t.DataType.STRING,
                      scalar_index=si.BITMAP if scalar_indexes else si.NONE),
        t.FieldSchema("price", t.DataType.FLOAT),
    ], composite_indexes=[["tag", "cat"]] if scalar_indexes else [])


def _docs(seed=5, n=N):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((30, D)).astype(np.float32) * 2
    vecs = (centers[rng.integers(0, 30, n)]
            + 0.6 * rng.standard_normal((n, D))).astype(np.float32)
    docs = [{"_id": f"d{i:05d}", "emb": vecs[i], "cat": int(i % 100),
             "tag": f"t{i % 8}", "price": float(rng.random())}
            for i in range(n)]
    queries = vecs[rng.choice(n, 8, replace=False)] + 0.05
    return docs, queries.astype(np.float32)


def _writes(engine, docs):
    """Upserts in batches, updates (a full one and a scalar-only partial
    one) and deletes, in the same order on either package."""
    for lo in range(0, len(docs), 512):
        engine.upsert(docs[lo:lo + 512])
    engine.upsert([dict(docs[i], cat=1000 + i) for i in range(0, 64, 2)])
    engine.upsert([{"_id": docs[i]["_id"], "tag": "upd"}
                   for i in range(1, 64, 2)])
    engine.delete([docs[i]["_id"] for i in range(100, 300, 7)])


def _pair(index_type="IVFPQ", metric="L2", extra=None):
    """A reference engine that trained, and a port engine that holds its
    state, after the same writes."""
    docs, queries = _docs()
    ref = RefEngine(_schema(rt, index_type, metric, extra))
    ref.micro_batch = False
    port = Engine(_schema(pt, index_type, metric, extra), device="cpu")
    _writes(ref, docs)
    _writes(port, docs)
    ref.build_index()
    port.indexes["emb"].load_state(
        index_state_from_reference(ref.indexes["emb"].dump_state()))
    port.build_index()  # trained: absorbs nothing, marks INDEXED
    return ref, port, queries


def _files(root):
    out = {}
    for dp, _dirs, names in os.walk(root):
        for nm in names:
            p = os.path.join(dp, nm)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _npz(blob):
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("store_dtype", ["float32", "bfloat16"])
def test_dump_is_byte_equal_to_reference(tmp_path, store_dtype):
    ref, port, _q = _pair(extra={"store_dtype": store_dtype})
    ref.dump(str(tmp_path / "ref"))
    port.dump(str(tmp_path / "port"))
    rf, pf = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(pf) == sorted(rf)
    assert any(p.endswith("vectors_emb.npy") for p in pf)
    for name in sorted(rf):
        if name.endswith(".npz"):
            want, got = _npz(rf[name]), _npz(pf[name])
            assert sorted(got) == sorted(want), name
            for k in want:
                assert got[k].dtype == want[k].dtype, (name, k)
                np.testing.assert_array_equal(got[k], want[k])
            assert zipfile.ZipFile(io.BytesIO(pf[name])).namelist() == \
                zipfile.ZipFile(io.BytesIO(rf[name])).namelist()
        else:
            assert pf[name] == rf[name], name
    vec = [p for p in pf if p.endswith("vectors_emb.npy")][0]
    assert np.load(io.BytesIO(pf[vec]), allow_pickle=False).dtype == \
        np.float32
    man = json.loads(pf["MANIFEST.json"])
    assert man["format"] == 2 and man["doc_count"] == port.table.doc_count


def _tied(a, b):
    return abs(a - b) <= TIE_ATOL + TIE_RTOL * abs(b)


def _same(want_res, got_res):
    """Keys equal in order except where a score tie explains a swap;
    scores allclose."""
    wk = [[it.key for it in r.items] for r in want_res]
    ws = [[it.score for it in r.items] for r in want_res]
    gk = [[it.key for it in r.items] for r in got_res]
    gs = [[it.score for it in r.items] for r in got_res]
    assert [len(r) for r in gk] == [len(r) for r in wk]
    for wkeys, wsc, gkeys, gsc in zip(wk, ws, gk, gs):
        np.testing.assert_allclose(gsc, wsc, rtol=1e-5, atol=1e-3)
        where = {k: j for j, k in enumerate(wkeys)}
        for i, (a, b) in enumerate(zip(wkeys, gkeys)):
            if a != b:
                j = where.get(b)
                assert _tied(gsc[i], wsc[i]), (a, b)
                assert (_tied(wsc[j], wsc[i]) if j is not None
                        else _tied(gsc[i], wsc[-1])), (a, b)
    return gk


FILTER = {"operator": "AND", "conditions": [
    {"field": "tag", "operator": "IN", "value": ["t1", "t2", "upd"]},
    {"field": "cat", "operator": "<", "value": 60}]}


def _searches(engine, cls, queries, params):
    return [engine._search_direct(cls(vectors={"emb": queries}, k=10,
                                      index_params=params, **kw))
            for kw in ({}, {"filters": FILTER, "include_fields": ["cat"]})]


CROSS = [
    ("IVFPQ", "L2", None, {}),
    ("IVFFLAT", "L2", None, {"nprobe": 6}),
    ("SCANN", "InnerProduct", None, {}),
    ("HNSW", "L2", {"graph": True, "nlinks": 12, "efConstruction": 64,
                    "efSearch": 48}, {}),
]


@pytest.mark.parametrize("index_type,metric,extra,params", CROSS,
                         ids=[c[0] for c in CROSS])
def test_dumps_open_across_packages(tmp_path, index_type, metric, extra,
                                    params):
    ref, port, queries = _pair(index_type, metric, extra)
    want = _searches(ref, RefRequest, queries, params)
    for a, b in zip(want, _searches(port, SearchRequest, queries, params)):
        _same(a, b)
    # the reference's dump, opened by the port
    ref.dump(str(tmp_path / "ref"))
    opened = Engine.open(str(tmp_path / "ref"), device="cpu")
    opened.build_index()
    assert opened.doc_count == ref.doc_count
    for a, b in zip(want, _searches(opened, SearchRequest, queries, params)):
        _same(a, b)
    # the port's dump, opened by the reference
    port.dump(str(tmp_path / "port"))
    back = RefEngine.open(str(tmp_path / "port"))
    back.micro_batch = False
    back.build_index()
    assert back.doc_count == port.doc_count
    for a, b in zip(want, _searches(back, RefRequest, queries, params)):
        _same(a, b)


def test_open_restores_reads_and_status(tmp_path):
    _ref, port, queries = _pair()
    port.dump(str(tmp_path / "e"))
    again = Engine.open(str(tmp_path / "e"), device="cpu")
    assert again.status == port.status == pt.IndexStatus.INDEXED
    assert again.data_dir == str(tmp_path / "e")
    keys = [f"d{i:05d}" for i in range(0, 400, 3)]
    assert again.get(keys) == port.get(keys)
    assert again.query(FILTER, limit=40, offset=5) == \
        port.query(FILTER, limit=40, offset=5)
    # the updated document resolves to its new row, its partial update
    # kept the carried-forward fields
    assert again.get(["d00001"])[0]["tag"] == "upd"
    assert again.get(["d00002"])[0]["cat"] == 1002
    assert again.get(["d00107"]) == []  # deleted
    for a, b in zip(_searches(port, SearchRequest, queries, {}),
                    _searches(again, SearchRequest, queries, {})):
        assert [[it.key for it in r.items] for r in a] == \
            [[it.key for it in r.items] for r in b]


# -- the segmented format (tests/test_segmented_persistence.py's cases) ---------

def _flat_engine(data_dir):
    schema = pt.TableSchema("seg", [
        pt.FieldSchema("v", pt.DataType.VECTOR, dimension=8,
                       index=pt.IndexParams("FLAT", pt.MetricType.L2, {})),
        pt.FieldSchema("price", pt.DataType.INT),
        pt.FieldSchema("tag", pt.DataType.STRING),
    ])
    return Engine(schema, device="cpu", data_dir=data_dir)


def _fill(eng, lo, hi, rng, tag="a"):
    vecs = rng.standard_normal((hi - lo, 8)).astype(np.float32)
    eng.upsert([{"_id": f"d{i}", "v": vecs[i - lo], "price": i, "tag": tag}
                for i in range(lo, hi)])


def _seg_files(dirpath):
    """{relpath: mtime_ns} of every file under segments/."""
    out = {}
    root = os.path.join(dirpath, "segments")
    for dp, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dp, f)
            out[os.path.relpath(p, root)] = os.stat(p).st_mtime_ns
    return out


def _manifest(d):
    with open(os.path.join(d, "MANIFEST.json")) as f:
        return json.load(f)


def _second_flush(d, rng):
    eng = _flat_engine(d)
    _fill(eng, 0, 1000, rng)
    eng.build_index()
    eng.dump()
    before = _seg_files(d)
    assert len({os.path.dirname(p) for p in before}) == 1
    _fill(eng, 1000, 1100, rng, tag="b")
    eng.dump()
    after = _seg_files(d)
    for p, mt in before.items():  # sealed files untouched
        assert after[p] == mt, f"sealed segment file rewritten: {p}"
    assert len({os.path.dirname(p) for p in after}) == 2
    m = _manifest(d)
    assert [s["start"] for s in m["segments"]] == [0, 1000]
    assert m["doc_count"] == 1100
    eng2 = Engine.open(d, device="cpu")
    assert eng2.doc_count == 1100
    assert eng2.get(["d1050"])[0]["tag"] == "b"


def _noop_flush(d, rng):
    eng = _flat_engine(d)
    _fill(eng, 0, 300, rng)
    eng.dump()
    n1 = len(_manifest(d)["segments"])
    eng.dump()  # nothing new
    assert len(_manifest(d)["segments"]) == n1


def _compaction(d, rng):
    eng = _flat_engine(d)
    eng.SEGMENT_TARGET_ROWS = 200  # instance override for the test
    lo = 0
    for _ in range(30):  # 30 small flushes of 50 rows
        _fill(eng, lo, lo + 50, rng)
        lo += 50
        eng.dump()
    segs = _manifest(d)["segments"]
    assert len(segs) <= eng.MAX_SMALL_SEGMENTS + 2, segs
    eng2 = Engine.open(d, device="cpu")
    assert eng2.doc_count == lo
    assert eng2.get(["d1234"])[0]["price"] == 1234


def _rewind(d, rng):
    a = _flat_engine(d)
    _fill(a, 0, 400, rng)
    a.dump()
    b = _flat_engine(d)
    _fill(b, 0, 150, rng, tag="rewound")
    b.dump()
    m = _manifest(d)
    assert m["doc_count"] == 150
    assert all(s["end"] <= 150 for s in m["segments"])
    eng2 = Engine.open(d, device="cpu")
    assert eng2.doc_count == 150
    assert eng2.get(["d260"]) == []
    assert eng2.get(["d100"])[0]["tag"] == "rewound"


@pytest.mark.parametrize("case", [_second_flush, _noop_flush, _compaction,
                                  _rewind],
                         ids=["second_flush", "noop_flush", "compaction",
                              "rewind"])
def test_segmented_flushes(tmp_path, rng, case):
    case(str(tmp_path / "e"), rng)


def test_legacy_flat_dump_opens_in_both_packages(tmp_path):
    """The pre-segment layout (table/, bitmap.npy, vectors_<field>.npy,
    schema.json, engine.json, no MANIFEST.json) written by the port's
    table, bitmap and store dumps opens in the port and the reference
    with the same documents."""
    d = tmp_path / "flat"
    eng = _flat_engine(None)
    rng = np.random.default_rng(3)
    _fill(eng, 0, 300, rng)
    eng.upsert([{"_id": "d5", "price": -5}])  # a partial update
    eng.delete(["d7", "d8"])
    eng.bitmap.set_deleted(299)  # deleted, then restored
    eng.bitmap.unset(299)
    assert not eng.bitmap.is_deleted(299) and eng.bitmap.is_deleted(7)
    d.mkdir()
    eng.table.dump(str(d / "table"))
    eng.bitmap.dump(str(d / "bitmap.npy"))
    eng.vector_stores["v"].dump(str(d / "vectors_v.npy"))
    (d / "schema.json").write_text(json.dumps(eng.schema.to_dict()))
    (d / "engine.json").write_text(json.dumps({"status": int(eng.status)}))
    mine = Engine.open(str(d), device="cpu")
    theirs = RefEngine.open(str(d))
    theirs.micro_batch = False
    keys = [f"d{i}" for i in range(0, 300, 3)] + ["d5", "d7"]
    assert mine.get(keys) == eng.get(keys) == theirs.get(keys)
    assert mine.doc_count == theirs.doc_count == 298
    assert sorted(mine.table.iter_alive()) == sorted(eng.table.iter_alive())
    q = eng.vector_stores["v"].host_view()[[10, 20]]
    got = mine._search_direct(SearchRequest(vectors={"v": q}, k=5))
    want = theirs._search_direct(RefRequest(vectors={"v": q}, k=5))
    assert [[it.key for it in r.items] for r in got] == \
        [[it.key for it in r.items] for r in want]
