"""The port's scalar indexes and filter planning against vearch_tpu's on
the CPU.

- The masks `evaluate_filter` gives through the port's manager (INVERTED
  on an int and a string field, BITMAP on an int and a string field, and
  the composite (tag, cat) for '=' prefixes with a range on the next
  member) are equal to the reference's masks and to the column scan of
  an engine without scalar indexes, over <, <=, =, !=, IN, NOT IN and
  AND/OR. Every document sets every field, so index and column agree.
- The online surface: `add_field_index` in the background while writes
  land, `remove_field_index`, `add_schema_field`, and an index built
  online surviving dump/open.
"""

import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from vearch_tpu.engine import types as rt  # noqa: E402
from vearch_tpu.engine.engine import Engine as RefEngine  # noqa: E402
from vearch_tpu.scalar.filter import evaluate_filter as ref_filter  # noqa: E402
from vearch_tpu.scalar.indexes import CompositeScalarIndex as RefComposite  # noqa: E402
from vearch_tpu_torch.engine import types as pt  # noqa: E402
from vearch_tpu_torch.engine.engine import Engine, SearchRequest  # noqa: E402
from vearch_tpu_torch.scalar import manager as port_manager  # noqa: E402
from vearch_tpu_torch.scalar.filter import evaluate_filter  # noqa: E402
from vearch_tpu_torch.scalar.indexes import CompositeScalarIndex  # noqa: E402

D, N = 8, 1500


def _schema(t, indexed=True):
    si = t.ScalarIndexType
    pick = (lambda x: x) if indexed else (lambda _x: si.NONE)
    return t.TableSchema("s", [
        t.FieldSchema("v", t.DataType.VECTOR, dimension=D,
                      index=t.IndexParams("FLAT", t.MetricType.L2, {})),
        t.FieldSchema("cat", t.DataType.INT, scalar_index=pick(si.INVERTED)),
        t.FieldSchema("tag", t.DataType.STRING, scalar_index=pick(si.BITMAP)),
        t.FieldSchema("level", t.DataType.INT, scalar_index=pick(si.BITMAP)),
        t.FieldSchema("city", t.DataType.STRING,
                      scalar_index=pick(si.INVERTED)),
        t.FieldSchema("price", t.DataType.FLOAT),
    ], composite_indexes=[["tag", "cat"]] if indexed else [])


def _docs(n=N, seed=3, lo=0):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, D)).astype(np.float32)
    return [{"_id": f"d{lo + i}", "v": vecs[i],
             "cat": int(rng.integers(0, 100)),
             "tag": f"t{int(rng.integers(0, 8))}",
             "level": int(rng.integers(0, 5)),
             "city": f"c{int(rng.integers(0, 12))}",
             "price": float(rng.random())} for i in range(n)]


@pytest.fixture(scope="module")
def engines():
    docs = _docs()
    ref = RefEngine(_schema(rt))
    port = Engine(_schema(pt), device="cpu")
    plain = Engine(_schema(pt, indexed=False), device="cpu")
    for e in (ref, port, plain):
        for lo in range(0, N, 500):
            e.upsert(docs[lo:lo + 500])
        e.delete([f"d{i}" for i in range(0, N, 37)])
    assert port._scalar_manager is not None and plain._scalar_manager is None
    return ref, port, plain


def _c(field, op, value):
    return {"field": field, "operator": op, "value": value}


def _and(*conds):
    return {"operator": "AND", "conditions": list(conds)}


def _or(*conds):
    return {"operator": "OR", "conditions": list(conds)}


FILTERS = {
    # INVERTED, int
    "cat_lt": _and(_c("cat", "<", 10)),
    "cat_le": _and(_c("cat", "<=", 10)),
    "cat_eq": _and(_c("cat", "=", 42)),
    "cat_ne": _and(_c("cat", "!=", 42)),
    "cat_in": _and(_c("cat", "IN", [1, 5, 99])),
    "cat_not_in": _and(_c("cat", "NOT IN", [1, 5, 99])),
    # INVERTED, string
    "city_eq": _and(_c("city", "=", "c3")),
    "city_ne": _and(_c("city", "!=", "c3")),
    "city_in": _and(_c("city", "IN", ["c1", "c11"])),
    "city_not_in": _and(_c("city", "NOT IN", ["c1", "c11"])),
    # BITMAP, int and string
    "level_lt": _and(_c("level", "<", 2)),
    "level_le": _and(_c("level", "<=", 2)),
    "level_eq": _and(_c("level", "=", 3)),
    "level_ne": _and(_c("level", "!=", 3)),
    "level_in": _and(_c("level", "IN", [0, 4])),
    "level_not_in": _and(_c("level", "NOT IN", [0, 4])),
    "tag_eq": _and(_c("tag", "=", "t3")),
    "tag_ne": _and(_c("tag", "!=", "t3")),
    "tag_in": _and(_c("tag", "IN", ["t0", "t7"])),
    "tag_not_in": _and(_c("tag", "NOT IN", ["t0", "t7"])),
    # the composite (tag, cat): an '=' prefix, then a range or '='
    "comp_eq_lt": _and(_c("tag", "=", "t3"), _c("cat", "<", 10)),
    "comp_eq_le": _and(_c("tag", "=", "t3"), _c("cat", "<=", 10)),
    "comp_eq_eq": _and(_c("tag", "=", "t5"), _c("cat", "=", 7)),
    "comp_eq_ge_rest": _and(_c("tag", "=", "t1"), _c("cat", ">=", 50),
                            _c("level", "!=", 0)),
    "comp_prefix_only": _and(_c("tag", "=", "t2"), _c("price", "<", 0.5)),
    # mixed AND / OR over indexed and unindexed fields
    "or_mixed": _or(_c("cat", "<", 5), _c("tag", "=", "t4"),
                    _c("price", ">", 0.9)),
    "and_mixed": _and(_c("cat", ">", 20), _c("level", "IN", [1, 2]),
                      _c("city", "!=", "c0")),
}


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_masks_equal_reference_and_column_scan(engines, name):
    ref, port, plain = engines
    flt = FILTERS[name]
    n = port.table.doc_count
    got = evaluate_filter(flt, port, n)
    want = ref_filter(flt, ref, n)
    scan = evaluate_filter(flt, plain, n)
    assert got.dtype == want.dtype == scan.dtype == np.bool_
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == scan.tobytes()
    # and through the engine's cached alive-and-filter mask
    assert port._filtered_mask(flt, n).tobytes() == \
        ref._filtered_mask(flt, n).tobytes()


def test_composite_prefix_lookups_equal_reference():
    rng = np.random.default_rng(9)
    rows = [(f"t{int(rng.integers(0, 4))}", int(rng.integers(0, 20)),
             int(rng.integers(0, 3))) for _ in range(400)]
    mine = CompositeScalarIndex(["tag", "cat", "level"])
    theirs = RefComposite(["tag", "cat", "level"])
    for docid, vals in enumerate(rows):
        mine.add(vals, docid)
        theirs.add(vals, docid)
    from vearch_tpu.scalar.filter import Condition as RefCondition
    from vearch_tpu_torch.scalar.filter import Condition

    for eq, rc in [(("t1",), None), (("t2",), ("cat", "<", 9)),
                   (("t0", 4), None), (("t3", 11), ("level", ">", 0)),
                   (("t1", 3, 2), None), ((), ("tag", ">=", "t2")),
                   (("t9",), None), ((7,), None)]:
        got = mine.query_prefix(eq, Condition(*rc) if rc else None, 450)
        want = theirs.query_prefix(eq, RefCondition(*rc) if rc else None,
                                   450)
        assert got.tobytes() == want.tobytes(), (eq, rc)


def test_scalar_indexes_no_longer_refused():
    schema = _schema(pt)
    eng = Engine(schema, device="cpu")
    assert isinstance(eng._scalar_manager, port_manager.ScalarIndexManager)
    assert eng._scalar_manager.has_index("cat")
    assert [c.fields for c in eng._scalar_manager.composites()] == \
        [["tag", "cat"]]


def _flat_schema():
    return pt.TableSchema("o", [
        pt.FieldSchema("v", pt.DataType.VECTOR, dimension=D,
                       index=pt.IndexParams("FLAT", pt.MetricType.L2, {})),
        pt.FieldSchema("cat", pt.DataType.INT),
        pt.FieldSchema("tag", pt.DataType.STRING),
    ])


def _column_mask(eng, flt):
    """The same filter evaluated by column scan alone."""
    mgr, eng._scalar_manager = eng._scalar_manager, None
    try:
        return evaluate_filter(flt, eng, eng.table.doc_count)
    finally:
        eng._scalar_manager = mgr


def test_online_field_index_while_writes_land(tmp_path):
    eng = Engine(_flat_schema(), device="cpu")
    docs = _docs(3000)
    eng.upsert([{k: d[k] for k in ("_id", "v", "cat", "tag")}
                for d in docs[:1000]])
    stop = threading.Event()
    errors = []

    def writer():
        try:
            lo = 1000
            while lo < 3000:
                eng.upsert([{k: d[k] for k in ("_id", "v", "cat", "tag")}
                            for d in docs[lo:lo + 100]])
                lo += 100
        except Exception as e:  # pragma: no cover
            errors.append(e)
        finally:
            stop.set()

    t = threading.Thread(target=writer, name="online-writer")
    t.start()
    eng.add_field_index("cat", "INVERTED", background=True)
    eng.add_field_index("tag", "BITMAP", background=False)
    t.join()
    assert not errors
    # a synchronous build of the same type joins or rebuilds: live after
    eng.add_field_index("cat", "INVERTED", background=False)
    assert eng._scalar_manager.has_index("cat")
    assert eng._scalar_manager.has_index("tag")
    assert eng.schema.field("cat").scalar_index is pt.ScalarIndexType.INVERTED
    flt = _and(_c("cat", "<", 30), _c("tag", "IN", ["t1", "t6"]))
    n = eng.table.doc_count
    assert n == 3000
    assert evaluate_filter(flt, eng, n).tobytes() == \
        _column_mask(eng, flt).tobytes()
    # the online index survives dump/open (the schema carries its flag)
    eng.dump(str(tmp_path / "e"))
    again = Engine.open(str(tmp_path / "e"), device="cpu")
    assert again._scalar_manager.has_index("cat")
    assert again._scalar_manager.has_index("tag")
    assert evaluate_filter(flt, again, n).tobytes() == \
        _column_mask(eng, flt).tobytes()
    # removing falls back to the column scan with the same mask
    v0 = again.data_version
    again.remove_field_index("cat")
    assert not again._scalar_manager.has_index("cat")
    assert again.data_version == v0 + 1
    assert again.schema.field("cat").scalar_index is pt.ScalarIndexType.NONE
    assert evaluate_filter(flt, again, n).tobytes() == \
        _column_mask(eng, flt).tobytes()


def test_add_schema_field_with_index():
    eng = Engine(_flat_schema(), device="cpu")
    docs = _docs(400)
    eng.upsert([{k: d[k] for k in ("_id", "v", "cat", "tag")}
                for d in docs[:200]])
    eng.add_schema_field(pt.FieldSchema(
        "level", pt.DataType.INT, scalar_index=pt.ScalarIndexType.BITMAP))
    eng.add_schema_field(pt.FieldSchema("level", pt.DataType.INT))  # no-op
    with pytest.raises(ValueError):
        eng.add_schema_field(pt.FieldSchema("w", pt.DataType.VECTOR,
                                            dimension=4))
    eng.upsert([{k: d[k] for k in ("_id", "v", "cat", "tag", "level")}
                for d in docs[200:]])
    # publishes in the background; a synchronous call joins it
    eng.add_field_index("level", "BITMAP", background=False)
    assert eng.schema.field("level").scalar_index is \
        pt.ScalarIndexType.BITMAP
    flt = _and(_c("level", "=", 2))
    got = evaluate_filter(flt, eng, eng.table.doc_count)
    # rows before the field existed never set it: no match there
    assert not got[:200].any()
    want = np.array([d["level"] == 2 for d in docs[200:]])
    np.testing.assert_array_equal(got[200:], want)
    # a filtered search serves through the new index
    res = eng.search(SearchRequest(vectors={"v": docs[250]["v"]}, k=5,
                                   filters=flt, include_fields=["level"]))
    assert res[0].items and all(it.fields["level"] == 2
                                for it in res[0].items)
    eng.add_field_index("level", "NONE")  # NONE removes
    assert not eng._scalar_manager.has_index("level")
