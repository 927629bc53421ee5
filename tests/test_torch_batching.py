"""The port's continuous-batching scheduler (engine/batching.py) on the
CPU: its bucket keys equal vearch_tpu's for the same requests, and the
cases of tests/test_batching.py hold on the port: batched results equal
direct ones bit for bit (mixed k, sorted and score-bounded traffic),
mixed k trimmed per caller, a poison request and a killed sub-request
isolated, a failing group retried one request at a time, filtered
requests bypassing the scheduler, the age bound, drain on close, and no
re-enabling after `close`."""

import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from vearch_tpu.engine.batching import _compat_key as ref_key  # noqa: E402
from vearch_tpu.engine.engine import SearchRequest as RefRequest  # noqa: E402
from vearch_tpu_torch.engine.batching import (  # noqa: E402
    BatchScheduler, _Bucket, _compat_key, _Pending,
)
from vearch_tpu_torch.engine.engine import (  # noqa: E402
    Engine, RequestContext, RequestKilled, SearchRequest,
)
from vearch_tpu_torch.engine.types import (  # noqa: E402
    DataType, FieldSchema, IndexParams, MetricType, TableSchema,
)

D, N = 16, 3000
SCORE_ASC = [{"field": "_score", "desc": False, "missing_first": False}]


def _flat_schema(name="m", extra_fields=()):
    return TableSchema(name, [
        *extra_fields,
        FieldSchema("v", DataType.VECTOR, dimension=D,
                    index=IndexParams("FLAT", MetricType.L2, {})),
    ])


@pytest.fixture(scope="module")
def engine_and_data():
    rng = np.random.default_rng(2)
    base = rng.standard_normal((N, D)).astype(np.float32)
    eng = Engine(_flat_schema(), device="cpu")
    eng.upsert([{"_id": str(i), "v": base[i]} for i in range(N)])
    eng.build_index()
    yield eng, base
    eng.close()


def _bucket_of(pendings):
    b = _Bucket("t")
    for p in pendings:
        b.pendings.append(p)
        b.rows += p.rows
    return b


KEY_CASES = [
    dict(k=5), dict(k=9), dict(k=20), dict(k=5, index_params={"nprobe": 4}),
    dict(k=5, index_params={"r0": 2048, "r1": 256}),
    dict(k=5, index_params={"stage0": "off"}),
    dict(k=5, sort=SCORE_ASC), dict(k=9, sort=SCORE_ASC),
    dict(k=5, score_bounds={"v": (None, 1.0)}),
    dict(k=10, include_fields=["b", "a"]), dict(k=10, include_fields=[]),
    dict(k=10, field_weights={"v": 0.5}),
]


@pytest.mark.parametrize("tiered", [True, False])
def test_compat_key_equals_reference(tiered):
    for kw in KEY_CASES:
        q = np.zeros((1, D), np.float32)
        assert _compat_key(SearchRequest(vectors={"v": q}, **kw), tiered) \
            == ref_key(RefRequest(vectors={"v": q}, **kw), tiered), kw
    two = {"v": np.zeros((1, D)), "w": np.zeros((1, D))}
    assert _compat_key(SearchRequest(vectors=two, k=7)) == \
        ref_key(RefRequest(vectors=two, k=7))


def test_compat_key_mixes_k_within_tier():
    a = SearchRequest(vectors={"v": np.zeros((1, D))}, k=5)
    b = SearchRequest(vectors={"v": np.zeros((1, D))}, k=9)
    big = SearchRequest(vectors={"v": np.zeros((1, D))}, k=20)
    c = SearchRequest(vectors={"v": np.zeros((1, D))}, k=5,
                      index_params={"nprobe": 4})
    assert _compat_key(a) == _compat_key(b)  # both in the k<=16 tier
    assert _compat_key(a) != _compat_key(big)  # tier 16 vs tier 64
    assert _compat_key(a) != _compat_key(c)  # params split buckets
    assert _compat_key(a, tiered=False) != _compat_key(b, tiered=False)


def test_dispatcher_survives_poison_request(engine_and_data):
    eng, base = engine_and_data

    class Unprintable:
        def __str__(self):
            raise RuntimeError("boom")

    mb = BatchScheduler(eng, max_rows=64)
    try:
        bad = SearchRequest(vectors={"v": base[0]}, k=2, include_fields=[],
                            index_params={"poison": Unprintable()})
        with pytest.raises(Exception):
            mb.submit(bad)
        good = mb.submit(SearchRequest(vectors={"v": base[4]}, k=2,
                                       include_fields=[]))
        assert good[0].items[0].key == "4"
    finally:
        mb.stop()


def test_bucket_seals_at_capacity_and_drains_on_close(engine_and_data):
    eng, base = engine_and_data
    # huge age bound: only full buckets dispatch during the test
    mb = BatchScheduler(eng, max_rows=4, max_delay_ms=3_600_000.0)
    done, errs = [], []

    def worker(i):
        try:
            done.append(mb.submit(SearchRequest(
                vectors={"v": np.stack([base[i], base[i + 1]])}, k=2,
                include_fields=[])))
        except Exception as e:
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,), daemon=True,
                                name=f"batch-cap-{i}") for i in range(3)]
    for t in threads:
        t.start()
    for _ in range(200):
        if len(done) >= 2:
            break
        threading.Event().wait(0.05)
    assert len(done) == 2 and not errs
    st = mb.stats()
    assert st["full_dispatches"] >= 1
    assert st["open_buckets"] == 1 and st["open_rows"] == 2
    mb.stop()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(errs) == 1 and "engine closed" in str(errs[0])
    mb._thread.join(timeout=30)
    assert not mb._thread.is_alive()


def _items(res):
    return [(it.key, it.score, it.fields, it.sort_values)
            for r in res for it in r.items]


def test_batched_results_equal_direct_bit_for_bit(engine_and_data):
    eng, base = engine_and_data
    rng = np.random.default_rng(7)
    reqs = []
    for i in range(40):
        q = base[i] + 0.01 * rng.standard_normal(D).astype(np.float32)
        kw = {}
        if i % 7 == 3:
            kw["sort"] = SCORE_ASC
        elif i % 7 == 5:
            kw["score_bounds"] = {"v": (None, 5.0)}
        rows = q if i % 3 else np.stack([q, base[i + 100]])
        reqs.append(SearchRequest(vectors={"v": rows}, k=(3, 5, 10, 20)[i % 4],
                                  include_fields=[], **kw))
    direct = [eng._search_direct(r) for r in reqs]
    out, errs = [None] * len(reqs), []
    gate = threading.Barrier(len(reqs))

    def worker(i):
        try:
            gate.wait()
            out[i] = eng.search(reqs[i])
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    for i in range(len(reqs)):
        assert _items(out[i]) == _items(direct[i]), i
    mb = eng._microbatcher
    assert mb is not None and mb.batched_requests >= 2, mb.stats()


def test_mixed_k_trimmed_per_caller(engine_and_data):
    eng, base = engine_and_data
    r3 = SearchRequest(vectors={"v": base[5]}, k=3, include_fields=[])
    r7 = SearchRequest(vectors={"v": base[6]}, k=7, include_fields=[])
    mb = BatchScheduler(eng, max_rows=64)
    try:
        p3, p7 = _Pending(r3, 1), _Pending(r7, 1)
        mb._run_bucket(_bucket_of([p3, p7]))
        assert p3.error is None and p7.error is None
        assert len(p3.results[0].items) == 3
        assert len(p7.results[0].items) == 7
        assert p3.results[0].items[0].key == "5"
        assert p7.results[0].items[0].key == "6"
    finally:
        mb.stop()


def test_killed_subrequest_aborts_alone(engine_and_data):
    eng, base = engine_and_data
    ctx = RequestContext("r1")
    ctx.kill("test kill")
    rk = SearchRequest(vectors={"v": base[1]}, k=3, include_fields=[],
                       ctx=ctx)
    ro = SearchRequest(vectors={"v": base[2]}, k=3, include_fields=[])
    mb = BatchScheduler(eng, max_rows=64)
    try:
        pk, po = _Pending(rk, 1), _Pending(ro, 1)
        mb._run_bucket(_bucket_of([pk, po]))
        assert isinstance(pk.error, RequestKilled)
        assert po.error is None
        assert po.results[0].items[0].key == "2"
        # alone, the killed request aborts at its first phase boundary
        with pytest.raises(RequestKilled):
            eng._search_direct(rk)
    finally:
        mb.stop()


def test_deadline_kills_at_a_phase_boundary(engine_and_data):
    eng, base = engine_and_data
    ctx = RequestContext("late", deadline=0.0)  # long past
    with pytest.raises(RequestKilled):
        eng.search(SearchRequest(vectors={"v": base[1]}, k=3,
                                 include_fields=[], ctx=ctx))
    assert ctx.reason_code == "deadline"


def test_trace_records_phases_through_the_scheduler(engine_and_data):
    eng, base = engine_and_data
    trace = {}
    res = eng.search(SearchRequest(vectors={"v": base[8]}, k=3,
                                   include_fields=[], trace=trace))
    assert res[0].items[0].key == "8"
    for key in ("filter_ms", "search_v_ms", "merge_ms", "shape_ms",
                "total_ms", "queue_ms"):
        assert trace[key] >= 0.0, key
    assert trace["doc_count"] == N
    names = [s[0] for s in trace["_phase_spans"]]
    assert "microbatch.queue" in names and "engine.search.v" in names


def test_filtered_and_raw_requests_bypass_batcher(engine_and_data):
    _eng, base = engine_and_data
    e2 = Engine(_flat_schema("f", [FieldSchema("tag", DataType.INT)]),
                device="cpu")
    e2.upsert([{"_id": str(i), "tag": i % 2, "v": base[i]}
               for i in range(200)])
    e2.build_index()
    res = e2.search(SearchRequest(
        vectors={"v": base[3]}, k=4, include_fields=["tag"],
        filters={"operator": "AND", "conditions": [
            {"field": "tag", "operator": "=", "value": 1}]}))
    assert all(r.fields["tag"] == 1 for r in res[0].items)
    e2.search(SearchRequest(vectors={"v": base[3]}, k=4, raw_results=True,
                            include_fields=[]))
    e2.search(SearchRequest(vectors={"v": base[3]}, k=4, brute_force=True))
    assert e2._microbatcher is None  # none of them started one
    e2.close()


def test_runtime_config_disables_batching(engine_and_data):
    eng, base = engine_and_data
    eng.apply_config({"micro_batch": False})
    try:
        eng.search(SearchRequest(vectors={"v": base[0]}, k=2,
                                 include_fields=[]))
        before = eng._microbatcher.dispatches if eng._microbatcher else 0
        eng.search(SearchRequest(vectors={"v": base[0]}, k=2,
                                 include_fields=[]))
        after = eng._microbatcher.dispatches if eng._microbatcher else 0
        assert before == after
    finally:
        eng.apply_config({"micro_batch": True})


def test_group_failure_isolated_to_bad_request(engine_and_data):
    eng, base = engine_and_data
    mb = BatchScheduler(eng, max_rows=64)
    try:
        good = _Pending(SearchRequest(vectors={"v": base[1]}, k=2,
                                      include_fields=[]), 1)
        bad = _Pending(SearchRequest(
            vectors={"v": np.zeros(D + 1, np.float32)}, k=2,
            include_fields=[]), 1)
        mb._run_bucket(_bucket_of([good, bad]))
        assert good.done.is_set() and bad.done.is_set()
        assert good.error is None
        assert good.results[0].items[0].key == "1"
        assert bad.error is not None
    finally:
        mb.stop()


def test_apply_config_cannot_reenable_batching_after_close():
    eng = Engine(_flat_schema("mc"), device="cpu")
    eng.upsert([{"_id": "0", "v": np.zeros(D, np.float32)}])
    eng.build_index()
    eng.search(SearchRequest(vectors={"v": np.zeros(D, np.float32)}, k=1,
                             include_fields=[]))
    mb = eng._microbatcher
    assert mb is not None
    eng.close()
    assert not mb._thread.is_alive()  # close joins the dispatcher
    eng.apply_config({"micro_batch": True})
    assert eng.micro_batch is False
    res = eng.search(SearchRequest(vectors={"v": np.zeros(D, np.float32)},
                                   k=1, include_fields=[]))
    assert res[0].items[0].key == "0"
    assert eng._microbatcher is None


def test_batch_delay_holds_partial_buckets(engine_and_data):
    eng, base = engine_and_data
    mb = BatchScheduler(eng, max_rows=64, max_delay_ms=30.0)
    try:
        before = mb.age_timeout_fires
        res = mb.submit(SearchRequest(vectors={"v": base[9]}, k=2,
                                      include_fields=[]))
        assert res[0].items[0].key == "9"
        assert mb.age_timeout_fires == before + 1
    finally:
        mb.stop()


def test_apply_config_knobs_reach_a_live_scheduler(engine_and_data):
    eng, base = engine_and_data
    eng.search(SearchRequest(vectors={"v": base[0]}, k=2,
                             include_fields=[]))
    mb = eng._microbatcher
    old = (eng.micro_batch_max_rows, eng.batch_delay_ms)
    try:
        got = eng.apply_config({"micro_batch_max_rows": 256,
                                "batch_delay_ms": 0.5,
                                "shape_buckets": False,
                                "refresh_interval_ms": 250})
        assert (mb.max_rows, mb.max_delay_ms) == (256, 0.5)
        assert got["refresh_interval_ms"] == 250
        assert not eng.shape_buckets
        res = eng.search(SearchRequest(vectors={"v": base[3]}, k=2,
                                       include_fields=[]))
        assert res[0].items[0].key == "3"
    finally:
        eng.apply_config({"micro_batch_max_rows": old[0],
                          "batch_delay_ms": old[1], "shape_buckets": True})


def test_scheduler_stress_with_writes_and_close(rng):
    """Concurrent searches, writes and a racing close: no hung caller, no
    error other than "engine closed"."""
    eng = Engine(_flat_schema("lk"), device="cpu")
    base = rng.standard_normal((600, D)).astype(np.float32)
    eng.upsert([{"_id": str(i), "v": base[i]} for i in range(400)])
    eng.build_index()
    errors: list[Exception] = []
    stop = threading.Event()

    def searcher(tid: int):
        i = tid
        while not stop.is_set():
            try:
                eng.search(SearchRequest(vectors={"v": base[i % 400]},
                                         k=(3, 10)[i % 2],
                                         include_fields=[]))
            except RuntimeError as e:
                if "closed" not in str(e):
                    errors.append(e)
                return
            except Exception as e:  # pragma: no cover
                errors.append(e)
                return
            i += 2

    def writer():
        for b in range(4):
            lo = 400 + b * 50
            eng.upsert([{"_id": str(i), "v": base[i]}
                        for i in range(lo, lo + 50)])

    threads = [threading.Thread(target=searcher, args=(t,), daemon=True,
                                name=f"sched-s{t}") for t in range(4)]
    threads.append(threading.Thread(target=writer, daemon=True,
                                    name="sched-w"))
    for t in threads:
        t.start()
    threading.Event().wait(0.5)
    stop.set()
    eng.close()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "hung caller"
    assert not errors, errors
    assert not any(t.name == "vearch-batch-scheduler" and t.is_alive()
                   and getattr(t, "_target", None) is not None
                   and getattr(t._target, "__self__", None) is not None
                   and t._target.__self__.engine is eng
                   for t in threading.enumerate())
