"""The framework integrations over the port's SDK, held against the
reference's on the CPU.

vearch_tpu_torch/sdk/integrations/ (the LangChain and LlamaIndex vector
stores) is the reference's sdk/integrations/ with one stated edit:
`ensure_space` catches the port's RpcError, which the port's client
raises (a 409 on an existing database or space). The scenarios of
tests/test_aux.py (the LangChain surface, the LlamaIndex surface, the
ref-doc delete) run once with the reference's adapters on a reference
StandaloneCluster and once with the port's adapters on the port's
(partition servers on device="cpu"); the two packages' ids, texts and
metadata must be equal. A second store opened on an existing space works
on the port, where the reference's adapter lets the port's 409 escape.
"""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ["__init__.py", "langchain_vearch_tpu.py", "llamaindex_vearch_tpu.py"]
# the one edit the port's copies carry (sdk/integrations/__init__.py)
STATED_EDITS = {"__init__.py": [(
    "    from vearch_tpu.cluster.rpc import RpcError\n",
    "    from vearch_tpu_torch.cluster.rpc import RpcError\n")]}
RTOL, ATOL = 1e-5, 1e-5
TEXTS = ["the quick brown fox", "jumps over", "the lazy dog",
         "a stitch in time", "saves nine"]


def _read(*parts) -> str:
    with open(os.path.join(REPO, *parts), encoding="utf-8") as f:
        return f.read()


def _reference_integrations():
    """sdk/integrations as test_aux.py loads it: a top-level
    `integrations` package from sdk/ on sys.path."""
    sdk_dir = os.path.join(REPO, "sdk")
    sys.path.insert(0, sdk_dir)
    try:
        import integrations
        from integrations import langchain_vearch_tpu, llamaindex_vearch_tpu
    finally:
        sys.path.remove(sdk_dir)
    return integrations, langchain_vearch_tpu, llamaindex_vearch_tpu


def _package(kind: str) -> dict:
    """One package's adapters, cluster and client."""
    if kind == "port":
        from vearch_tpu_torch.cluster.rpc import RpcError
        from vearch_tpu_torch.cluster.standalone import StandaloneCluster
        from vearch_tpu_torch.sdk import integrations
        from vearch_tpu_torch.sdk.client import VearchClient
        from vearch_tpu_torch.sdk.integrations import (langchain_vearch_tpu,
                                                       llamaindex_vearch_tpu)

        def cluster(path):
            return StandaloneCluster(data_dir=path, n_ps=1,
                                     ps_kwargs={"device": "cpu"})
    else:
        from vearch_tpu.cluster.rpc import RpcError
        from vearch_tpu.cluster.standalone import StandaloneCluster
        from vearch_tpu.sdk.client import VearchClient

        integrations, langchain_vearch_tpu, llamaindex_vearch_tpu = \
            _reference_integrations()

        def cluster(path):
            return StandaloneCluster(data_dir=path, n_ps=1)
    return {"integrations": integrations, "lc": langchain_vearch_tpu,
            "li": llamaindex_vearch_tpu, "cluster": cluster,
            "client": VearchClient, "rpc_error": RpcError}


def toy_embedding(texts):
    """test_aux.py's deterministic 8-dim bag-of-chars embedding."""
    out = []
    for t in texts:
        v = np.zeros(8, np.float32)
        for i, ch in enumerate(t.encode()):
            v[i % 8] += ch / 100.0
        out.append(v.tolist())
    return out


def _langchain(kind, path) -> dict:
    pkg = _package(kind)
    with pkg["cluster"](path) as c:
        store = pkg["lc"].VearchTpuVectorStore(
            pkg["client"](c.router_addr), "lcdb", "lcspace", toy_embedding)
        ids = store.add_texts(
            TEXTS, metadatas=[{"src": chr(97 + i)} for i in range(5)],
            ids=[f"t{i}" for i in range(5)])
        drawn = store.add_texts(["an unnamed text"])
        assert len(drawn) == 1 and len(drawn[0]) == 32  # uuid4 hex
        first = store.similarity_search("the quick brown fox", k=1)
        assert first[0].page_content == "the quick brown fox"
        assert first[0].metadata["src"] == "a"
        pairs = store.similarity_search_with_score("jumps over", k=3)
        assert pairs[0][0].page_content == "jumps over"
        assert pairs[0][1] == pytest.approx(0.0, abs=1e-6)
        assert store.delete([ids[0]])
        assert store.delete([]) is False
        after = store.similarity_search("the quick brown fox", k=3)
        assert all(d.page_content != "the quick brown fox" for d in after)
        with pytest.raises(ValueError, match="length mismatch"):
            store.add_texts(["x", "y"], ids=["only-one"])
        # the drawn id is random: it stands as "drawn" in the outcome
        named = {drawn[0]: "drawn"}
        return {"ids": ids,
                "first": [(d.page_content, d.metadata) for d in first],
                "pairs": [(d.page_content, d.metadata["_id"])
                          for d, _ in pairs],
                "scores": [s for _, s in pairs],
                "after": [(d.page_content, named.get(d.metadata["_id"],
                                                     d.metadata["_id"]))
                          for d in after]}


def _llamaindex(kind, path) -> dict:
    pkg = _package(kind)
    li = pkg["li"]
    embs = np.random.default_rng(2).standard_normal((6, 8)).astype(
        np.float32)
    with pkg["cluster"](path) as c:
        store = li.VearchTpuLlamaVectorStore(
            pkg["client"](c.router_addr), "lidb", "lispace", dimension=8)
        nodes = [li.TextNode(text=f"text {i}", id_=f"n{i}",
                             embedding=embs[i].tolist(), metadata={"i": i})
                 for i in range(6)]
        added = store.add(nodes)
        assert added == [f"n{i}" for i in range(6)]
        res = store.query(li.VectorStoreQuery(
            query_embedding=embs[1].tolist(), similarity_top_k=3))
        assert res.ids[0] == "n1"
        assert res.nodes[0].get_content() == "text 1"
        assert res.nodes[0].metadata == {"i": 1}
        store.delete_nodes(["n1"])
        after = store.query(li.VectorStoreQuery(
            query_embedding=embs[1].tolist(), similarity_top_k=6))
        assert "n1" not in after.ids and len(after.ids) == 5
        with pytest.raises(ValueError, match="no embedding"):
            store.add([li.TextNode(text="bare", id_="bare")])
        return {"added": added, "ids": res.ids,
                "scores": res.similarities,
                "texts": [n.get_content() for n in res.nodes],
                "metadata": [n.metadata for n in res.nodes],
                "after": after.ids,
                "after_texts": [n.get_content() for n in after.nodes]}


def _ref_doc_delete(kind, path) -> dict:
    pkg = _package(kind)
    li = pkg["li"]
    embs = np.random.default_rng(4).standard_normal((4, 8)).astype(
        np.float32)
    with pkg["cluster"](path) as c:
        store = li.VearchTpuLlamaVectorStore(
            pkg["client"](c.router_addr), "li2", "s", dimension=8)
        nodes = []
        for i in range(4):
            node = li.TextNode(text=f"t{i}", id_=f"n{i}",
                               embedding=embs[i].tolist())
            node.ref_doc_id = "docA" if i < 2 else "docB"
            nodes.append(node)
        store.add(nodes)
        store.delete("docA")  # document-level: removes n0 and n1
        res = store.query(li.VectorStoreQuery(
            query_embedding=embs[0].tolist(), similarity_top_k=4))
        assert set(res.ids) == {"n2", "n3"}, res.ids
        # unsupported metadata filters are loud, not silent
        q = li.VectorStoreQuery(query_embedding=embs[0].tolist(),
                                similarity_top_k=1)
        q.filters = {"anything": 1}
        with pytest.raises(ValueError, match="MetadataFilters"):
            store.query(q)
        return {"ids": res.ids, "texts": [n.get_content()
                                          for n in res.nodes]}


def _second_store(kind, path) -> dict:
    """A store opened on a space that already exists (create=True): the
    cluster answers 409 for the database and the space, ensure_space
    tolerates both, and the second store reads what the first wrote."""
    pkg = _package(kind)
    with pkg["cluster"](path) as c:
        client = pkg["client"](c.router_addr)
        first = pkg["lc"].VearchTpuVectorStore(client, "db", "s",
                                               toy_embedding)
        first.add_texts(TEXTS, ids=[f"t{i}" for i in range(5)])
        second = pkg["lc"].VearchTpuVectorStore(
            pkg["client"](c.router_addr), "db", "s", toy_embedding)
        got = second.similarity_search("a stitch in time", k=2)
        # a LlamaIndex store on the same space (its vector field is
        # named as the LangChain store's) reads the same texts
        li = pkg["li"].VearchTpuLlamaVectorStore(client, "db", "s",
                                                 dimension=8)
        res = li.query(pkg["li"].VectorStoreQuery(
            query_embedding=toy_embedding(["a stitch in time"])[0],
            similarity_top_k=2))
        assert res.ids == [d.metadata["_id"] for d in got]
        # a 409 is tolerated only as such: another code still surfaces
        with pytest.raises(pkg["rpc_error"]):
            pkg["integrations"].ensure_space(
                client, "db", "bad", [{"name": "v", "data_type": "vector",
                                       "dimension": 8,
                                       "index": {"index_type": "NOPE",
                                                 "metric_type": "L2"}}])
        return {"ids": [d.metadata["_id"] for d in got],
                "texts": [d.page_content for d in got]}


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    """Each (scenario, package) run once, on first use."""
    done: dict = {}

    def get(scenario, kind):
        if (scenario, kind) not in done:
            done[scenario, kind] = scenario(kind, str(
                tmp_path_factory.mktemp(f"{scenario.__name__}_{kind}")))
        return done[scenario, kind]

    return get


@pytest.mark.parametrize("kind", ["port", "reference"])
@pytest.mark.parametrize("scenario", [_langchain, _llamaindex,
                                      _ref_doc_delete, _second_store],
                         ids=["langchain", "llamaindex", "ref_doc_delete",
                              "second_store"])
def test_integration_equals_across_packages(scenario, kind, outcomes):
    got = dict(outcomes(scenario, kind))
    other = dict(outcomes(scenario,
                          "reference" if kind == "port" else "port"))
    # FLAT's L2 scores are exact f32 sums in both packages; only the
    # summation order may differ
    np.testing.assert_allclose(got.pop("scores", []),
                               other.pop("scores", []), rtol=RTOL, atol=ATOL)
    assert got == other


def test_reference_adapter_lets_the_ports_409_escape(tmp_path):
    """Why the port carries its own copy: the reference's ensure_space
    catches only the reference's RpcError, so over the port's client a
    space that already exists raises instead of being reopened."""
    ref, port = _package("reference"), _package("port")
    with port["cluster"](str(tmp_path / "c")) as c:
        client = port["client"](c.router_addr)
        fields = [{"name": "v", "data_type": "vector", "dimension": 8,
                   "index": {"index_type": "FLAT", "metric_type": "L2",
                             "params": {}}}]
        port["integrations"].ensure_space(client, "db", "s", fields)
        port["integrations"].ensure_space(client, "db", "s", fields)
        with pytest.raises(port["rpc_error"]) as err:
            ref["integrations"].ensure_space(client, "db", "s", fields)
        assert err.value.code == 409
        assert not isinstance(err.value, ref["rpc_error"])


@pytest.mark.parametrize("name", FILES)
def test_copy_equals_reference_but_for_the_stated_edit(name):
    """Each port file is the reference's, byte for byte, after its
    STATED_EDITS (the RpcError import only)."""
    ref = _read("sdk", "integrations", name)
    for old, new in STATED_EDITS.get(name, []):
        assert ref.count(old) == 1, old
        ref = ref.replace(old, new)
    port = _read("vearch_tpu_torch", "sdk", "integrations", name)
    assert port == ref
    assert "vearch_tpu." not in port.replace("vearch_tpu_torch.", "")
