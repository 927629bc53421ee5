"""LlamaIndex vector-store integration for vearch-tpu.

Mirrors the reference's LlamaIndex integration surface (reference:
sdk/integrations/llama-index — add / delete / query over the Python
SDK). `llama_index` is not a hard dependency: when importable, the
store returns real `VectorStoreQueryResult` objects; otherwise small
duck-typed stand-ins with the same attributes, so the adapter is
usable and testable without LlamaIndex installed.

The store expects "nodes" with `node_id`, `get_content()` and
`embedding` (the LlamaIndex BaseNode protocol) and answers
`VectorStoreQuery`-shaped queries (`query_embedding`,
`similarity_top_k`).
"""

from __future__ import annotations

import json
from typing import Any, Sequence

try:  # pragma: no cover - only with llama_index installed
    from llama_index.core.schema import TextNode  # type: ignore
    from llama_index.core.vector_stores.types import (  # type: ignore
        VectorStoreQuery,
        VectorStoreQueryResult,
    )

    _HAVE_LLAMA = True
except Exception:
    _HAVE_LLAMA = False

    class TextNode:  # type: ignore[no-redef]
        def __init__(self, text: str = "", id_: str = "",
                     embedding: list[float] | None = None,
                     metadata: dict | None = None):
            self.text = text
            self.node_id = id_
            self.embedding = embedding
            self.metadata = metadata or {}

        def get_content(self, **kwargs: Any) -> str:
            return self.text

    class VectorStoreQuery:  # type: ignore[no-redef]
        def __init__(self, query_embedding=None, similarity_top_k: int = 2):
            self.query_embedding = query_embedding
            self.similarity_top_k = similarity_top_k

    class VectorStoreQueryResult:  # type: ignore[no-redef]
        def __init__(self, nodes=None, similarities=None, ids=None):
            self.nodes = nodes
            self.similarities = similarities
            self.ids = ids


class VearchTpuLlamaVectorStore:
    """LlamaIndex-protocol vector store over a vearch-tpu cluster."""

    stores_text = True

    def __init__(
        self,
        client,
        db_name: str,
        space_name: str,
        dimension: int,
        index_type: str = "FLAT",
        metric_type: str = "L2",
        index_params: dict | None = None,
        create: bool = True,
    ):
        self.client = client
        self.db_name = db_name
        self.space_name = space_name
        if create:
            from . import ensure_space

            ensure_space(client, db_name, space_name, [
                {"name": "text", "data_type": "string"},
                {"name": "metadata", "data_type": "string"},
                # source-document id so delete(ref_doc_id) can purge
                # every node of a document (the LlamaIndex contract)
                {"name": "ref_doc_id", "data_type": "string"},
                {"name": "vector", "data_type": "vector",
                 "dimension": dimension,
                 "index": {"index_type": index_type,
                           "metric_type": metric_type,
                           "params": index_params or {}}},
            ])

    def add(self, nodes: Sequence, **kwargs: Any) -> list[str]:
        docs = []
        for node in nodes:
            if node.embedding is None:
                raise ValueError(
                    f"node {node.node_id!r} has no embedding; run an "
                    f"embedding model before add()"
                )
            docs.append({
                "_id": node.node_id,
                "text": node.get_content(),
                "metadata": json.dumps(getattr(node, "metadata", {}) or {}),
                "ref_doc_id": str(getattr(node, "ref_doc_id", None)
                                  or node.node_id),
                "vector": list(map(float, node.embedding)),
            })
        self.client.upsert(self.db_name, self.space_name, docs)
        return [d["_id"] for d in docs]

    def delete_nodes(self, node_ids: list[str] | None = None,
                     **kwargs: Any) -> None:
        if node_ids:
            self.client.delete(self.db_name, self.space_name,
                               document_ids=node_ids)

    def delete(self, ref_doc_id: str, **kwargs: Any) -> None:
        """Remove every node derived from one source document (the
        LlamaIndex document-level deletion contract) via the stored
        ref_doc_id column."""
        self.client.delete(self.db_name, self.space_name, filters={
            "operator": "AND",
            "conditions": [{"field": "ref_doc_id", "operator": "=",
                            "value": str(ref_doc_id)}],
        })

    def query(self, query, **kwargs: Any):
        if query.query_embedding is None:
            raise ValueError("query has no query_embedding")
        if getattr(query, "filters", None):
            # metadata rides as an opaque JSON string here; silently
            # ignoring MetadataFilters would return excluded documents
            raise ValueError(
                "MetadataFilters are not supported by this store yet; "
                "filter on scalar fields via the vearch-tpu SDK instead"
            )
        hits = self.client.search(
            self.db_name, self.space_name,
            [{"field": "vector",
              "feature": list(map(float, query.query_embedding))}],
            limit=int(query.similarity_top_k),
        )
        nodes, sims, ids = [], [], []
        for h in hits[0]:
            meta = {}
            try:
                meta = json.loads(h.get("metadata") or "{}")
            except Exception:
                pass
            nodes.append(TextNode(text=h.get("text", ""), id_=h["_id"],
                                  metadata=meta))
            sims.append(float(h["_score"]))
            ids.append(h["_id"])
        return VectorStoreQueryResult(nodes=nodes, similarities=sims,
                                      ids=ids)
