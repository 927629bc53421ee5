"""LangChain vector-store integration for vearch-tpu.

Mirrors the reference's LangChain integration surface (reference:
sdk/integrations/langchain — add_texts / similarity_search /
similarity_search_with_score / delete / from_texts over the Python
SDK). `langchain` is not a hard dependency: when `langchain_core` is
importable the class registers as a real `VectorStore` subclass and
returns its `Document` type; otherwise it works standalone with a
lightweight Document stand-in, so the adapter is testable (and usable)
without LangChain installed.
"""

from __future__ import annotations

import uuid
from typing import Any, Callable, Iterable, Sequence

try:  # pragma: no cover - exercised only when langchain is installed
    from langchain_core.documents import Document  # type: ignore
    from langchain_core.vectorstores import VectorStore  # type: ignore

    _HAVE_LANGCHAIN = True
except Exception:  # langchain absent: duck-typed stand-ins
    _HAVE_LANGCHAIN = False

    class Document:  # type: ignore[no-redef]
        def __init__(self, page_content: str, metadata: dict | None = None):
            self.page_content = page_content
            self.metadata = metadata or {}

        def __repr__(self) -> str:
            return f"Document({self.page_content!r})"

    class VectorStore:  # type: ignore[no-redef]
        pass


class VearchTpuVectorStore(VectorStore):
    """Store texts + embeddings in a vearch-tpu space.

    embedding: either an object with `embed_documents(texts)` /
    `embed_query(text)` (the LangChain Embeddings protocol) or a plain
    callable `texts -> [[float]]`.
    """

    def __init__(
        self,
        client,
        db_name: str,
        space_name: str,
        embedding,
        dimension: int | None = None,
        text_field: str = "text",
        vector_field: str = "vector",
        index_type: str = "FLAT",
        metric_type: str = "L2",
        index_params: dict | None = None,
        create: bool = True,
    ):
        self.client = client
        self.db_name = db_name
        self.space_name = space_name
        self.embedding = embedding
        self.text_field = text_field
        self.vector_field = vector_field
        if create:
            from . import ensure_space

            if dimension is None:
                dimension = len(self._embed_query("dimension probe"))
            ensure_space(client, db_name, space_name, [
                {"name": text_field, "data_type": "string"},
                {"name": "metadata", "data_type": "string"},
                {"name": vector_field, "data_type": "vector",
                 "dimension": dimension,
                 "index": {"index_type": index_type,
                           "metric_type": metric_type,
                           "params": index_params or {}}},
            ])

    # -- embedding dispatch --------------------------------------------------

    def _embed_documents(self, texts: list[str]) -> list[list[float]]:
        if hasattr(self.embedding, "embed_documents"):
            return self.embedding.embed_documents(texts)
        return [list(map(float, v)) for v in self.embedding(texts)]

    def _embed_query(self, text: str) -> list[float]:
        if hasattr(self.embedding, "embed_query"):
            return self.embedding.embed_query(text)
        return list(map(float, self.embedding([text])[0]))

    # -- VectorStore surface -------------------------------------------------

    def add_texts(
        self,
        texts: Iterable[str],
        metadatas: list[dict] | None = None,
        ids: list[str] | None = None,
        **kwargs: Any,
    ) -> list[str]:
        import json

        texts = list(texts)
        ids = ids or [uuid.uuid4().hex for _ in texts]
        metadatas = metadatas or [{} for _ in texts]
        if len(ids) != len(texts) or len(metadatas) != len(texts):
            # validate BEFORE embedding: the embed call may be a paid API
            raise ValueError(
                f"length mismatch: {len(texts)} texts, {len(ids)} ids, "
                f"{len(metadatas)} metadatas"
            )
        vectors = self._embed_documents(texts)
        docs = [
            {"_id": i, self.text_field: t, "metadata": json.dumps(m),
             self.vector_field: v}
            for i, t, m, v in zip(ids, texts, metadatas, vectors)
        ]
        self.client.upsert(self.db_name, self.space_name, docs)
        return ids

    def similarity_search_with_score(
        self, query: str, k: int = 4, filter: dict | None = None,
        **kwargs: Any
    ) -> list[tuple[Document, float]]:
        import json

        vec = self._embed_query(query)
        hits = self.client.search(
            self.db_name, self.space_name,
            [{"field": self.vector_field, "feature": vec}], limit=k,
            filters=filter,
        )
        out: list[tuple[Document, float]] = []
        for h in hits[0]:
            meta = {}
            try:
                meta = json.loads(h.get("metadata") or "{}")
            except Exception:
                pass
            meta["_id"] = h["_id"]
            out.append((
                Document(page_content=h.get(self.text_field, ""),
                         metadata=meta),
                float(h["_score"]),
            ))
        return out

    def similarity_search(
        self, query: str, k: int = 4, **kwargs: Any
    ) -> list[Document]:
        return [
            d for d, _ in self.similarity_search_with_score(query, k,
                                                            **kwargs)
        ]

    def delete(self, ids: list[str] | None = None, **kwargs: Any
               ) -> bool | None:
        if not ids:
            return False
        self.client.delete(self.db_name, self.space_name, document_ids=ids)
        return True

    @classmethod
    def from_texts(
        cls,
        texts: list[str],
        embedding,
        metadatas: list[dict] | None = None,
        *,
        client=None,
        db_name: str = "langchain",
        space_name: str = "langchain",
        **kwargs: Any,
    ) -> "VearchTpuVectorStore":
        if client is None:  # not assert: must survive python -O
            raise ValueError("pass client=VearchClient(router_addr)")
        store = cls(client, db_name, space_name, embedding, **kwargs)
        store.add_texts(texts, metadatas)
        return store
