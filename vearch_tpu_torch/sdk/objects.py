"""pyvearch-shaped object model over the flat client (reference:
sdk/python/vearch/core/vearch.py:33 Vearch / core/db.py Database /
core/space.py:30 Space — users migrating from the reference SDK keep
their call shapes: vc.database(name).space(name).search(...)).

Original thin veneer: every method delegates to
vearch_tpu_torch.sdk.client.VearchClient; no request/response shapes of its
own."""

from __future__ import annotations

from typing import Any

from vearch_tpu_torch.cluster.rpc import RpcError
from vearch_tpu_torch.sdk.client import VearchClient


class Vearch:
    """Entry point (reference: core/vearch.py Vearch(Config)). Accepts a
    router address string or anything with a `.host` attribute."""

    def __init__(self, config):
        addr = getattr(config, "host", config)
        self.client = VearchClient(str(addr))  # client normalizes URLs

    def database(self, database_name: str) -> "Database":
        return Database(database_name, self.client)

    def list_databases(self) -> list["Database"]:
        return [Database(d["name"], self.client)
                for d in self.client.list_databases()]

    def create_database(self, database_name: str) -> "Database":
        self.client.create_database(database_name)
        return Database(database_name, self.client)

    def is_database_exist(self, database_name: str) -> bool:
        return self.database(database_name).exist()

    def drop_database(self, database_name: str) -> None:
        self.client.drop_database(database_name)

    def space(self, database_name: str, space_name: str) -> "Space":
        return Space(database_name, space_name, self.client)

    def list_spaces(self, database_name: str) -> list["Space"]:
        return [Space(database_name, s["name"], self.client)
                for s in self.client.list_spaces(database_name)]

    def create_space(self, database_name: str, schema: dict) -> "Space":
        self.client.create_space(database_name, schema)
        return Space(database_name, schema["name"], self.client)

    def drop_space(self, database_name: str, space_name: str) -> None:
        self.client.drop_space(database_name, space_name)

    def is_live(self) -> bool:
        return self.client.is_live()


class Database:
    def __init__(self, name: str, client: VearchClient):
        self.name = name
        self.client = client

    def exist(self) -> bool:
        return any(d["name"] == self.name
                   for d in self.client.list_databases())

    def create(self) -> "Database":
        self.client.create_database(self.name)
        return self

    def drop(self) -> None:
        self.client.drop_database(self.name)

    def space(self, space_name: str) -> "Space":
        return Space(self.name, space_name, self.client)

    def list_spaces(self) -> list["Space"]:
        return [Space(self.name, s["name"], self.client)
                for s in self.client.list_spaces(self.name)]


class Space:
    def __init__(self, db_name: str, space_name: str,
                 client: VearchClient):
        self.db_name = db_name
        self.name = space_name
        self.client = client

    def create(self, schema: dict) -> "Space":
        self.client.create_space(self.db_name, {**schema,
                                                "name": self.name})
        return self

    def drop(self) -> None:
        self.client.drop_space(self.db_name, self.name)

    def exist(self) -> tuple[bool, dict | None]:
        try:
            return True, self.client.get_space(self.db_name, self.name)
        except RpcError as e:
            if e.code == 404:
                return False, None
            raise

    def describe(self, detail: bool = False) -> dict:
        return self.client.get_space(self.db_name, self.name,
                                     detail=detail)

    def create_index(self, field: str,
                     index_type: str = "INVERTED") -> dict:
        """Scalar field index (reference: Space.create_index)."""
        return self.client.add_field_index(self.db_name, self.name,
                                           field, index_type)

    def upsert(self, data: list[dict]) -> list[str]:
        out = self.client.upsert(self.db_name, self.name, data)
        return out["document_ids"]

    def search(self, vectors: list[dict], limit: int = 10,
               **kw) -> list[list[dict]]:
        return self.client.search(self.db_name, self.name, vectors,
                                  limit=limit, **kw)

    def query(self, document_ids: list[str] | None = None,
              filters: dict | None = None, **kw) -> list[dict]:
        return self.client.query(self.db_name, self.name,
                                 document_ids=document_ids,
                                 filters=filters, **kw)

    def delete(self, document_ids: list[str] | None = None,
               filters: dict | None = None, **kw) -> int:
        return self.client.delete(self.db_name, self.name,
                                  document_ids=document_ids,
                                  filters=filters, **kw)

    def flush(self) -> Any:
        return self.client.flush(self.db_name, self.name)
