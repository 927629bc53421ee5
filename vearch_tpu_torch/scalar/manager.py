"""Scalar index manager: routes filter conditions to per-field indexes.

Copy of vearch_tpu/scalar/manager.py for the PyTorch port; a re-design
of the reference's ScalarIndexManager (reference:
table/scalar_index_manager.h:27-43 — plans filter execution across
inverted/bitmap/composite indexes). Here the plan is simpler because
every index yields a docid *mask* and combination is vectorised AND/OR;
fields without an index fall back to a columnar numpy scan in
scalar/filter.py.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from vearch_tpu_torch.engine.types import DataType, ScalarIndexType, TableSchema
from vearch_tpu_torch.scalar.filter import Condition
from vearch_tpu_torch.scalar.indexes import BitmapScalarIndex, InvertedScalarIndex

_NUMERIC = {
    DataType.INT: np.int64,
    DataType.LONG: np.int64,
    DataType.FLOAT: np.float64,
    DataType.DOUBLE: np.float64,
    DataType.DATE: np.int64,
}


class ScalarIndexManager:
    def __init__(self, schema: TableSchema,
                 composite: list[list[str]] | None = None):
        self.schema = schema
        self._indexes: dict[str, Any] = {}
        for f in schema.scalar_fields():
            if f.scalar_index is ScalarIndexType.INVERTED:
                dtype = _NUMERIC.get(f.data_type)
                self._indexes[f.name] = InvertedScalarIndex(
                    np.dtype(dtype) if dtype else np.dtype(object)
                )
            elif f.scalar_index is ScalarIndexType.BITMAP:
                self._indexes[f.name] = BitmapScalarIndex()
        from vearch_tpu_torch.scalar.indexes import CompositeScalarIndex

        self._composites: list[CompositeScalarIndex] = [
            CompositeScalarIndex(fields)
            for fields in (composite or getattr(schema, "composite_indexes",
                                                None) or [])
        ]

    def has_index(self, field: str) -> bool:
        return field in self._indexes

    def query_if_indexed(self, cond: Condition, n: int):
        """Mask from the field's index, or None when the field has no
        index — tolerant of a concurrent remove_field between the
        caller's has_index check and the lookup (online index drop,
        reference: RemoveFieldIndex gamma_api.h:181)."""
        index = self._indexes.get(cond.field)
        return None if index is None else index.query(cond, n)

    def add_field(self, name: str, index) -> None:
        """Publish a (fully built) per-field index atomically."""
        self._indexes[name] = index

    def remove_field(self, name: str) -> None:
        self._indexes.pop(name, None)

    def composites(self) -> list:
        """Declared composite indexes, for the filter planner
        (reference: scalar_index_manager.h FilterIndexPair)."""
        return list(self._composites)

    def composite_for(self, fields: set[str]):
        """A composite index whose member set equals `fields`, if any."""
        for ci in self._composites:
            if set(ci.fields) == fields:
                return ci
        return None

    def add_docs(self, docs: list[dict[str, Any]], base_docid: int) -> None:
        for name, index in self._indexes.items():
            for i, doc in enumerate(docs):
                # None == unset (matches the engine's partial-update and
                # presence conventions); a None in a numeric inverted
                # index would TypeError later inside a filtered search
                if doc.get(name) is not None:
                    index.add(doc[name], base_docid + i)
        for ci in self._composites:
            for i, doc in enumerate(docs):
                # None members are unorderable in the sorted composite
                # rows — skip them, like the reference skips docs
                # missing composite member columns
                if all(doc.get(f) is not None for f in ci.fields):
                    ci.add(tuple(doc[f] for f in ci.fields), base_docid + i)

    def query(self, cond: Condition, n: int) -> np.ndarray:
        return self._indexes[cond.field].query(cond, n)

    def rebuild_from_table(self, table) -> None:
        """Re-derive indexes from the table after Engine.load (indexes are
        rebuildable state; the table is durable — reference: index
        rebuildable, raw data durable)."""
        def column_rows(name):
            try:
                return list(table.column(name))
            except KeyError:
                return table.string_column(name)

        for name, index in self._indexes.items():
            for docid, value in enumerate(column_rows(name)):
                # presence-gated: fixed columns materialize 0-defaults
                # for never-set fields; indexing those would make docs
                # match filters on values they never had
                if value is not None and name in table.set_fields_of(docid):
                    index.add(value, docid)
        for ci in self._composites:
            cols = {f: column_rows(f) for f in ci.fields}
            count = min(len(v) for v in cols.values()) if cols else 0
            for docid in range(count):
                values = tuple(cols[f][docid] for f in ci.fields)
                if all(v is not None for v in values):  # match add_docs
                    ci.add(values, docid)
