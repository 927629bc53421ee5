"""Scalar filter AST + evaluation.

Copy of vearch_tpu/scalar/filter.py for the PyTorch port. The filter
surface is the reference's (internal/router/document/doc_query.go:85
parseFilter — JSON `{"operator": "AND"|"OR", "conditions": [{"field",
"operator", "value"}]}` with range ops < <= > >= = != <> and term ops
IN / NOT IN). Conditions compile to a host boolean mask over the docid
space, which the engine ANDs with the deletion bitmap and applies inside
the scan: a lookup in the field's scalar index (scalar/manager.py) where
one exists, else a vectorised numpy scan of the table's column, and one
composite-index lookup for an AND filter that covers a composite's
prefix (the reference's scalar_index_manager.h planning).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

RANGE_OPS = {"<", "<=", ">", ">=", "=", "!=", "<>"}
TERM_OPS = {"IN", "NOT IN"}


@dataclass
class Condition:
    field: str
    operator: str  # one of RANGE_OPS | TERM_OPS
    value: Any

    def __post_init__(self):
        if self.operator not in RANGE_OPS | TERM_OPS:
            raise ValueError(f"unsupported filter operator: {self.operator}")


@dataclass
class Filter:
    operator: str = "AND"  # AND | OR over conditions
    conditions: list[Condition] = field(default_factory=list)

    def __post_init__(self):
        if self.operator not in ("AND", "OR"):
            raise ValueError(f"unsupported filter combinator: {self.operator}")

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Filter":
        return cls(
            operator=d.get("operator", "AND"),
            conditions=[
                Condition(c["field"], c["operator"], c.get("value"))
                for c in d.get("conditions", [])
            ],
        )


def _eval_fixed(col: np.ndarray, cond: Condition) -> np.ndarray:
    op, v = cond.operator, cond.value
    if op == "<":
        return col < v
    if op == "<=":
        return col <= v
    if op == ">":
        return col > v
    if op == ">=":
        return col >= v
    if op == "=":
        return col == v
    if op in ("!=", "<>"):
        return col != v
    values = v if isinstance(v, (list, tuple)) else [v]
    mask = np.isin(col, np.asarray(values, dtype=col.dtype))
    return ~mask if op == "NOT IN" else mask


def _eval_strings(rows: list[Any], cond: Condition, n: int) -> np.ndarray:
    op, v = cond.operator, cond.value
    values = set(v) if isinstance(v, (list, tuple)) else {v}
    out = np.zeros(n, dtype=bool)
    for i in range(n):
        cell = rows[i]
        if isinstance(cell, (list, tuple)):  # string arrays: any-match
            hit = bool(values & set(cell))
        else:
            hit = cell in values
        out[i] = hit
    if op == "NOT IN":
        out = ~out
    elif op in ("!=", "<>"):
        out = ~out
    elif op not in ("IN", "="):
        raise ValueError(f"operator {op} unsupported on string field {cond.field}")
    return out


def evaluate_condition(cond: Condition, engine, n: int) -> np.ndarray:
    """[n] bool mask for one condition; prefers a scalar index."""
    mgr = engine._scalar_manager
    if mgr is not None:
        mask = mgr.query_if_indexed(cond, n)
        if mask is not None:
            return mask
    engine.schema.field(cond.field)  # unknown fields raise KeyError
    table = engine.table
    try:
        col = table.column(cond.field)[:n]
        return _eval_fixed(col, cond)
    except KeyError:
        rows = table.string_column(cond.field)
        return _eval_strings(rows, cond, n)


def evaluate_filter(flt, engine, n: int) -> np.ndarray:
    """Evaluate a Filter (or its dict form) to an [n] bool mask.

    Planning: an AND filter whose equality conditions cover a prefix of
    a declared composite index (plus at most one range condition on the
    member after the prefix) resolves those in one composite lookup;
    all other conditions evaluate per field and combine.
    """
    if isinstance(flt, dict):
        flt = Filter.from_dict(flt)
    if not flt.conditions:
        return np.ones(n, dtype=bool)

    conditions = list(flt.conditions)
    masks: list[np.ndarray] = []
    mgr = engine._scalar_manager
    if flt.operator == "AND" and mgr is not None:
        # the best composite serves the longest '=' prefix of its member
        # fields plus at most one range condition on the field right
        # after the prefix; leftover conditions evaluate per field
        eq_by_field = {c.field: c for c in conditions if c.operator == "="}
        range_by_field: dict[str, Condition] = {}
        for c in conditions:
            if c.operator in ("<", "<=", ">", ">="):
                range_by_field.setdefault(c.field, c)
        best = None  # (covered_count, ci, prefix_fields, range_cond)
        for ci in mgr.composites():
            prefix = []
            for f in ci.fields:
                if f in eq_by_field:
                    prefix.append(f)
                else:
                    break
            rc = None
            if len(prefix) < len(ci.fields):
                rc = range_by_field.get(ci.fields[len(prefix)])
            covered = len(prefix) + (1 if rc is not None else 0)
            if covered and (best is None or covered > best[0]):
                best = (covered, ci, prefix, rc)
        if best is not None:
            _, ci, prefix, rc = best
            masks.append(ci.query_prefix(
                tuple(eq_by_field[f].value for f in prefix), rc, n
            ))
            consumed_ids = {id(eq_by_field[f]) for f in prefix}
            if rc is not None:
                consumed_ids.add(id(rc))
            conditions = [c for c in conditions
                          if id(c) not in consumed_ids]

    masks.extend(evaluate_condition(c, engine, n) for c in conditions)
    out = masks[0].copy()
    for m in masks[1:]:
        if flt.operator == "AND":
            out &= m
        else:
            out |= m
    return out
