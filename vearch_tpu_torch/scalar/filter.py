"""Scalar filter AST + evaluation.

Copy of vearch_tpu/scalar/filter.py for the PyTorch port. The filter
surface is the reference's (internal/router/document/doc_query.go:85
parseFilter — JSON `{"operator": "AND"|"OR", "conditions": [{"field",
"operator", "value"}]}` with range ops < <= > >= = != <> and term ops
IN / NOT IN). Conditions compile to a host boolean mask over the docid
space (vectorised numpy on columnar fields), which the engine ANDs with
the deletion bitmap and applies inside the scan.

Scalar indexes (and so composite-index planning) are not ported yet:
every condition evaluates against the table's columns, which is what the
reference does for a schema without scalar indexes.
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


def evaluate_condition(cond: Condition, table, n: int) -> np.ndarray:
    """[n] bool mask for one condition over the table's columns."""
    try:
        col = table.column(cond.field)[:n]
        return _eval_fixed(col, cond)
    except KeyError:
        rows = table.string_column(cond.field)
        return _eval_strings(rows, cond, n)


def evaluate_filter(flt, table, n: int) -> np.ndarray:
    """Evaluate a Filter (or its dict form) to an [n] bool mask."""
    if isinstance(flt, dict):
        flt = Filter.from_dict(flt)
    if not flt.conditions:
        return np.ones(n, dtype=bool)
    masks = [evaluate_condition(c, table, n) for c in flt.conditions]
    out = masks[0].copy()
    for m in masks[1:]:
        if flt.operator == "AND":
            out &= m
        else:
            out |= m
    return out
