"""Scalar-field result ordering.

Copy of vearch_tpu/engine/sort.py for the PyTorch port: the reference's
sort surface (reference:
internal/ps/engine/sortorder/parse.go ParseSort — the accepted request
forms; sort.go SortOrder.Compare — typed value comparison with missing
handling; consumed by the router merges client.go:779
SearchFieldSortExecute / :1062 QueryFieldSortExecute and validated in
doc_query.go:1329-1343).

Request forms accepted, matching the reference parser:

    "sort": "price"                          # field, desc (ref default)
    "sort": "_score"                         # score, desc
    "sort": "_id"                            # id, asc
    "sort": [{"price": "asc"}]               # field: order string
    "sort": [{"price": {"order": "desc",
                        "missing": "_last"}}]  # full spec

Normalized spec: {"field": str, "desc": bool, "missing_first": bool}.
Missing values (doc has no such field) sort LAST regardless of
direction unless "missing": "_first" (reference: SortFieldMissing).

The engine attaches per-hit sort values (list, spec order) so the
router's cross-partition merge compares values it never has to
re-derive; ties break on the hit's metric-oriented score and then _id
for a deterministic, partition-count-independent order.
"""

from __future__ import annotations

from functools import cmp_to_key
from typing import Any

SCORE_FIELD = "_score"
ID_FIELD = "_id"


def parse_sort(spec: Any) -> list[dict]:
    """Normalize a request `sort` value to a list of specs. Raises
    ValueError on malformed input (reference: parse.go errors
    'invalid sort')."""
    if spec is None:
        return []
    if isinstance(spec, (str, dict)):
        return [_parse_one(spec)]
    if isinstance(spec, (list, tuple)):
        return [_parse_one(s) for s in spec]
    raise ValueError(f"invalid sort type {type(spec).__name__}")


def _parse_one(s: Any) -> dict:
    if isinstance(s, str):
        if s == SCORE_FIELD:
            return {"field": SCORE_FIELD, "desc": True,
                    "missing_first": False}
        if s == ID_FIELD:
            return {"field": ID_FIELD, "desc": False,
                    "missing_first": False}
        # bare field name defaults to desc (reference: parseSort string
        # case -> SortField{Desc: true})
        return {"field": s, "desc": True, "missing_first": False}
    if isinstance(s, dict):
        if len(s) != 1:
            raise ValueError(
                f"sort spec must have exactly one field, got {sorted(s)}"
            )
        field, val = next(iter(s.items()))
        if isinstance(val, str):
            if val not in ("asc", "desc"):
                raise ValueError(f"invalid sort order {val!r}")
            return {"field": field, "desc": val == "desc",
                    "missing_first": False}
        if isinstance(val, dict):
            order = val.get("order", "asc")
            if order not in ("asc", "desc"):
                raise ValueError(f"invalid sort order {order!r}")
            missing = val.get("missing", "_last")
            if missing not in ("_first", "_last"):
                raise ValueError(f"invalid sort missing {missing!r}")
            return {"field": field, "desc": order == "desc",
                    "missing_first": missing == "_first"}
        raise ValueError(f"invalid sort spec for field {field!r}")
    raise ValueError(f"invalid sort element {s!r}")


def compare_values(a: Any, b: Any, desc: bool, missing_first: bool) -> int:
    """Three-way compare of one sort value pair. None = missing."""
    if a is None or b is None:
        if a is None and b is None:
            return 0
        # missing placement is absolute (first/last), not affected by
        # direction (reference: SortFieldMissingFirst/Last semantics)
        if a is None:
            return -1 if missing_first else 1
        return 1 if missing_first else -1
    # bools compare as ints; numerics cross-compare; strings with
    # strings — field types are schema-enforced so mixed types only
    # appear via schema evolution, where stringification is the
    # deterministic fallback
    try:
        if a < b:
            c = -1
        elif a > b:
            c = 1
        else:
            c = 0
    except TypeError:
        sa, sb = str(a), str(b)
        c = -1 if sa < sb else (1 if sa > sb else 0)
    return -c if desc else c


def compare_rows(specs: list[dict], va: list, vb: list) -> int:
    """Compare two hits' sort-value lists under the spec list."""
    for spec, a, b in zip(specs, va, vb):
        c = compare_values(a, b, spec["desc"], spec["missing_first"])
        if c:
            return c
    return 0


def row_sort_key(specs: list[dict], get_values, tie_key=None):
    """functools key for sorting hit objects: `get_values(hit)` returns
    the sort-value list; `tie_key(hit)` (optional) yields a final
    deterministic tiebreak tuple."""

    def cmp(ha, hb) -> int:
        c = compare_rows(specs, get_values(ha), get_values(hb))
        if c or tie_key is None:
            return c
        ta, tb = tie_key(ha), tie_key(hb)
        return -1 if ta < tb else (1 if ta > tb else 0)

    return cmp_to_key(cmp)


def validate_sort(specs: list[dict], schema_fields: dict,
                  allow_score: bool = True) -> None:
    """Reject sorts on unknown or vector fields (reference:
    doc_query.go:1331 'sort field [%s] not space field'). `schema_fields`
    maps field name -> data_type string."""
    for spec in specs:
        f = spec["field"]
        if f == ID_FIELD:
            continue
        if f == SCORE_FIELD:
            if allow_score:
                continue
            raise ValueError("_score sort is not valid for query "
                             "(no vector score)")
        dt = schema_fields.get(f)
        if dt is None:
            raise ValueError(f"sort field [{f}] not space field")
        if str(dt).lower() == "vector":
            raise ValueError(f"sort field [{f}] is a vector field")
