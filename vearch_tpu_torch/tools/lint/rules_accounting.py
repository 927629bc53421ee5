"""Tenant attribution discipline.

VL104 — serving-path billable counter mutations must carry space
attribution. The per-tenant cost layer (docs/ACCOUNTING.md) only adds
up to the truth if every serving-path failure counter — kills, sheds —
names the space it happened to. A `.inc()` on one of the billable
counters (`tools/lint/config.py: VL104_BILLABLE_COUNTERS`) inside the
serving files (`VL104_SERVING_FILES`) that passes no space-shaped
argument silently un-attributes a whole failure class: the cluster
rollup still balances, but the tenant who ate the 429s disappears from
`/cluster/usage` and their SLO burn never moves.

An increment counts as attributed when any argument expression
references the space — an identifier, attribute, or string literal
whose name contains ``space`` (``space_lbl``, ``self._space_key(pid)``,
``accounting.SYSTEM_SPACE`` all qualify). Genuinely tenant-free
increments (zero-fill label registration, process-level events) carry
an inline ``allow[space-attr]`` with the reason.
"""

from __future__ import annotations

import ast

from vearch_tpu_torch.tools.lint import config
from vearch_tpu_torch.tools.lint.core import FileContext, Finding, Rule, register


def _norm(path: str) -> str:
    return path.replace("\\", "/")


def _mentions_space(node: ast.AST) -> bool:
    """True if any sub-expression names the space: an identifier,
    attribute, or string literal containing `space` (case-blind)."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and "space" in sub.id.lower():
            return True
        if isinstance(sub, ast.Attribute) and "space" in sub.attr.lower():
            return True
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str) \
                and "space" in sub.value.lower():
            return True
    return False


def _counter_name(func: ast.AST) -> str | None:
    """For a `<target>.inc` callee, the attribute/name the counter
    lives under (`self._shed_total.inc` -> `_shed_total`)."""
    if not (isinstance(func, ast.Attribute) and func.attr == "inc"):
        return None
    target = func.value
    if isinstance(target, ast.Attribute):
        return target.attr
    if isinstance(target, ast.Name):
        return target.id
    return None


def _check_space_attr(ctx: FileContext):
    path = _norm(ctx.path)
    if not path.endswith(tuple(config.VL104_SERVING_FILES)):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _counter_name(node.func)
        if name is None or name not in config.VL104_BILLABLE_COUNTERS:
            continue
        exprs: list[ast.AST] = list(node.args)
        exprs.extend(kw.value for kw in node.keywords)
        if any(_mentions_space(e) for e in exprs):
            continue
        ok, reason = ctx.allowed(node.lineno, "space-attr")
        yield Finding(
            "VL104", "space-attr", ctx.path, node.lineno,
            f"`{name}.inc(...)` on the serving path passes no space "
            "attribution — billable counters must name the tenant or "
            "the cost layer (docs/ACCOUNTING.md) loses this failure "
            "class",
            suppressed=ok, reason=reason,
        )


register(Rule(
    id="VL104", tag="space-attr",
    doc="serving-path billable counters must carry space attribution",
    check_file=_check_space_attr,
))
